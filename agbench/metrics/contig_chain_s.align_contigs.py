"""A contig align's greedy chain, ContigAligner.layer_s["chain"]."""

from agbench import readers


def read(run):
    return readers.stat_mean(run, "layer_s", "chain")

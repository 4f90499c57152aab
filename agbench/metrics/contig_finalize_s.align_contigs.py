"""A contig align's finalize, ContigAligner.finalize_s."""

from agbench import readers


def read(run):
    return readers.stat_mean(run, "finalize_s")

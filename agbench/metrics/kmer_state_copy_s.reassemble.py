"""The k-mer state's trip to the card and back in a traced sample: the
device seconds (CUDA events) of the k-mer build's spans graph.kmer.h2d
and graph.kmer.d2h, summed a sample."""

from agbench import program_spans


def read(run):
    return program_spans.mean_per_root(
        run, "pipeline", ("graph.kmer.h2d", "graph.kmer.d2h"), "device_s")

"""Stage (5)'s read align in a traced call: the host seconds of the span
misassembly.reads (the read aligner built on the draft axis's index and
every pair aligned, the C13 filter off), a call."""

from agbench import program_spans


def read(run):
    return program_spans.mean_per_root(run, "misassembly",
                                       ("misassembly.reads",))

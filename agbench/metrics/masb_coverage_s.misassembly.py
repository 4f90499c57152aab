"""Stage (5)'s coverage in a traced call: the host seconds of the span
misassembly.coverage (the first record of each pair, both mates' spans
de-chunked and summed on the device, the coverage brought down), a
call."""

from agbench import program_spans


def read(run):
    return program_spans.mean_per_root(run, "misassembly",
                                       ("misassembly.coverage",))

"""The read thread's waits in a traced sample: the host seconds of the
read aligner's spans align.reads.wait (the host blocked on a batch's
copy down), summed a sample."""

from agbench import program_spans


def read(run):
    return program_spans.mean_per_root(run, "pipeline",
                                       ("align.reads.wait",))

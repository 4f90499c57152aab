"""The graph's creation in a traced sample: the host seconds of each
part's span pipeline.graph.create (GraphTensors.create), summed a
sample."""

from agbench import program_spans


def read(run):
    return program_spans.mean_per_root(run, "pipeline",
                                       ("pipeline.graph.create",))

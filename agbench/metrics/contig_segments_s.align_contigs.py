"""The contig aligner's segments in a traced call: the host seconds of
the span align.contigs.segments (query_segments' loop over both
orientations, the concatenation and the upload), a call."""

from agbench import program_spans


def read(run):
    return program_spans.mean_per_root(run, "align.contigs",
                                       ("align.contigs.segments",))

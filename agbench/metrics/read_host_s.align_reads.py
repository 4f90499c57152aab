"""The read aligner's host copy out and concatenation
(ReadAligner.split's copy_out_s + concat_s) per million input pairs."""

from agbench import readers


def read(run):
    host = readers.stat_mean(run, "host_s")
    pairs = readers.stat_mean(run, "pairs")
    return host / pairs * 1e6 if host is not None and pairs else None

"""Seconds of the window's reassemblies per sample."""

from agbench import readers


def read(run):
    return readers.per_step(run, "samples")

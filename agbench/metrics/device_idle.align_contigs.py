"""The device's idle share over the traced contig aligns."""

from agbench import readers


def read(run):
    return readers.idle(run)

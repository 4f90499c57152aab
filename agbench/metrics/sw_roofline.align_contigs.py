"""The banded SW's share of its roofline in the traced contig aligns."""

from agbench import readers


def read(run):
    return readers.sw_roofline(run)

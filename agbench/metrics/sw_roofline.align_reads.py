"""The banded SW's share of its roofline in the traced read align."""

from agbench import readers


def read(run):
    return readers.sw_roofline(run)

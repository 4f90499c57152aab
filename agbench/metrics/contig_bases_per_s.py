"""Draft bases of the window's contig aligns per second of them."""

from agbench import readers


def read(run):
    return readers.rate(run, "bases")

"""Input pairs of the window's read aligns per second of them."""

from agbench import readers


def read(run):
    return readers.rate(run, "pairs")

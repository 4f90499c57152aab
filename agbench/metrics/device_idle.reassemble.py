"""The device's idle share over the traced sample."""

from agbench import readers


def read(run):
    return readers.idle(run)

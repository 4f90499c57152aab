"""The device's idle share over the traced read align."""

from agbench import readers


def read(run):
    return readers.idle(run)

"""The device's idle share over the traced misassembly removal."""

from agbench import readers


def read(run):
    return readers.idle(run)

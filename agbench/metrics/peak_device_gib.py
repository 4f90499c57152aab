"""Peak allocated device memory over the window, GiB."""

from agbench import readers


def read(run):
    return readers.peak_gib(run)

"""A sample's traversal, stage_seconds["traverse"]."""

from agbench import readers


def read(run):
    return readers.stat_mean(run, "stage_seconds", "traverse")

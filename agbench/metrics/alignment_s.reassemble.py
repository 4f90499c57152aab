"""A sample's alignment stage, stage_seconds["alignment"]."""

from agbench import readers


def read(run):
    return readers.stat_mean(run, "stage_seconds", "alignment")

"""A sample's k-mer layer build, stage_seconds["kmer_build"]."""

from agbench import readers


def read(run):
    return readers.stat_mean(run, "stage_seconds", "kmer_build")

"""Seconds from the process start to the window's start."""


def read(run):
    return getattr(run, "setup_s", None)

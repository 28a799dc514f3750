"""Seconds from the process's start until the window opens."""


def read(run):
    return run.setup_s

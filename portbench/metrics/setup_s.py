"""Seconds from process start until the measured window opens."""


def read(run):
    return run["setup_s"]

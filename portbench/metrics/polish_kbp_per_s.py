"""Draft bases of all jobs in the window over its whole time, kbp/s."""


def read(run):
    return run.kbp_per_s

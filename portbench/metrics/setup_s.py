"""Set-up seconds from the process's start to the window's: inputs, kernels, warm job."""


def read(run):
    return run.setup_s

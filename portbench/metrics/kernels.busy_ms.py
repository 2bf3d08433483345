"""CUDA kernel time a job in the traced window (torch.profiler)."""


def read(run):
    if run.trace is None or run.trace["kernel_s"] <= 0:
        return None
    return 1000.0 * run.trace["kernel_s"] / len(run.jobs)

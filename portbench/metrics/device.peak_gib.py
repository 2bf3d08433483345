"""Peak device memory allocated over the window (torch.cuda), GiB."""


def read(run):
    return run.peak_bytes / 2**30 if run.peak_bytes else None

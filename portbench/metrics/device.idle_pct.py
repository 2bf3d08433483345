"""The device's idle share of the traced window: 100 - the union of
kernel and copy intervals, %."""


def read(run):
    if run.trace is None or run.trace["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - run.trace["busy_s"] / run.trace["window_s"])

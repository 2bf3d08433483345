"""Overlaps the align stage realigned on the host, % of those it took
(stats["host_items"] / stats["items"]); nothing where it took none."""


def read(run):
    items = sum(j["items"] for j in run.jobs)
    if not items:
        return None
    return 100.0 * sum(j["host_items"] for j in run.jobs) / items

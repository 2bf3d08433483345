"""The measured window: a closed loop of one client that sends a whole
job and waits for its answer before it sends the next.

Jobs run back to back. After each, the next starts only if the mean of
the jobs so far says it will end within the window's `seconds`; the
first always runs. The window runs from the first job's start to the
last job's end, and a rate is all the work of all its jobs over that
whole time: never a median of jobs, and never a count of the jobs that
happen to end inside a fixed clock.
"""

from __future__ import annotations

import time


def run_window(job, seconds: float, clock=time.perf_counter):
    """Call job(k) for k = 0, 1, ... by the rule above. Each call returns
    a dict (its record); the record gains `start_s` (from the window's
    start) and `seconds`. Returns (records, window seconds)."""
    records = []
    start = clock()
    busy = 0.0
    while True:
        t0 = clock()
        rec = job(len(records))
        t1 = clock()
        rec["start_s"] = t0 - start
        rec["seconds"] = t1 - t0
        records.append(rec)
        busy += t1 - t0
        if (t1 - start) + busy / len(records) > seconds:
            return records, t1 - start


def rate(records, window_s: float, key: str = "bases") -> float:
    """All of `key` over all jobs, a second of the whole window."""
    return sum(r[key] for r in records) / window_s

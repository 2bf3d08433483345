"""Whether the timed jobs answered right, decided against the plain
reference (portbench/reference/), which imports nothing of the program.

The reference loads the job's input files itself and draws a sample of
windows from the seed: `regions` runs of `windows` consecutive windows,
each on one target. For each sampled window it aligns every overlap
that reaches the window's run (or walks its CIGAR), cuts the layers,
and computes the consensus; the runs of windows are shared among
processes, one a usable core, once the window has closed.
Against every job of the window it then counts:

- layers_differ: sampled windows whose layers (begin, end, bases, in
  order) differ from the job's (the align stage's breaking points, or
  the CIGAR walk, and the window assignment);
- consensus_differ: sampled windows whose consensus bytes or polished
  flag differ from what the job's consensus stage returned;
- records_differ: jobs whose output records (names with racon's tags,
  and sequences) differ from the reference's stitch of that job's
  per-window answers over all windows.

Each is exact, so each limit is 0.
"""

from __future__ import annotations

import multiprocessing

import numpy as np

from .reference import racon

LIMITS = {"layers_differ": 0, "consensus_differ": 0, "records_differ": 0}


def sample_windows(job: racon.Job, seed: int, regions: int, windows: int
                   ) -> list[tuple[int, int, int]]:
    """(target, first rank, end rank) of each sampled run of windows."""
    rng = np.random.default_rng([int(seed), 0x5EED])
    out = []
    for _ in range(regions):
        t, rank = job.window(int(rng.integers(job.num_windows)))
        n = int(job.first_window[t + 1] - job.first_window[t])
        lo = max(0, min(rank, n - windows))
        out.append((t, lo, min(n, lo + windows)))
    return out


_JOB: racon.Job | None = None  # the job a worker process reads


def _load(source: tuple) -> None:
    global _JOB
    _JOB = racon.load_job(*source)


def _region(task) -> dict:
    t, lo, hi, cfg = task
    return {wid: (layers,) + racon.window_consensus(_JOB, wid, layers, cfg)
            for wid, layers in racon.region_layers(_JOB, t, lo, hi).items()}


def _window(task) -> tuple:
    wid, layers, cfg = task
    return wid, racon.window_consensus(_JOB, wid, layers, cfg)


def _map(job: racon.Job, fn, tasks: list, procs: int) -> list:
    """fn over tasks in `procs` fresh processes, each of which loads the
    job again from its files (a process that holds the program's threads
    and its device is not forked); the pool is closed and every worker
    has ended when this returns."""
    global _JOB
    if procs <= 1 or len(tasks) <= 1 or not job.source:
        _JOB = job
        try:
            return [fn(t) for t in tasks]
        finally:
            _JOB = None
    pool = multiprocessing.get_context("spawn").Pool(
        min(procs, len(tasks)), initializer=_load, initargs=(job.source,))
    try:
        return pool.map(fn, tasks, chunksize=1)
    finally:
        pool.close()
        pool.join()


def reference_answers(job: racon.Job, regions, cfg: dict,
                      procs: int = 1) -> dict:
    """wid -> (layers, consensus, polished) of every sampled window, the
    runs of windows shared among `procs` processes."""
    out = {}
    for part in _map(job, _region, [(t, lo, hi, cfg) for t, lo, hi
                                    in _disjoint(regions)], procs):
        out.update(part)
    return dict(sorted(out.items()))


def _disjoint(regions) -> list[tuple[int, int, int]]:
    """The same windows as `regions`, each once: runs on one target that
    overlap or touch are merged (a window's layers do not depend on the
    run it is computed in)."""
    out: list[list[int]] = []
    for t, lo, hi in sorted(regions):
        if out and out[-1][0] == t and lo <= out[-1][2]:
            out[-1][2] = max(out[-1][2], hi)
        else:
            out.append([t, lo, hi])
    return [tuple(r) for r in out]


def window_answers(job: racon.Job, ref: dict, cfg: dict,
                   procs: int = 1) -> dict:
    """wid -> (consensus, polished) of the reference's sampled windows
    recomputed from the same layers under `cfg` (the control's form)."""
    return dict(_map(job, _window, [(wid, layers, cfg) for wid, (layers, _, _)
                                    in ref.items()], procs))


def compare(job: racon.Job, ref: dict, answers: list[dict],
            drop_unpolished: bool) -> tuple[dict, int]:
    """The numbers above over the jobs' answers, and the number of jobs
    with any difference. Each answer holds `layers` (wid -> list of
    (begin, end, bases)) for the sampled windows, `consensus` and
    `polished` indexed by window id (every window where `records`, the
    job's output, is given; the sampled ones at least), and `records`
    or None where an answer has no whole job to judge (the control)."""
    n = dict.fromkeys(LIMITS, 0)
    failed = 0
    for a in answers:
        bad = 0
        for wid, (layers, cons, pol) in ref.items():
            bad_l = a["layers"].get(wid) != layers
            bad_c = (a["consensus"][wid] != cons
                     or bool(a["polished"][wid]) != pol)
            n["layers_differ"] += bad_l
            n["consensus_differ"] += bad_c
            bad += bad_l + bad_c
        bad_r = a["records"] is not None and [
            tuple(r) for r in a["records"]] != racon.stitch(
                job, a["consensus"], a["polished"], drop_unpolished)
        n["records_differ"] += bad_r
        failed += bool(bad + bad_r)
    return n, failed


def verdict(numbers: dict) -> bool:
    return all(numbers[k] <= lim for k, lim in LIMITS.items())


def lines(numbers: dict) -> list[str]:
    return [f"check {k} {numbers[k]} limit {LIMITS[k]}" for k in LIMITS]

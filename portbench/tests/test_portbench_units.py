"""The window rule, the spread arithmetic, the host readings and the
device-trace reduction, on made-up inputs."""

import json
import os
import statistics
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

from portbench import devtrace, hostinfo, spread, window  # noqa: E402


class Clock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t


@pytest.mark.parametrize("durations, seconds, n_jobs", [
    ([10.0] * 9, 51.0, 5),     # 5 x 10 = 50 <= 51; a 6th would end at 60
    ([10.0] * 9, 49.0, 4),     # a 5th would end at 50 > 49
    ([30.0] * 4, 10.0, 1),     # the first job always runs
    ([8.0, 12.0, 10.0, 10.0, 10.0, 10.0], 40.0, 4),
])
def test_window_runs_jobs_back_to_back_within_seconds(durations, seconds,
                                                       n_jobs):
    clock = Clock()

    def job(k):
        clock.t += durations[k]
        return {"bases": 1000}

    recs, win = window.run_window(job, seconds, clock)
    assert len(recs) == n_jobs
    assert win == pytest.approx(sum(durations[:n_jobs]))
    starts = [r["start_s"] for r in recs]
    ends = [r["start_s"] + r["seconds"] for r in recs]
    assert starts[0] == 0.0 and starts[1:] == pytest.approx(ends[:-1])
    # no job was started that the mean said would end past `seconds`
    for k in range(1, n_jobs):
        mean = sum(durations[:k]) / k
        assert ends[k - 1] + mean <= seconds
    if n_jobs < len(durations):
        mean = sum(durations[:n_jobs]) / n_jobs
        assert ends[-1] + mean > seconds
    # the rate is all bases over the whole window, not a median of jobs
    assert window.rate(recs, win) == pytest.approx(1000 * n_jobs / win)


def test_window_rate_counts_a_slow_job_in_full():
    clock = Clock()
    d = [5.0, 5.0, 20.0]

    def job(k):
        clock.t += d[k]
        return {"bases": 100}

    recs, win = window.run_window(job, 30.0, clock)
    assert len(recs) == 3 and win == 30.0
    assert window.rate(recs, win) == pytest.approx(10.0)
    assert window.rate(recs, win) != statistics.median(
        [100 / x for x in d])


def test_spread_arithmetic():
    v = [100.0, 102.0, 98.0, 101.0, 99.0, 150.0]
    q1, _, q3 = statistics.quantiles(v, n=4)
    assert spread.iqr_share(v) == pytest.approx(
        (q3 - q1) / statistics.median(v))
    # leaving out the far run (150) narrows the range
    assert spread.trimmed_range_share(v) == pytest.approx(
        4.0 / statistics.median(v))
    even = [1.0, 1.0, 1.0, 1.0]
    assert spread.iqr_share(even) == 0.0
    assert spread.trimmed_range_share(even) == 0.0
    zeros = [0.0] * 5
    assert spread.iqr_share(zeros) == spread.trimmed_range_share(zeros) == 0.0


def test_steal_and_iowait_shares_from_proc_stat(tmp_path):
    def stat(user, system, idle, iowait, steal):
        p = tmp_path / "stat"
        p.write_text(f"cpu  {user} 0 {system} {idle} {iowait} 0 0 {steal}"
                     " 0 0\ncpu0 1 2 3 4 5 6 7 8 9 10\nintr 5\n")
        return hostinfo.cpu_times(str(p))

    a = stat(1000, 200, 5000, 10, 40)
    b = stat(1600, 300, 5200, 30, 90)
    s = hostinfo.shares(a, b)
    total = 600 + 100 + 200 + 20 + 50
    assert s["steal_pct"] == pytest.approx(100 * 50 / total)
    assert s["iowait_pct"] == pytest.approx(100 * 20 / total)
    assert hostinfo.shares(None, b)["steal_pct"] is None
    assert hostinfo.cpu_times(str(tmp_path / "missing")) is None
    live = hostinfo.cpu_times()
    assert live is None or len(live) == 8


def test_usable_cores_within_affinity():
    n = hostinfo.usable_cores()
    assert 1 <= n <= len(os.sched_getaffinity(0))


def _ev(name, cat, ts, dur):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}


def test_device_trace_busy_idle_and_breakdown(tmp_path):
    ev = [
        _ev(devtrace.WINDOW_SPAN, "user_annotation", 0, 1000),
        _ev("portbench::initialize", "user_annotation", 0, 400),
        _ev("portbench::polish", "user_annotation", 400, 600),
        _ev("racon::dispatch", "user_annotation", 450, 100),
        _ev("k1", "kernel", 100, 50),
        _ev("k1", "kernel", 120, 50),          # overlaps the first
        _ev("k3", "kernel", 400, 10),
        _ev("Memcpy HtoD", "gpu_memcpy", 500, 20),
        _ev("k2", "kernel", 900, 200),         # cut at the window's end
        _ev("k0", "kernel", -50, 20),          # before the window
        _ev("aten::add", "cpu_op", 10, 5),
    ]
    p = tmp_path / "t.json"
    p.write_text(json.dumps({"traceEvents": ev}))
    s = devtrace.summarize(devtrace.load(str(p)))
    assert s["window_s"] == pytest.approx(1e-3)
    assert s["busy_s"] == pytest.approx((70 + 10 + 20 + 100) * 1e-6)
    assert s["kernel_s"] == pytest.approx((50 + 50 + 10 + 100) * 1e-6)
    assert s["device_ops"][0] == ["k1", pytest.approx(100e-6)]
    gaps = dict(s["idle_gaps"])
    # gaps [0,100) and [170,400) have their middles in initialize,
    # [410,500) in racon::dispatch (450-550, inside polish), [520,900)
    # in polish
    assert gaps["portbench::initialize"] == pytest.approx(330e-6)
    assert gaps["racon::dispatch"] == pytest.approx(90e-6)
    assert gaps["portbench::polish"] == pytest.approx(380e-6)
    assert devtrace.summarize([_ev("k", "kernel", 0, 1)]) is None

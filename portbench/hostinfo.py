"""What the host gave a run: the cores it may use, the CPU time the
hypervisor took from it (steal) and its I/O wait, its load, and the
card's name, power limit, SM clock and temperature. Reads only."""

from __future__ import annotations

import os
import subprocess


def usable_cores() -> int:
    """Cores this process may run on: its affinity, capped by the cgroup
    v2 CPU quota where one is set."""
    n = len(os.sched_getaffinity(0))
    try:
        with open("/sys/fs/cgroup/cpu.max") as f:
            quota, period = f.read().split()[:2]
        if quota != "max":
            n = min(n, max(1, int(int(quota) // int(period))))
    except (OSError, ValueError):
        pass
    return n


def cpu_times(path: str = "/proc/stat") -> list[int] | None:
    """The aggregate `cpu` line of /proc/stat: user, nice, system, idle,
    iowait, irq, softirq, steal (in clock ticks), or None."""
    try:
        with open(path) as f:
            for line in f:
                if line.startswith("cpu "):
                    v = [int(x) for x in line.split()[1:]]
                    return (v + [0] * 8)[:8]
    except OSError:
        pass
    return None


def shares(before, after) -> dict:
    """Steal and iowait as % of all CPU time between two cpu_times()."""
    if before is None or after is None:
        return {"steal_pct": None, "iowait_pct": None}
    d = [b - a for a, b in zip(before, after)]
    total = sum(d)
    if total <= 0:
        return {"steal_pct": 0.0, "iowait_pct": 0.0}
    return {"steal_pct": 100.0 * d[7] / total,
            "iowait_pct": 100.0 * d[4] / total}


def loadavg() -> float | None:
    try:
        return os.getloadavg()[0]
    except OSError:
        return None


def card() -> dict:
    """nvidia-smi's name, power limit, SM clock and temperature of card 0."""
    keys = ("name", "power.limit", "clocks.sm", "temperature.gpu")
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=" + ",".join(keys),
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()
    except (OSError, subprocess.TimeoutExpired):
        return {}
    if not out:
        return {}
    return dict(zip(keys, (x.strip() for x in out[0].split(","))))

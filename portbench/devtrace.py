"""Reading the device's time from a torch.profiler chrome trace.

Within the window's span (`portbench::window`): the union of the kernel
and copy intervals (the device busy), the kernels' summed time, the
device operations that took most time, and the idle gaps between device
intervals, each named by the innermost host span (the benchmark's
`portbench::` spans around each layer call, the consensus stage's
`racon::` spans) that held the gap's middle.
"""

from __future__ import annotations

import bisect
import json

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
WINDOW_SPAN = "portbench::window"


def load(path: str) -> list[dict]:
    with open(path) as f:
        data = json.load(f)
    return data["traceEvents"] if isinstance(data, dict) else data


def _union(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def summarize(events: list[dict], top: int = 10) -> dict | None:
    """Device busy, kernel time and the breakdown over the window span,
    in seconds; None when the trace holds no window span."""
    win = [e for e in events if e.get("ph") == "X"
           and e.get("name") == WINDOW_SPAN
           and e.get("cat") in ("user_annotation", "cpu_op")]
    if not win:
        return None
    w0 = float(win[0]["ts"])
    w1 = w0 + float(win[0]["dur"])
    dev = []
    kernel_us = 0.0
    by_name: dict[str, float] = {}
    spans = []
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        s = float(e["ts"])
        t = s + float(e["dur"])
        cat = e.get("cat", "")
        if cat in DEVICE_CATS:
            s, t = max(s, w0), min(t, w1)
            if t <= s:
                continue
            dev.append((s, t))
            by_name[e["name"]] = by_name.get(e["name"], 0.0) + (t - s)
            if cat == "kernel":
                kernel_us += t - s
        elif cat == "user_annotation" and e.get("name") != WINDOW_SPAN \
                and str(e.get("name", "")).startswith(("portbench::",
                                                        "racon::")):
            spans.append((s, t, e["name"]))
    busy = _union(dev)
    busy_us = sum(t - s for s, t in busy)
    # idle gaps, named by the innermost host span around their middle
    spans.sort()
    starts = [s for s, _, _ in spans]
    gaps: dict[str, float] = {}
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    for k in range(0, len(edges), 2):
        g0, g1 = edges[k], edges[k + 1]
        if g1 <= g0:
            continue
        mid = 0.5 * (g0 + g1)
        name = "(no span)"
        best = None
        for i in range(bisect.bisect_right(starts, mid) - 1, -1, -1):
            s, t, nm = spans[i]
            if t >= mid and (best is None or t - s < best):
                best, name = t - s, nm
            if best is not None and mid - s > best:
                break
        gaps[name] = gaps.get(name, 0.0) + (g1 - g0)
    order = lambda d: sorted(d.items(), key=lambda kv: -kv[1])[:top]
    return {
        "window_s": (w1 - w0) * 1e-6,
        "busy_s": busy_us * 1e-6,
        "kernel_s": kernel_us * 1e-6,
        "device_ops": [[n, v * 1e-6] for n, v in order(by_name)],
        "idle_gaps": [[n, v * 1e-6] for n, v in order(gaps)],
    }

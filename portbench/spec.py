"""What a run is made of, found by name: BENCHMARK.json at the checkout's
root, a configuration file under configs/, a traffic file under
traffic/, and one reader a metric under metrics/<metric name>.py.

Nothing here knows a cell, a configuration or a metric by name: a later
change adds one by adding its files and its entries.
"""

from __future__ import annotations

import importlib.util
import json
import os
import re

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def load_benchmark(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def cell(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload named {name!r} in BENCHMARK.json")


def config(bench: dict, name: str, root: str = ROOT) -> dict:
    for c in bench["configs"]:
        if c["name"] == name:
            with open(os.path.join(root, c["file"])) as f:
                return json.load(f)
    raise KeyError(f"no config named {name!r} in BENCHMARK.json")


def traffic(name: str, root: str = ROOT) -> dict:
    with open(os.path.join(root, "portbench", "traffic", name + ".json")) as f:
        return json.load(f)


def metrics_for(bench: dict, workload: str, traced: bool) -> list[dict]:
    """The cell's end-to-end metrics (untraced) or per-layer metrics
    (traced): each listed for it, or listing no cells at all."""
    group = bench["per_layer" if traced else "end_to_end"]
    return [m for m in group
            if workload in m.get("workloads", [workload])]


def reader(name: str, root: str = ROOT):
    """The `read(run)` function of metrics/<name>.py, or where there is
    none, of the file named without the name's last part: one reader
    serves `native.merge_s.polish` and `native.merge_s.correct`, the
    same quantity split by the end-to-end metric it moves."""
    path = os.path.join(root, "portbench", "metrics", name + ".py")
    if not os.path.exists(path) and "." in name:
        path = os.path.join(root, "portbench", "metrics",
                            name.rsplit(".", 1)[0] + ".py")
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + re.sub(r"\W", "_", name), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read

"""BENCHMARK.json against the harness: names and units in the allowed
characters, a reader file for every metric, every per-layer metric's
`moves` reported in each cell it lists, and a configuration, a traffic
mix and a metric that are only added as files being found by name."""

import json
import os
import re
import shutil
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from portbench import harness, spec  # noqa: E402


NAME_RE = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT_RE = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.fixture(scope="module")
def bench():
    return spec.load_benchmark(ROOT)


def name_errors(bench: dict) -> list[str]:
    """Names and units outside the allowed characters."""
    bad = []
    names = [c["name"] for c in bench["configs"]]
    for w in bench["workloads"]:
        names += [w["name"], w["config"], w["traffic"]]
    for c in bench["configs"]:
        names += list(c["reduced"])
    for m in bench["end_to_end"] + bench["per_layer"]:
        names.append(m["name"])
        if not UNIT_RE.match(m["unit"]):
            bad.append("unit " + m["unit"])
    return bad + ["name " + n for n in names if not NAME_RE.match(n)]


def test_names_and_units_allowed(bench):
    assert name_errors(bench) == []
    assert NAME_RE.match("a.b-c_1") and not NAME_RE.match("a b")
    assert not NAME_RE.match("x/y") and not NAME_RE.match("a,b")
    assert UNIT_RE.match("kbp/s") and not UNIT_RE.match("kbp per s")
    assert not UNIT_RE.match("µs")
    for w in bench["workloads"]:
        assert len(w["why"]) <= 200 and "\n" not in w["why"]
    for m in bench["per_layer"]:
        assert 1 <= len(m["layer"]) <= 200
    for path, _, files in os.walk(os.path.join(ROOT, "portbench")):
        for f in files:
            assert re.match(r"^[A-Za-z0-9_.-]+$", f), f


def test_benchmark_file_shape(bench):
    assert list(bench) == ["command", "paths", "run_seconds", "configs",
                           "workloads", "end_to_end", "per_layer"]
    assert bench["command"] == ["python3", "portbench/run.py"]
    assert bench["paths"] == ["portbench"]
    assert 1 <= bench["run_seconds"] <= 51
    for m in bench["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    assert "setup_s" in [m["name"] for m in bench["end_to_end"]]
    for c in bench["configs"]:
        assert c["file"].startswith("portbench/")
        cfg = spec.config(bench, c["name"], ROOT)
        assert cfg["source"] == c["source"]
        assert sorted(cfg["reduced"]) == sorted(c["reduced"])
        assert all(k in cfg for k in c["reduced"])
    used = {w["config"] for w in bench["workloads"]}
    assert used == {c["name"] for c in bench["configs"]}
    assert all(w["chips"] == 1 for w in bench["workloads"])


def test_every_metric_has_a_reader(bench):
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert callable(spec.reader(m["name"], ROOT)), m["name"]


def test_each_cell_reports_what_its_metrics_move(bench):
    for w in bench["workloads"]:
        e2e = {m["name"] for m in spec.metrics_for(bench, w["name"], False)}
        layer = spec.metrics_for(bench, w["name"], True)
        assert "setup_s" in e2e and len(e2e) >= 2 and layer, w["name"]
    e2e_names = {m["name"] for m in bench["end_to_end"]}
    for m in bench["per_layer"]:
        assert m["moves"] in e2e_names
        for cell in m.get("workloads", [w["name"]
                                        for w in bench["workloads"]]):
            reported = {x["name"] for x in
                        spec.metrics_for(bench, cell, False)}
            assert m["moves"] in reported, (m["name"], cell)


def test_readers_return_nothing_where_nothing_is_read(bench):
    run = harness.Run(jobs=[{"initialize_s": 2.0, "polish_s": 3.0,
                             "items": 0, "host_items": 0, "bases": 10,
                             "dispatch_s": 1.0, "poa_round_s": 0.5}],
                      window_s=5.0, setup_s=7.0, peak_bytes=0)
    got = {m["name"]: spec.reader(m["name"], ROOT)(run)
           for m in bench["per_layer"]}
    assert got["polisher.initialize_s.correct"] == 2.0
    assert got["align.host_item_pct.correct"] is None  # no align items
    assert got["device.idle_pct.correct"] is None      # no trace
    assert got["kernels.busy_ms.correct"] is None
    assert got["device.peak_gib.correct"] is None
    # polish_kbp_per_s is kept for a later cell (PERF.md)
    assert spec.reader("polish_kbp_per_s", ROOT)(run) == pytest.approx(
        0.002)


def test_added_files_are_found_by_name(tmp_path, bench):
    root = tmp_path / "checkout"
    shutil.copytree(os.path.join(ROOT, "portbench"), root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    b = json.loads(json.dumps(bench))
    cfg = spec.config(bench, "read_correct_ont_kf", ROOT)
    cfg.update(name="dummy_cfg", genome_bp=123)
    (root / "portbench/configs/dummy_cfg.json").write_text(json.dumps(cfg))
    (root / "portbench/traffic/dummy_mix.json").write_text(json.dumps(
        {"generator": "paf", "check": {"regions": 1, "windows": 1}}))
    (root / "portbench/metrics/dummy.metric.py").write_text(
        "def read(run):\n    return 42.0\n")
    b["configs"].append({"name": "dummy_cfg", "source": "x",
                         "file": "portbench/configs/dummy_cfg.json",
                         "reduced": [], "why": "a test"})
    b["workloads"].append({"name": "dummy_cell", "config": "dummy_cfg",
                           "traffic": "dummy_mix", "chips": 1, "why": "t"})
    b["per_layer"].append({"name": "dummy.metric", "unit": "s",
                           "better": "lower", "source": "host_clock",
                           "layer": "polisher", "moves": "setup_s",
                           "workloads": ["dummy_cell"]})
    (root / "BENCHMARK.json").write_text(json.dumps(b))
    got = spec.load_benchmark(str(root))
    cell = spec.cell(got, "dummy_cell")
    assert spec.config(got, cell["config"], str(root))["genome_bp"] == 123
    assert spec.traffic(cell["traffic"], str(root))["check"]["regions"] == 1
    names = [m["name"] for m in spec.metrics_for(got, "dummy_cell", True)]
    assert names == ["dummy.metric"]
    assert spec.reader("dummy.metric", str(root))(None) == 42.0
    # a name split by the metric it moves finds the shared reader
    assert spec.reader("dummy.metric.correct", str(root))(None) == 42.0
    with pytest.raises(KeyError):
        spec.cell(got, "no_such_cell")

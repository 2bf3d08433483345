"""A whole run of the harness on the CPU (the kernels' plain versions,
the look for a card skipped) at a size a test can hold: sound runs of
each traffic come out correct; with the timed path broken underneath,
or with the control in the program's place, `correct` comes out false.

The faults a one-chip cell can have: a step that returns its state
unchanged (the consensus stage hands back the backbones), half of the
batch left out (every other window left unpolished), an answer altered
where it is produced (a base of each window's consensus; a breaking
point of each overlap). The controls (control.CONTROLS): the plain
reference itself in the consensus stage's place with one guarantee the
configuration states broken: at most 5 layers a window where it states
up to 200, or one refinement pass where it states four."""

import json
import os
import sys
import time

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from portbench import control, harness, spec  # noqa: E402
from portbench.reference import poa  # noqa: E402
from racon_tpu_torch.ops.align_stage import TorchAlignStage  # noqa: E402
from racon_tpu_torch.ops.consensus_stage import (  # noqa: E402
    TorchConsensusStage)

# (config, traffic): genome, read length and coverage at a size a test
# can hold (None: the configuration's); cigar_sam's traffic file is kept
# for a later cell (PERF.md)
SIZES = {("contig_polish_ont", "placement_paf"): (12000, 2000, None),
         ("contig_polish_ont", "cigar_sam"): (12000, 2000, None),
         ("read_correct_ont_kf", "ava_paf"): (6000, 2000, 12)}
PAF = ("contig_polish_ont", "placement_paf")


def run(pair, seed=2**31 + 77):
    bench = spec.load_benchmark(ROOT)
    # the configuration's file, also where no cell of BENCHMARK.json
    # runs it yet (contig_polish_ont, PERF.md)
    with open(os.path.join(ROOT, "portbench", "configs",
                           pair[0] + ".json")) as f:
        cfg = json.load(f)
    genome, read_len, coverage = SIZES[pair]
    cfg["reads"]["length"] = read_len
    cfg["reads"]["coverage"] = coverage or cfg["reads"]["coverage"]
    traffic = spec.traffic(pair[1], ROOT)
    harness.PREFAULT_GIB = 0  # the cell's host memory is not what this tests
    metrics = [m for m in bench["end_to_end"] if m["name"] == "setup_s"]
    out = harness.run_cell(
        "test", cfg, traffic, seed, 0.01, False, time.perf_counter(),
        device="cpu", metrics=metrics, root=ROOT, genome_bp=genome,
        log=lambda s: None)
    assert list(out["check"]) == ["layers_differ", "consensus_differ",
                                  "records_differ"]
    return out


@pytest.mark.parametrize("pair", sorted(SIZES))
def test_sound_run_is_correct(pair):
    out = run(pair)
    assert out["correct"], out["check"]
    assert out["attempted"] == 1 and out["failed"] == 0
    assert set(out["metrics"]) >= {"setup_s"}
    lines = out.pop("_lines")
    assert list(out)[-1] == "check"
    assert lines[0] == "check layers_differ 0 limit 0"


def _patch_consensus(monkeypatch, change):
    orig = TorchConsensusStage.consensus_windows

    def broken(self, windows, cfg, logger):
        cons, pol = orig(self, windows, cfg, logger)
        return change(windows, cfg, list(cons), list(pol))
    monkeypatch.setattr(TorchConsensusStage, "consensus_windows", broken)


def _state_unchanged(windows, cfg, cons, pol):
    return ([windows.backbone(w).tobytes() for w in range(len(cons))],
            [True] * len(cons))


def _half_left_out(windows, cfg, cons, pol):
    for w in range(1, len(cons), 2):
        cons[w], pol[w] = windows.backbone(w).tobytes(), False
    return cons, pol


def _base_altered(windows, cfg, cons, pol):
    swap = bytes.maketrans(b"ACGT", b"CGTA")
    return [c[:len(c) // 2] + c[len(c) // 2:len(c) // 2 + 1].translate(swap)
            + c[len(c) // 2 + 1:] for c in cons], pol


def _control(name):
    """The reference in the consensus stage's place, under a control."""
    change = control.CONTROLS[name]

    def reference(windows, cfg, cons, pol):
        depth = change.get("max_window_depth", cfg.max_window_depth)
        passes = change.get("refine_passes", cfg.refine_passes)
        out_c, out_p = [], []
        tgs = bool(windows.window_type)
        for w in range(windows.num_windows):
            layers = [(windows.layer_data(int(li)), None,
                       int(windows.lay_begin[li]), int(windows.lay_end[li]))
                      for li in windows.layer_indices(w)][:depth]
            c, p = poa.consensus_window(
                windows.backbone(w), None, layers, tgs, cfg.trim, cfg.match,
                cfg.mismatch, cfg.gap, window_id=int(windows.win_target[w]),
                rank=int(windows.win_rank[w]), passes=passes,
                cand_frac=cfg.candidate_frac, cand_min=cfg.candidate_min)
            out_c.append(c)
            out_p.append(p)
        return out_c, out_p
    reference.__name__ = "control_" + name
    return reference


@pytest.mark.parametrize("change", [
    _state_unchanged, _half_left_out, _base_altered,
    *(_control(name) for name in control.CONTROLS)],
    ids=lambda f: f.__name__.strip("_"))
def test_broken_consensus_is_not_correct(monkeypatch, change):
    _patch_consensus(monkeypatch, change)
    out = run(PAF)
    assert not out["correct"]
    assert out["check"]["consensus_differ"]["value"] > 0
    assert out["failed"] == 1


def test_altered_breaking_points_are_not_correct(monkeypatch):
    orig = TorchAlignStage.breaking_points

    def shifted(self, *a, **kw):
        out = orig(self, *a, **kw)
        for bp in out:
            bp[:, 1] += 1  # each window's first query base, one later
        return out
    monkeypatch.setattr(TorchAlignStage, "breaking_points", shifted)
    out = run(PAF)
    assert not out["correct"]
    assert out["check"]["layers_differ"]["value"] > 0


def test_altered_records_are_not_correct(monkeypatch):
    from racon_tpu_torch import polisher

    orig = polisher.stitch

    def dropped(*a, **kw):
        return orig(*a, **kw)[:-1] or [(b"x", b"A")]
    monkeypatch.setattr(polisher, "stitch", dropped)
    out = run(PAF)
    assert not out["correct"]
    assert out["check"]["records_differ"]["value"] == 1


def test_sample_is_drawn_from_the_seed():
    from portbench import check
    from portbench.reference.racon import Job

    job = Job([(b"a", b"A" * 5000), (b"b", b"C" * 1200)], {}, [], 500,
              True, False, np.array([0, 10, 13]))
    a = check.sample_windows(job, 2**31 + 1, 4, 3)
    assert a == check.sample_windows(job, 2**31 + 1, 4, 3)
    assert a != check.sample_windows(job, 2**31 + 2, 4, 3)
    for t, lo, hi in a:
        n = 10 if t == 0 else 3
        assert 0 <= lo < hi <= n and hi - lo == 3

"""Ablation microbenchmark of the int32 panel sweep (K7): time variants
with pieces removed to find where a sweep's milliseconds go. Port of the
JAX package's benchmarks/profile_ablate.py, on one GPU:

    python -m racon_tpu_torch.benchmarks.profile_ablate [B cap W] \\
        [--device cuda|cpu]

B cap W default to 8192 640 128, the JAX harness's. One line per call,
each the median of 5 timed calls after one warm-up (CUDA events around
each call on the card; the host clock with --device cpu):

  full       the panel sweep's body as a K8 variant (computes K7's result)
  noclosure  the max-plus scan removed (h = cand: wrong results)
  nomoves    the move stores removed (score only)
  noload     every row reads its window at the static offset W + dlo and
             query row 0
  empty      the bare launch and loop: one add and one store per 16 rows
  nwonly     the panel sweep, nw_sweep_t (K7)
  walkonly   the RLE walk alone on nwonly's moves
  fused+h2d  align_walk_padded from the packed numpy batch: the upload, the
             sweep (K1) and the walk, host clock, ending in a sync

Without a GPU it exits 2 unless --device cpu is given, which times the
plain PyTorch versions on the host (no device metric).
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from ..kernels import LAUNCHES
from ..ops import nw_kernel as nk
from ..ops.geometry import PAD_CODE

VARIANTS = nk.SWEEP_T_VARIANTS
SCORES = dict(match=5, mismatch=-4, gap=-8)  # make_kernel(..., 5, -4, -8)


def run_variant(q, tp, gcp, *, m_cap, n_cap, w_band, variant):
    """K8 (profile_ablate.py::run_variant): the panel sweep at the
    harness's scores with `variant`'s piece switched off -> (moves, score)
    in nw_sweep_t's layout ("nomoves": moves unwritten). CUDA panels
    launch nw_sweep_t.cu's instantiation, counted as "nw_ablate"; CPU
    panels run run_variant_plain; any other device raises."""
    nk.check_sweep_t(m_cap, n_cap, w_band, variant)
    if q.device.type == "cpu":
        return run_variant_plain(q, tp, gcp, m_cap=m_cap, n_cap=n_cap,
                                 w_band=w_band, variant=variant)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    out = nk.launch_sweep_t(q, tp, gcp, m_cap=m_cap, n_cap=n_cap,
                            w_band=w_band, **SCORES, variant=variant)
    LAUNCHES["nw_ablate"] += 1
    return out


def variant_work(B, m_cap, n_cap, W, variant, ops_cell=15):
    """(bytes, integer ops) that one variant's launch on B items must at
    least move and do: every variant writes the score; full (K7) reads q,
    tp and gcp once and writes the moves, `ops_cell` ops per cell (15:
    substitution 5, diag/up/max 3, gc 3, scan max 1, moves 3); noclosure
    reads no gc past row 0 and drops the scan and the gc arithmetic (4
    ops); nomoves writes no moves (3 ops); noload reads one query code and
    one band window of tp and of gcp (W + 1 columns) per item; empty reads
    gcp's first W columns and does one add per move word it stores."""
    score, moves = 4 * B, 4 * B * (m_cap // 16) * W
    q, window = 4 * B * m_cap, 4 * B * W
    tp = 4 * B * (n_cap + 2 * W)
    gcp = tp + 4 * B
    cells = B * m_cap * W
    if variant == "empty":
        return window + moves + score, moves // 4
    nbytes, ops = {
        "full": (q + tp + gcp + moves, ops_cell),
        "noclosure": (q + tp + window + moves, ops_cell - 4),
        "nomoves": (q + tp + gcp, ops_cell - 3),
        "noload": (4 * B + 2 * window + 4 * B + moves, ops_cell),
    }[variant]
    return nbytes + score, cells * ops


def run_variant_plain(q, tp, gcp, *, m_cap, n_cap, w_band, variant):
    """Plain PyTorch version of run_variant on CPU panels."""
    nk.check_sweep_t(m_cap, n_cap, w_band, variant)
    if q.device.type != "cpu":
        raise ValueError("run_variant_plain takes CPU tensors")
    return nk.sweep_t_rows(q, tp, gcp, m_cap=m_cap, n_cap=n_cap,
                           w_band=w_band, **SCORES, variant=variant)


def make_inputs(B, cap, W, seed=0):
    """The JAX harness's batch (profile_ablate.py:165-182), drawn from
    np.random.default_rng(seed) in its order: query lengths m in
    [hi - 100, hi), hi = min(520, cap), target lengths n = min(m + [-20,
    20), cap), random codes, the target's first min(m, n) codes the
    query's, and every deletion column costing the gap. Returns a dict of
    numpy arrays: q8, t8 (B, cap) int8 codes, m, n (B,) int32, the panels
    q, tp, gcp of nw_sweep_t, and q4, t4, dcb, the packed uplink of
    align_walk_padded."""
    rng = np.random.default_rng(seed)
    hi = min(520, cap)
    mlen = rng.integers(hi - 100, hi, B).astype(np.int32)
    nlen = np.minimum(mlen + rng.integers(-20, 20, B), cap).astype(np.int32)
    q8 = np.full((B, cap), PAD_CODE, np.int8)
    t8 = np.full((B, cap), PAD_CODE, np.int8)
    for i in range(B):
        q8[i, : mlen[i]] = rng.integers(0, 4, mlen[i])
        t8[i, : nlen[i]] = rng.integers(0, 4, nlen[i])
        L = min(mlen[i], nlen[i])
        t8[i, :L] = q8[i, :L]
    dc = torch.full((B, cap), SCORES["gap"], dtype=torch.int32)
    q, tp, gcp = nk.sweep_t_panels(torch.from_numpy(q8),
                                   torch.from_numpy(t8), dc, w_band=W)
    return dict(q8=q8, t8=t8, m=mlen, n=nlen, q=q.numpy(), tp=tp.numpy(),
                gcp=gcp.numpy(), q4=_nibbles(q8), t4=_nibbles(t8),
                dcb=np.full((B, cap // 8), 0xFF, np.uint8))


def _nibbles(x8):
    """(B, cap) codes -> (B, cap // 2) uint8, two per byte, low first."""
    x = x8.astype(np.uint8)
    return x[:, 0::2] | (x[:, 1::2] << 4)


def timed(fn, device, reps=5, sync=False):
    """(median ms of `reps` calls of fn after one warm-up, the last call's
    result): CUDA events around each call on the card, or with sync the
    host clock ending in torch.cuda.synchronize(); the host clock on the
    CPU."""
    out = fn()
    ts = []
    for _ in range(reps):
        if device == "cuda" and not sync:
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            out = fn()
            e1.record()
            e1.synchronize()
            ts.append(e0.elapsed_time(e1))
        else:
            t0 = time.perf_counter()
            out = fn()
            if device == "cuda":
                torch.cuda.synchronize()
            ts.append(1e3 * (time.perf_counter() - t0))
    return sorted(ts)[len(ts) // 2], out


def run_lines(inp, device, reps=5, out=print):
    """Every line of the harness on make_inputs' `inp`, on `device`
    ("cuda" or "cpu"): prints '<name>: <ms> ms' for each and returns
    {name: (ms, what its last call returned)}."""
    B, cap = inp["q8"].shape
    W = (inp["tp"].shape[1] - cap) // 2
    dev = torch.device(device)
    q, tp, gcp, m, n = (torch.from_numpy(inp[k]).to(dev)
                        for k in ("q", "tp", "gcp", "m", "n"))
    geo = dict(m_cap=cap, n_cap=cap, w_band=W)
    lines = {}

    def line(name, fn, sync=False):
        lines[name] = timed(fn, device, reps, sync)
        out(f"{name:10s}: {lines[name][0]:10.3f} ms")

    for v in VARIANTS:
        line(v, lambda: run_variant(q, tp, gcp, **geo, variant=v))
    line("nwonly", lambda: nk.nw_sweep_t(q, tp, gcp, **geo, **SCORES))
    moves = lines["nwonly"][1][0]
    line("walkonly", lambda: nk.rle_walk(moves, m, n, **geo))
    line("fused+h2d", lambda: nk.align_walk_padded(
        inp["q4"], inp["t4"], inp["dcb"], inp["m"], inp["n"], **geo,
        **SCORES, device=device), sync=True)
    return lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("B", nargs="?", type=int, default=8192)
    ap.add_argument("cap", nargs="?", type=int, default=640)
    ap.add_argument("W", nargs="?", type=int, default=128)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        sys.stderr.write("profile_ablate: no CUDA device (--device cpu "
                         "times the plain versions on the host)\n")
        return 2
    nk.check_sweep_t(args.cap, args.cap, args.W)
    where = (torch.cuda.get_device_name(0) if args.device == "cuda"
             else "the host CPU (plain versions)")
    print(f"B={args.B} cap={args.cap} W={args.W} on {where}")
    run_lines(make_inputs(args.B, args.cap, args.W), args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())

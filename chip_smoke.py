#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--genome-mb 4.6] [--wide-genome-mb 1.0]

Phases (each must pass, or the script exits non-zero):
  1. the card's name and power limit, the torch/CUDA versions, and the
     build of the kernels from racon_tpu_torch/kernels/csrc;
  2. each kernel against its plain PyTorch version (on the host CPU) at the
     main paths' shapes, byte for byte, with CUDA-event times: the sweep
     and RLE walk at (640,128) and (5120,1024), the Myers sweep and walk at
     (2560,512) and (10240,1024), the wide sweep and packed2 walk at
     (10240,2048);
  3. the consensus stage on the bench workload (testing.synth
     build_workload, 2048 windows of 500 bp, 12% error, match 5 /
     mismatch -4 / gap -8): edit distance to the truth must be exactly 91;
  4. the default polish path end to end (the CLI's arguments `--backend
     cuda -m 5 -x -4 -g -8 -t <cores>`, then create_polisher ->
     initialize -> polish) on testing.synth.make_dataset (4.6 Mb, 20x 8 kb
     reads, 12% error, seed 11): identity to the truth must be >= 99.99%,
     and the sweep, RLE walk and both Myers kernels must have launched;
  5. the wide-band slice end to end: the same path with `-w 10000` on
     make_dataset(1 Mb, 20x 20 kb reads, 12% error split (0.2, 0.5, 0.3)
     between insertions, deletions and substitutions, seed 11): the wide
     sweep and the packed walk must have launched, no item may go to the
     host for want of a band (wide_host_items 0), and the polished contig
     must be closer to the truth than the draft. 1 Mb, not 4.6: at 4.6 Mb
     this phase alone takes about 460 s, most of it the host realigning
     band escapes, and the whole script then passes 10 minutes.
Prints one JSON line of per-kernel results, the card's name and power
limit, then the result line. Without a CUDA device it exits 2 and prints
no result. The port imports neither jax nor racon_tpu; this script makes
sure of it by blocking both imports.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import subprocess
import sys
import tempfile
import time

# any import of jax or of the JAX package from here on fails
sys.modules["jax"] = None
sys.modules["racon_tpu"] = None

ROOT = os.path.dirname(os.path.abspath(__file__))
CSRC = "racon_tpu_torch/kernels/csrc/"
KERNELS = {  # name -> (source, TPU kernel or jnp routine it replaces)
    "nw_sweep": (CSRC + "nw_sweep.cu", "racon_tpu/ops/nw_kernel.py:913"),
    "rle_walk": (CSRC + "rle_walk.cu", "racon_tpu/ops/nw_kernel.py:1242"),
    "myers_sweep": (CSRC + "myers_sweep.cu",
                    "racon_tpu/ops/myers_kernel.py:500"),
    "myers_walk": (CSRC + "myers_walk.cu",
                   "racon_tpu/ops/myers_kernel.py:591"),
    "nw_sweep_wide": (CSRC + "nw_sweep.cu",
                      "racon_tpu/ops/nw_kernel.py:186"),
    "packed_walk": (CSRC + "packed_walk.cu",
                    "racon_tpu/ops/nw_kernel.py:1803"),
}

# Least-time model of one H100 SXM: 3.35 TB/s of HBM (NVIDIA data sheet)
# and 16.73 Tops/s of INT32 (132 SMs x 64 INT32 lanes x 1.98 GHz boost:
# half the FP32 lanes behind the data sheet's 67 TFLOP/s). Integer work
# per unit, counted from each recurrence: a scored-sweep cell 15 ops
# (substitution 5, diag/up/max 3, gc 3, scan max 1, moves 3), a Myers
# 32-cell word 20 ops, a walk step or row 12 ops.
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 132 * 64 * 1.98e9
OPS_SWEEP_CELL = 15
OPS_MYERS_WORD = 20
OPS_WALK_STEP = 12


class SmokeFailure(RuntimeError):
    pass


def log(msg: str) -> None:
    print(msg, flush=True)


def bound(nbytes: float, nops: float) -> tuple[float, str]:
    """(least ms the card could take, what bounds it)."""
    tb = 1e3 * nbytes / HBM_BYTES_PER_S
    to = 1e3 * nops / INT32_OPS_PER_S
    return (tb, "bytes") if tb >= to else (to, "operations")


def make_items(rng, B, cap, w_band, gap, drift=None):
    """Packed batch of B items at cap: mutated read pairs (4% each of
    substitutions, insertions, deletions), every 7th item all PAD, every
    11th cut short so its drift leaves the band, 30% free deletion
    columns. With `drift`, every other item loses that many more bases, so
    its path runs far off the diagonal."""
    import numpy as np

    from racon_tpu_torch.ops.geometry import PAD_CODE, encode

    acgt = np.frombuffer(b"ACGT", np.uint8)
    q8 = np.full((B, cap), PAD_CODE, np.uint8)
    t8 = np.full((B, cap), PAD_CODE, np.uint8)
    dc = np.zeros((B, cap), np.uint8)
    m = np.zeros(B, np.int32)
    n = np.zeros(B, np.int32)
    for b in range(B):
        if b % 7 == 6:
            continue
        tl = int(rng.integers(cap // 2, cap))
        t = rng.choice(acgt, tl)
        q = t[rng.random(tl) > 0.04]
        ins = np.flatnonzero(rng.random(len(q)) < 0.04)
        q = np.insert(q, ins, rng.choice(acgt, len(ins)))
        sub = rng.random(len(q)) < 0.04
        q[sub] = rng.choice(acgt, int(sub.sum()))
        if b % 11 == 3:
            q = q[: len(q) - w_band]
        elif drift and b % 2:
            q = np.delete(q, rng.choice(len(q), drift, replace=False))
        q = q[:cap]
        q8[b, : len(q)] = encode(q)
        t8[b, :tl] = encode(t)
        m[b], n[b] = len(q), tl
        dc[b, :tl] = rng.random(tl) >= 0.3
    q4 = q8[:, 0::2] | (q8[:, 1::2] << 4)
    t4 = t8[:, 0::2] | (t8[:, 1::2] << 4)
    dcb = np.packbits(dc != 0, axis=1, bitorder="little")
    return q4, t4, dcb, m, n


def cuda_ms(fn, reps=5):
    import torch

    fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def host_ms(fn):
    t0 = time.perf_counter()
    out = fn()
    return out, 1e3 * (time.perf_counter() - t0)


def compare(name, got, want):
    import torch

    got = got.cpu()
    if got.shape != want.shape or got.dtype != want.dtype:
        raise SmokeFailure(f"{name}: {tuple(got.shape)} {got.dtype} vs "
                           f"{tuple(want.shape)} {want.dtype}")
    err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max()) \
        if got.numel() else 0
    if err:
        raise SmokeFailure(f"{name}: kernel differs from its plain version "
                           f"(max abs err {err})")
    return err


def _walk_steps_taken(payload, fmt):
    """Move words a walk had to read for this payload: packed2, one per
    non-skip code (plus the escaping step); RLE, one per event pair up to
    the last event."""
    import numpy as np

    p = payload.numpy()
    body, esc = p[:, :-1], p[:, -1].astype(np.int64)
    if fmt == "packed2":
        codes = np.stack([(body >> s) & 3 for s in (0, 2, 4, 6)], -1)
        return int((codes != 3).sum() + esc.sum())
    nz = body != 0
    last = np.where(nz.any(1), body.shape[1] - np.argmax(nz[:, ::-1], 1), 0)
    return int(((last + 1) // 2).sum())


def _sweep_bound(B, cap, W):
    nbytes = B * (cap // 2 + cap // 2 + cap // 8) + B * (cap // 16 * W * 4
                                                          + 4)
    return bound(nbytes, B * cap * W * OPS_SWEEP_CELL)


def _walk_bound(B, cap, W, width, steps):
    nbytes = 4 * steps + B * (8 + width)
    return bound(nbytes, steps * OPS_WALK_STEP)


def phase_kernels(results):
    """Phase 2: each kernel vs its plain version at main-path shapes."""
    import numpy as np

    from racon_tpu_torch.ops import myers_kernel as mk
    from racon_tpu_torch.ops import nw_kernel as nk
    from racon_tpu_torch.ops.batch import to_device

    rng = np.random.default_rng(2024)
    sc = dict(match=5, mismatch=-4, gap=-8)
    for cap, W, B, drift, sweep_name, walk_name, walk in (
            (640, 128, 4096, None, "nw_sweep", "rle_walk", nk.rle_walk),
            (5120, 1024, 8, None, "nw_sweep", "rle_walk", nk.rle_walk),
            (10240, 2048, 16, 700, "nw_sweep_wide", "packed_walk",
             nk.packed_walk)):
        geo = dict(m_cap=cap, n_cap=cap, w_band=W)
        fmt = nk.walk_fmt(W)
        plain_walk = (nk.rle_walk_plain if fmt == "rle"
                      else nk.packed_walk_plain)
        q4, t4, dcb, m, n = make_items(rng, B, cap, W, -8, drift)
        gpu = to_device(q4, t4, dcb, m, n, m_cap=cap, n_cap=cap,
                        device="cuda")
        cpu = to_device(q4, t4, dcb, m, n, m_cap=cap, n_cap=cap,
                        device="cpu")
        moves, score = nk.nw_sweep(gpu.q4, gpu.t4, gpu.dcb, **geo, **sc)
        payload = walk(moves, gpu.m, gpu.n, **geo)
        (pm, ps), sweep_plain = host_ms(lambda: nk.nw_sweep_plain(
            cpu.q4, cpu.t4, cpu.dcb, **geo, **sc))
        pp, walk_plain = host_ms(lambda: plain_walk(pm, cpu.m, cpu.n, **geo))
        err = max(compare(f"{sweep_name} moves", moves, pm),
                  compare(f"{sweep_name} score", score, ps))
        werr = compare(f"{walk_name} payload", payload, pp)
        sweep = cuda_ms(lambda: nk.nw_sweep(gpu.q4, gpu.t4, gpu.dcb, **geo,
                                            **sc))
        wms = cuda_ms(lambda: walk(moves, gpu.m, gpu.n, **geo))
        esc = int(pp[:, -1].sum())
        steps = _walk_steps_taken(pp, fmt)
        log(f"[kernels] {sweep_name}+{walk_name} ({cap},{W}) B={B}: "
            f"byte-equal, {esc} escapes, {steps} walk steps; sweep "
            f"{sweep:.3f} ms (plain CPU {sweep_plain:.1f} ms), walk "
            f"{wms:.3f} ms (plain CPU {walk_plain:.1f} ms)")
        if cap in (640, 10240):
            bs, bys = _sweep_bound(B, cap, W)
            bw, byw = _walk_bound(B, cap, W, pp.shape[1], steps)
            results[sweep_name].update(
                max_abs_err=err, ms=sweep, plain_ms=sweep_plain,
                bound_ms=bs, bound_by=bys)
            results[walk_name].update(
                max_abs_err=werr, ms=wms, plain_ms=walk_plain,
                bound_ms=bw, bound_by=byw)
        if cap == 10240:
            # the slice's launch size: one chunk of the 1 GiB move budget
            from racon_tpu_torch.ops.consensus_stage import chunk_size

            Bc = chunk_size(cap, W, 8192)
            q4, t4, dcb, m, n = make_items(rng, Bc, cap, W, -8, drift)
            big = to_device(q4, t4, dcb, m, n, m_cap=cap, n_cap=cap,
                            device="cuda")
            mv_big, _ = nk.nw_sweep(big.q4, big.t4, big.dcb, **geo, **sc)
            s_big = cuda_ms(lambda: nk.nw_sweep(big.q4, big.t4, big.dcb,
                                                **geo, **sc), reps=3)
            w_big = cuda_ms(lambda: walk(mv_big, big.m, big.n, **geo),
                            reps=3)
            bs, _ = _sweep_bound(Bc, cap, W)
            log(f"[kernels] {sweep_name}+{walk_name} ({cap},{W}) B={Bc} "
                f"(one chunk): sweep {s_big:.3f} ms (bound {bs:.3f} ms), "
                f"walk {w_big:.3f} ms")
    for cap, W, B in ((2560, 512, 1024), (10240, 1024, 8)):
        geo = dict(m_cap=cap, n_cap=cap, w_band=W)
        q4, t4, _, m, n = make_items(rng, B, cap, W, -1)
        gpu = to_device(q4, t4, None, m, n, m_cap=cap, n_cap=cap,
                        device="cuda")
        cpu = to_device(q4, t4, None, m, n, m_cap=cap, n_cap=cap,
                        device="cpu")
        planes = mk.myers_sweep(gpu.q4, gpu.t4, **geo)
        payload = mk.myers_walk(planes, gpu.m, gpu.n, **geo)
        pl, sweep_plain = host_ms(lambda: mk.myers_sweep_plain(
            cpu.q4, cpu.t4, **geo))
        pp, walk_plain = host_ms(lambda: mk.myers_walk_plain(
            pl, cpu.m, cpu.n, **geo))
        err = compare("myers_sweep planes", planes, pl)
        werr = compare("myers_walk payload", payload, pp)
        sweep = cuda_ms(lambda: mk.myers_sweep(gpu.q4, gpu.t4, **geo))
        wms = cuda_ms(lambda: mk.myers_walk(planes, gpu.m, gpu.n, **geo))
        esc = int(pp[:, -1].sum())
        log(f"[kernels] myers ({cap},{W}) B={B}: byte-equal, {esc} escapes; "
            f"sweep {sweep:.3f} ms (plain CPU {sweep_plain:.1f} ms), walk "
            f"{wms:.3f} ms (plain CPU {walk_plain:.1f} ms)")
        if cap == 2560:
            nbytes = B * (cap // 2 + cap // 2) + B * cap * 2 * (W // 32) * 4
            bs, bys = bound(nbytes, B * cap * (W // 32) * OPS_MYERS_WORD)
            # the walk reads two plane words per query row it passes
            rows = int(np.asarray(m).sum())
            bw, byw = bound(8 * rows + B * (8 + cap + 2),
                            rows * OPS_WALK_STEP)
            results["myers_sweep"].update(
                max_abs_err=err, ms=sweep, plain_ms=sweep_plain,
                bound_ms=bs, bound_by=bys)
            results["myers_walk"].update(
                max_abs_err=werr, ms=wms, plain_ms=walk_plain,
                bound_ms=bw, bound_by=byw)


def phase_bench(threads):
    """Phase 3: consensus stage on the bench workload."""
    from racon_tpu_torch.kernels import LAUNCHES, reset_launches
    from racon_tpu_torch.models.polish_model import PolisherConfig
    from racon_tpu_torch.native import bindings
    from racon_tpu_torch.ops.consensus_stage import TorchConsensusStage
    from racon_tpu_torch.testing.synth import build_workload
    from racon_tpu_torch.utils.logger import Logger

    windows, true = build_workload(seed=1234)
    cfg = PolisherConfig(backend="cuda", num_threads=threads, match=5,
                         mismatch=-4, gap=-8)
    stage = TorchConsensusStage(cfg, "cuda")
    reset_launches()
    t0 = time.perf_counter()
    with contextlib.redirect_stderr(io.StringIO()):
        cons, _ = stage.consensus_windows(windows, cfg, Logger())
    dt = time.perf_counter() - t0
    counts = dict(LAUNCHES)
    d = bindings.edit_distance(b"".join(cons), true.tobytes())
    prof = {k: round(v, 3) for k, v in stage.prof.items()}
    log(f"[bench] {windows.num_windows} windows in {dt:.3f} s = "
        f"{windows.num_windows / dt:.2f} windows/s (one pass of a fresh "
        f"process: includes first-launch costs); launches {counts}; "
        f"stage {prof}; edit distance to truth {d}")
    if d != 91:
        raise SmokeFailure(f"bench workload edit distance {d} != 91")
    if not (counts["nw_sweep"] and counts["rle_walk"]):
        raise SmokeFailure(f"consensus kernels not launched: {counts}")


def _polish_cli(tag, wd, argv):
    """The CLI's own argument path (raconx-torch ...), then
    create_polisher -> initialize -> polish with the counts reset just
    before. Returns (polisher, polished contigs, launches, seconds)."""
    from racon_tpu_torch import cli
    from racon_tpu_torch.kernels import LAUNCHES, reset_launches
    from racon_tpu_torch.polisher import create_polisher

    args = cli.parser().parse_args(
        [*argv, *(os.path.join(wd, f) for f in
                  ("reads.fasta", "ovl.paf", "draft.fasta"))])
    cfg = cli.make_config(args)
    reset_launches()
    t0 = time.perf_counter()
    with contextlib.redirect_stderr(io.StringIO()):
        p = create_polisher(*args.inputs, cfg)
        p.initialize()
        t1 = time.perf_counter()
        out = p.polish(drop_unpolished_sequences=True)
    t2 = time.perf_counter()
    counts = dict(LAUNCHES)
    n_win = p.windows.num_windows
    a = p.align_stage.stats
    c = p.consensus_stage.prof
    c_total = c["device_items"] + c["host_items"] - c["escaped_items"]
    log(f"[{tag}] initialize {t1 - t0:.3f} s, polish {t2 - t1:.3f} s, "
        f"{n_win} windows = {n_win / (t2 - t1):.2f} windows/s; launches "
        f"{counts}")
    log(f"[{tag}] host realign: align {a['host_items']}/{a['items']} "
        f"overlaps ({100 * a['host_items'] / max(1, a['items']):.3f}%), "
        f"consensus {int(c['host_items'])}/{int(c_total)} item-passes "
        f"({100 * c['host_items'] / max(1, c_total):.3f}%), of which "
        f"{int(c['escaped_items'])} band escapes")
    if len(out) != 1:
        raise SmokeFailure(f"{tag}: expected one polished contig, got "
                           f"{len(out)}")
    return p, out, counts


def _identity(tag, what, seq, true):
    from racon_tpu_torch.native import bindings

    t0 = time.perf_counter()
    d = bindings.edit_distance(seq, true.tobytes())
    ident = 100.0 * (1.0 - d / len(true))
    log(f"[{tag}] {what}: {len(seq)} bp against {len(true)} bp of truth, "
        f"edit distance {d} -> identity {ident:.4f}% "
        f"({time.perf_counter() - t0:.1f} s to compute)")
    return ident


def phase_polish(genome_mb, threads, results):
    """Phase 4: the default polish path end to end at genome scale."""
    from racon_tpu_torch.testing.synth import make_dataset

    with tempfile.TemporaryDirectory() as wd:
        t0 = time.perf_counter()
        true = make_dataset(wd, int(genome_mb * 1e6), 8000, 20, 0.12,
                            seed=11)
        log(f"[polish] dataset {genome_mb} Mb, 20x 8 kb reads, 12% error, "
            f"seed 11: made in {time.perf_counter() - t0:.1f} s")
        _, out, counts = _polish_cli("polish", wd, [
            "--backend", "cuda", "-m", "5", "-x", "-4", "-g", "-8", "-t",
            str(threads)])
    ident = _identity("polish", "polished", out[0][1], true)
    if ident < 99.99:
        raise SmokeFailure(f"identity {ident:.4f}% < 99.99%")
    mine = ("nw_sweep", "rle_walk", "myers_sweep", "myers_walk")
    missing = [k for k in mine if counts[k] == 0]
    if missing:
        raise SmokeFailure(f"kernels never launched on the default path: "
                           f"{missing}")
    for k in mine:
        results[k]["launches"] = counts[k]


def phase_wide(genome_mb, threads, results):
    """Phase 5: the wide-band slice (-w 10000) end to end."""
    from racon_tpu_torch.testing.synth import make_dataset

    with tempfile.TemporaryDirectory() as wd:
        t0 = time.perf_counter()
        true = make_dataset(wd, int(genome_mb * 1e6), 20000, 20, 0.12,
                            seed=11, mix=(0.2, 0.5, 0.3))
        with open(os.path.join(wd, "draft.fasta"), "rb") as f:
            draft = f.read().split(b"\n")[1]
        log(f"[wide] dataset {genome_mb} Mb, 20x 20 kb reads, 12% error "
            f"(ins/del/sub 0.2/0.5/0.3), seed 11: made in "
            f"{time.perf_counter() - t0:.1f} s")
        p, out, counts = _polish_cli("wide", wd, [
            "--backend", "cuda", "-w", "10000", "-m", "5", "-x", "-4",
            "-g", "-8", "-t", str(threads)])
    stage = p.consensus_stage
    for k, tiers in enumerate(stage.tier_items):
        shown = ", ".join(f"{t}: {c}" for t, c in sorted(
            tiers.items(), key=lambda tc: (tc[0] == -1, tc[0])))
        log(f"[wide] pass {k + 1} items per tier: {shown} (-1 = host)")
    wide_host = int(stage.prof["wide_host_items"])
    log(f"[wide] wide_host_items {wide_host}; prof "
        f"{ {k: round(v, 3) for k, v in stage.prof.items()} }")
    before = _identity("wide", "draft", draft, true)
    after = _identity("wide", "polished", out[0][1], true)
    if not (counts["nw_sweep_wide"] and counts["packed_walk"]):
        raise SmokeFailure(f"wide kernels never launched: {counts}")
    if wide_host:
        raise SmokeFailure(f"{wide_host} items went to the host for want "
                           "of a band")
    if not after > before:
        raise SmokeFailure(f"polished identity {after:.4f}% does not beat "
                           f"the draft's {before:.4f}%")
    for k in ("nw_sweep_wide", "packed_walk"):
        results[k]["launches"] = counts[k]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--genome-mb", type=float, default=4.6,
                    help="genome size of phase 4 (default 4.6)")
    ap.add_argument("--wide-genome-mb", type=float, default=1.0,
                    help="genome size of phase 5 (default 1.0)")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        sys.stderr.write("chip_smoke: no CUDA device\n")
        return 2
    sys.path.insert(0, ROOT)
    from racon_tpu_torch.kernels import build

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(smi)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}")
    build.kernels()
    log(f"[build] kernels built and loaded in {build.build_seconds:.1f} s")
    threads = os.cpu_count() or 8
    results = {k: {"name": k, "route": "cuda", "source": src,
                   "replaces": rep, "launches": 0, "max_abs_err": None,
                   "ms": None, "plain_ms": None, "bound_ms": None,
                   "bound_by": None, "library_ms": None}
               for k, (src, rep) in KERNELS.items()}
    t0 = time.perf_counter()
    try:
        for phase in (lambda: phase_kernels(results),
                      lambda: phase_bench(threads),
                      lambda: phase_polish(args.genome_mb, threads, results),
                      lambda: phase_wide(args.wide_genome_mb, threads,
                                         results)):
            phase()
            log(f"[time] {time.perf_counter() - t0:.1f} s since the build")
    except SmokeFailure as e:
        sys.stderr.write(f"chip_smoke: FAILED: {e}\n")
        return 1
    print(json.dumps({"kernels": list(results.values())}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

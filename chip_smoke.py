#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--genome-mb 4.6]

Phases (each must pass, or the script exits non-zero):
  1. the card's name and power limit, the torch/CUDA versions, and the
     build of the four kernels from racon_tpu_torch/kernels/csrc;
  2. each kernel against its plain PyTorch version (on the host CPU) at the
     main path's shapes, byte for byte, with CUDA-event times;
  3. the consensus stage on the bench workload (bench.build_workload,
     2048 windows of 500 bp, 12% error, match 5 / mismatch -4 / gap -8):
     edit distance to the truth must be exactly 91;
  4. the polish path end to end (the CLI's arguments `--backend cuda -m 5
     -x -4 -g -8 -t <cores>`, then create_polisher -> initialize ->
     polish) on the synthetic E. coli-scale dataset of
     benchmarks/genome_scale.py (4.6 Mb, 20x 8 kb reads, 12% error,
     seed 11): identity to the truth must be >= 99.99%, and all four
     kernels must have launched during this run.
Prints one JSON line of per-kernel results, then the result line. Without
a CUDA device it exits 2 and prints no result. The package never imports
jax; this script makes sure of it by blocking the import.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

sys.modules["jax"] = None  # any import of jax from here on fails

ROOT = os.path.dirname(os.path.abspath(__file__))
KERNELS = {  # name -> (source, TPU kernel it replaces)
    "nw_sweep": ("racon_tpu_torch/kernels/csrc/nw_sweep.cu",
                 "racon_tpu/ops/nw_kernel.py:913"),
    "rle_walk": ("racon_tpu_torch/kernels/csrc/rle_walk.cu",
                 "racon_tpu/ops/nw_kernel.py:1242"),
    "myers_sweep": ("racon_tpu_torch/kernels/csrc/myers_sweep.cu",
                    "racon_tpu/ops/myers_kernel.py:500"),
    "myers_walk": ("racon_tpu_torch/kernels/csrc/myers_walk.cu",
                   "racon_tpu/ops/myers_kernel.py:591"),
}


class SmokeFailure(RuntimeError):
    pass


def log(msg: str) -> None:
    print(msg, flush=True)


def make_items(rng, B, cap, w_band, gap):
    """Packed batch of B items at cap: mutated read pairs (4% each of
    substitutions, insertions, deletions), every 7th item all PAD, every
    11th cut short so its drift leaves the band, 30% free deletion
    columns."""
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


def phase_kernels(results):
    """Phase 2: each kernel vs its plain version at main-path shapes."""
    import numpy as np

    from racon_tpu_torch.ops import myers_kernel as mk
    from racon_tpu_torch.ops import nw_kernel as nk
    from racon_tpu_torch.ops.batch import to_device

    rng = np.random.default_rng(2024)
    sc = dict(match=5, mismatch=-4, gap=-8)
    for cap, W, B in ((640, 128, 4096), (5120, 1024, 8)):
        geo = dict(m_cap=cap, n_cap=cap, w_band=W)
        q4, t4, dcb, m, n = make_items(rng, B, cap, W, -8)
        gpu = to_device(q4, t4, dcb, m, n, m_cap=cap, n_cap=cap,
                        device="cuda")
        cpu = to_device(q4, t4, dcb, m, n, m_cap=cap, n_cap=cap,
                        device="cpu")
        moves, score = nk.nw_sweep(gpu.q4, gpu.t4, gpu.dcb, **geo, **sc)
        payload = nk.rle_walk(moves, gpu.m, gpu.n, **geo)
        (pm, ps), sweep_plain = host_ms(lambda: nk.nw_sweep_plain(
            cpu.q4, cpu.t4, cpu.dcb, **geo, **sc))
        pp, walk_plain = host_ms(lambda: nk.rle_walk_plain(
            pm, cpu.m, cpu.n, **geo))
        err = max(compare("nw_sweep moves", moves, pm),
                  compare("nw_sweep score", score, ps))
        werr = compare("rle_walk payload", payload, pp)
        sweep = cuda_ms(lambda: nk.nw_sweep(gpu.q4, gpu.t4, gpu.dcb, **geo,
                                            **sc))
        walk = cuda_ms(lambda: nk.rle_walk(moves, gpu.m, gpu.n, **geo))
        esc = int(pp[:, -1].sum())
        log(f"[kernels] sweep+rle ({cap},{W}) B={B}: byte-equal, "
            f"{esc} escapes; sweep {sweep:.3f} ms (plain CPU "
            f"{sweep_plain:.1f} ms), walk {walk:.3f} ms (plain CPU "
            f"{walk_plain:.1f} ms)")
        if cap == 640:
            results["nw_sweep"].update(max_abs_err=err, ms=sweep,
                                       plain_ms=sweep_plain)
            results["rle_walk"].update(max_abs_err=werr, ms=walk,
                                       plain_ms=walk_plain)
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
        walk = cuda_ms(lambda: mk.myers_walk(planes, gpu.m, gpu.n, **geo))
        esc = int(pp[:, -1].sum())
        log(f"[kernels] myers ({cap},{W}) B={B}: byte-equal, {esc} escapes; "
            f"sweep {sweep:.3f} ms (plain CPU {sweep_plain:.1f} ms), walk "
            f"{walk:.3f} ms (plain CPU {walk_plain:.1f} ms)")
        if cap == 2560:
            results["myers_sweep"].update(max_abs_err=err, ms=sweep,
                                          plain_ms=sweep_plain)
            results["myers_walk"].update(max_abs_err=werr, ms=walk,
                                         plain_ms=walk_plain)


def phase_bench(threads):
    """Phase 3: consensus stage on the bench workload."""
    import contextlib
    import io

    import bench
    from racon_tpu.models.polish_model import PolisherConfig
    from racon_tpu.native import bindings
    from racon_tpu.utils.logger import Logger
    from racon_tpu_torch.kernels import LAUNCHES, reset_launches
    from racon_tpu_torch.ops.consensus_stage import TorchConsensusStage

    windows, true = bench.build_workload(seed=1234)
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


def phase_polish(genome_mb, threads, results):
    """Phase 4: the polish path end to end on the genome-scale dataset."""
    import contextlib
    import io

    from benchmarks.genome_scale import make_dataset
    from racon_tpu.native import bindings
    from racon_tpu_torch import cli
    from racon_tpu_torch.kernels import LAUNCHES, reset_launches
    from racon_tpu_torch.polisher import create_polisher

    with tempfile.TemporaryDirectory() as wd:
        t0 = time.perf_counter()
        true = make_dataset(wd, int(genome_mb * 1e6), 8000, 20, 0.12,
                            seed=11)
        log(f"[polish] dataset {genome_mb} Mb, 20x 8 kb reads, 12% error, "
            f"seed 11: made in {time.perf_counter() - t0:.1f} s")
        # the CLI's own argument path: raconx-torch --backend cuda -m 5 ...
        args = cli.parser().parse_args([
            "--backend", "cuda", "-m", "5", "-x", "-4", "-g", "-8", "-t",
            str(threads), *(os.path.join(wd, f) for f in
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
    log(f"[polish] initialize {t1 - t0:.3f} s, polish {t2 - t1:.3f} s, "
        f"{n_win} windows = {n_win / (t2 - t1):.2f} windows/s; launches "
        f"{counts}")
    log(f"[polish] host realign: align {a['host_items']}/{a['items']} "
        f"overlaps ({100 * a['host_items'] / max(1, a['items']):.3f}%), "
        f"consensus {int(c['host_items'])}/{int(c_total)} item-passes "
        f"({100 * c['host_items'] / max(1, c_total):.3f}%)")
    if len(out) != 1:
        raise SmokeFailure(f"expected one polished contig, got {len(out)}")
    t0 = time.perf_counter()
    d = bindings.edit_distance(out[0][1], true.tobytes())
    ident = 100.0 * (1.0 - d / len(true))
    log(f"[polish] edit distance to truth {d} -> identity {ident:.4f}% "
        f"({time.perf_counter() - t0:.1f} s to compute)")
    if ident < 99.99:
        raise SmokeFailure(f"identity {ident:.4f}% < 99.99%")
    missing = [k for k, v in counts.items() if v == 0]
    if missing:
        raise SmokeFailure(f"kernels never launched on the main path: "
                           f"{missing}")
    for k, v in counts.items():
        results[k]["launches"] = v


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--genome-mb", type=float, default=4.6,
                    help="genome size of phase 4 (default 4.6)")
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
                   "replaces": rep, "launches": 0}
               for k, (src, rep) in KERNELS.items()}
    try:
        phase_kernels(results)
        phase_bench(threads)
        phase_polish(args.genome_mb, threads, results)
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

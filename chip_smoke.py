#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--genome-mb 4.6] [--wide-genome-mb 1.0]

Phases (each must pass, or the script exits non-zero):
  1. the card's name and power limit, the torch/CUDA versions, the build
     of the kernels from racon_tpu_torch/kernels/csrc, and ptxas's
     register and spill counts of the sweep (warp and strip kernels), its
     int16 form (nw_sweep16.cu), the rows and packed2 walks, the panel
     sweep's five instantiations and the Myers walk (a separate `nvcc
     -Xptxas -v` compile of their sources, run beside the build);
  2. each kernel against its plain PyTorch version (on the host CPU) at the
     main paths' shapes, byte for byte, with CUDA-event times: the sweep,
     RLE walk and rows walk at (640,128) and (5120,1024) (with the two
     walks' payload bytes and host decode times), the Myers sweep and walk
     at (2560,512) B = 1024, (10240,1024) B = 8 and there at the align
     stage's former chunk (409 items) and its chunk now (1024; each with
     8 items spread over the launch, an escape, an all-PAD item and the
     last checked; the sweep's us an item and share of its bound), the
     RLE walk at (640,128) B = 4097, the wide sweep and packed2 walk at
     (10240,2048) and (10240,4096), the times of one chunk at
     (10240,2048) and (40960,4096) (the packed2 walk held against its
     plain version on a spread of the chunk's items), the align stage's
     scored route at (10240,1024): sweep, RLE and rows walk at 0/-1/-1
     with unit deletion costs, the block sweep at the stages' chunks
     (10240,1024) B = 409 (align scores) and (5120,1024) B = 819 (item 0
     of each checked) and the rows walk at the first (a spread of its
     items checked), with us a query row and the per-SM floor at every
     strip-sweep shape, the longest walk's steps or rows and us a step
     (row) of it at every packed2 and rows walk shape, and the warp
     sweep's other tiers (256,128) B = 4097
     and (1280,256) B = 1024 with the RLE walk; then under
     RACON_TPU_DP16=1 the int16 sweeps (K1-16 at (640,128) B = 4096 and
     (256,128) B = 4097; K2-16, the int16 strip kernel, at (2560,512) B =
     1024 and (5120,1024) B = 8 with the align scores and (640,288) B =
     37, its last strip cut, with the consensus scores) against the int32
     kernels on every item and their plain versions, timed in turns with
     them;
  3. the consensus stage on the bench workload (testing.synth
     build_workload, 2048 windows of 500 bp, 12% error, match 5 /
     mismatch -4 / gap -8), four times: the default RLE walk, then
     RACON_TPU_WALK=rows, then the default under RACON_TPU_DP16=1, then
     once with RACON_TPU_COHORTS=1; edit
     distance to the truth must be exactly 91 each time, the rows runs
     must launch the rows walk and not the RLE walk, the int16 run the
     int16 sweep, and every run but the last must run 3 cohorts;
  4. the default polish path end to end (the CLI's arguments `--backend
     cuda -m 5 -x -4 -g -8 -t <cores>`, then create_polisher ->
     initialize -> polish) on testing.synth.make_dataset (4.6 Mb, 20x 8 kb
     reads, 12% error, seed 11; the peak device memory of initialize()
     and the polished contig's sha256 are printed): identity to the truth
     must be >= 99.99%, and the warp sweep, RLE walk and both Myers
     kernels must have launched; then the same under RACON_TPU_DP16=1,
     whose FASTA must be byte-equal and which must launch the int16
     sweep; then once more with RACON_TPU_COHORTS=1; each run's wall
     times and the consensus stage's split (dispatch, fetch wait, decode,
     poa_round, host_fallback), 3 cohorts by default, the FASTA
     byte-equal to the first; then initialize and polish once more, each
     under torch.profiler, by default and with RACON_TPU_DP16=1: device
     busy, the share of it inside the host's
     decode / merge / realign spans and inside its dispatch spans, time
     per kernel, and no H2D copy
     from pageable memory; then `raconx-torch --profile <dir>` in a
     process of its own on a 50 kb dataset: the trace must name the warp
     sweep and the Myers sweep, and the FASTA must be the run's without
     the flag;
  5. the wide-band slice end to end: the same path with `-w 10000` on
     make_dataset(1 Mb, 20x 20 kb reads, 12% error split (0.2, 0.5, 0.3)
     between insertions, deletions and substitutions, seed 11): the wide
     sweep and the packed walk must have launched, no item may go to the
     host for want of a band (wide_host_items 0), and the polished contig
     must be closer to the truth than the draft. 1 Mb, not 4.6: at 4.6 Mb
     this phase alone takes about 460 s, most of it the host realigning
     band escapes; not 0.5 either: there the contig's thinly covered ends,
     trimmed, cost more than the polish gains (98.8446 % against the
     draft's 99.1708 % on an NVIDIA H100 80GB HBM3);
  6. the scored align route: create_polisher -> initialize on the
     datasets of phases 4 and 5 and a 0.5 Mb one of 2 kb reads, by
     default (Myers) and under RACON_TPU_MYERS=0 RACON_TPU_WALK=rows, the
     two w = 500 datasets once more with RACON_TPU_DP16=1; the scored runs
     must launch the sweep and the rows walk (phase 4's 8 kb overlaps,
     W <= 1024 tiers), the wide sweep and the packed walk (phase 5's
     drifting 20 kb overlaps, W = 4096), and under RACON_TPU_DP16=1 the
     int16 strip sweep (the 2 kb reads' (2560,512) tier); no overlap may
     go to the host in any run, and every overlap's breaking points must
     equal the Myers run's;
  7. the ablation harness (racon_tpu_torch.benchmarks.profile_ablate) at
     the JAX harness's default (B 8192, cap 640, W 128; its own data, seed
     0): every line's ms, each panel-sweep variant's bound; then K7
     (nw_sweep_t) and each K8 variant (nw_ablate) byte for byte against
     its plain version on the first 256 items (nomoves: the score only),
     K7 against K1 (nw_sweep) on the same items packed, and the fused
     line's payload against the walk-only line's;
  8. (run right after phase 4, on its dataset) the multi-device path on
     the one card: parallel/mesh.sharded_align_walk on the mesh (cuda:0,
     cuda:0) at (640,128) B = 4097 (rle) and (10240,1024) B = 1023
     (myers), every item byte-equal to the unsharded launch, both timed;
     then the mesh pinned in this process (mesh.set_active_mesh): the
     bench workload (91) and phase 4's polish (FASTA byte-equal, every
     fused dispatch in two shards on cuda:0, K1, J1, K3 and K4 launched,
     device busy under torch.profiler); then two processes under
     `torch.distributed.run --standalone --nproc-per-node 2` running
     racon_tpu_torch.testing.dist_polish on phase 4's dataset (both
     ranks in a world of 2 on cuda:0, each aligning and polishing a share
     and launching K1, J1, K3 and K4; rank 0's FASTA byte-equal to phase
     4's) and `-m racon_tpu_torch.cli --distributed` on the 50 kb
     dataset (stdout exactly the single-process CLI's FASTA). Its
     launches go under `launches_by_path` "bench_mesh2", "mesh2" and
     "dist2".
  9. racon's other modes (after phase 7): the Myers sweep and walk at the
     kF tier (40960,1024) at the align stage's chunk there (409 items; 8
     spread over the launch, an escape, an all-PAD item and the last
     checked against the plain versions, with CUDA-event times and the
     share of each bound); fragment correction (racon -f) through
     racon_tpu_torch.benchmarks.genome_scale --mode kf on
     make_dataset(KF_GENOME_MB, 20x 30 kb reads, 12% error, ava=True),
     --backend cuda, then --backend native on the same data (K3, K4, K1
     and J1 launched; no overlap above the kF tier or on the host for want
     of a tier; corrected identity >= raw + 5 points and no more than
     0.05 below native's); on make_cigar_dataset (50 kb, 20x 2 kb reads,
     12% error) SAM overlaps with CIGARs (K1 and J1, no Myers kernel, no
     item to the align stage) and FASTQ reads with MHAP overlaps under -q
     10 (K3, K4, K1, J1), each polished on the card and on the plain
     versions (device="cpu"), FASTA byte-equal and closer to the truth
     than the draft; then `raconx-torch-tools wrapper --split` on a
     0.2 Mb make_dataset cut into two targets: its stdout equal to the
     CLI's FASTA on each split, its work directory removed. Its launches
     go under "kf", "sam", "mhap_fastq" and "wrapper".
 10. (run right after phase 8, on phase 4's dataset) the gather route
     (RACON_TPU_DEVGATHER=1, J6) and the Myers "rle" payload (J5): the
     gather kernel against its plain version and the host packers at
     (640,128) B = 4096, (256,128) B = 4097 and (5120,1024) B = 8 (odd
     starts, clear deletion-cost bits, all-PAD items), with CUDA-event
     times, its time in a CUDA graph beside the empty kernel of its grid
     (the floor of a launch) and the share of its bound, also of the time
     above the floor; the bench workload under the
     gather route (91, phase 3's consensus, 3 cohorts, no host row packer
     called); phase 4's polish under it (the FASTA byte-equal, no host row
     packer called in polish(), the stage split beside phase 4's, the blob
     and meta H2D bytes, the peak device memory, device busy profiled);
     the bench on the mesh (cuda:0, cuda:0) under it (91, every dispatch
     in two shards); then align_walk_myers_padded(fmt="rle") at the align
     chunks of (10240,1024) and (40960,1024) (its peak device memory), J5
     and J1 there against their plain versions on 8 items spread over the
     launch, the rle op lists against the rows route's on every item that
     neither escapes, payload bytes an item on both routes and the ms of
     K3, J5 and J1. Its launches go under "gather_bench",
     "gather_polish", "gather_mesh2" and "myers_rle".
Prints one JSON line of per-kernel results (the contract's keys, then
every shape phase 2 measured under `shapes` and each run's launches
under `launches_by_path`), the card's name and power limit, then the
result line. Without a CUDA device it exits 2 and prints
no result. The port imports neither jax nor racon_tpu; this script makes
sure of it by blocking both imports.
"""

from __future__ import annotations

import argparse
import contextlib
import hashlib
import io
import json
import os
import signal
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
    "nw_sweep_block": (CSRC + "nw_sweep.cu",
                       "racon_tpu/ops/nw_kernel.py:1073"),
    "rle_walk": (CSRC + "rle_walk.cu", "racon_tpu/ops/nw_kernel.py:1242"),
    "myers_sweep": (CSRC + "myers_sweep.cu",
                    "racon_tpu/ops/myers_kernel.py:500"),
    "myers_walk": (CSRC + "myers_walk.cu",
                   "racon_tpu/ops/myers_kernel.py:591"),
    "nw_sweep_wide": (CSRC + "nw_sweep.cu",
                      "racon_tpu/ops/nw_kernel.py:186"),
    "packed_walk": (CSRC + "packed_walk.cu",
                    "racon_tpu/ops/nw_kernel.py:1803"),
    "rows_walk": (CSRC + "rows_walk.cu", "racon_tpu/ops/nw_kernel.py:1990"),
    "nw_sweep_t": (CSRC + "nw_sweep_t.cu", "racon_tpu/ops/nw_kernel.py:737"),
    "nw_ablate": (CSRC + "nw_sweep_t.cu", "benchmarks/profile_ablate.py:121"),
    # the int16 forms (RACON_TPU_DP16=1) of K1 and K2
    "nw_sweep16": (CSRC + "nw_sweep16.cu", "racon_tpu/ops/nw_kernel.py:913"),
    "nw_sweep_block16": (CSRC + "nw_sweep16.cu",
                         "racon_tpu/ops/nw_kernel.py:1073"),
    # the gather route's row gather (J6) and the Myers plane-to-move
    # transform (J5)
    "pack_gather": (CSRC + "pack_gather.cu",
                    "racon_tpu/ops/nw_kernel.py:1476"),
    "myers_moves": (CSRC + "myers_moves.cu",
                    "racon_tpu/ops/myers_kernel.py:655"),
}
# the kernels of the main path (-w 500: K1, J1, K3, K4)
MAIN_KERNELS = ("nw_sweep", "rle_walk", "myers_sweep", "myers_walk")
# sources whose ptxas report (registers, spills) phase 1 prints
PTXAS_SOURCES = ("nw_sweep.cu", "nw_sweep16.cu", "rows_walk.cu",
                 "packed_walk.cu", "nw_sweep_t.cu", "myers_walk.cu",
                 "myers_sweep.cu", "rle_walk.cu", "pack_gather.cu",
                 "myers_moves.cu")

# Least-time model of one H100 SXM: 3.35 TB/s of HBM (NVIDIA data sheet)
# and 16.73 Tops/s of INT32 (132 SMs x 64 INT32 lanes x 1.98 GHz boost:
# half the FP32 lanes behind the data sheet's 67 TFLOP/s). Integer work
# per unit, counted from each recurrence: a scored-sweep cell 15 ops
# (substitution 5, diag/up/max 3, gc 3, scan max 1, moves 3), a Myers
# 32-cell word 20 ops, a walk step or row 12 ops, a move word of the
# plane-to-move transform 40 ops (a 32 x 32 bit transpose 25 a word, the
# codes 5, the band and row mask 10), a gathered output word 10 ops.
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 132 * 64 * 1.98e9
OPS_SWEEP_CELL = 15
OPS_MYERS_WORD = 20
OPS_WALK_STEP = 12
OPS_MOVES_WORD = 40
OPS_GATHER_WORD = 10
CELLS_PER_OP16 = 2   # the int16 sweeps: two cells per 16x2 instruction
PTXAS = {}           # kernel (with its template arguments) -> registers


class SmokeFailure(RuntimeError):
    pass


def log(msg: str) -> None:
    print(msg, flush=True)


def record_launches(results, path, counts):
    """Each kernel's launches in one main-path run (counts reset just
    before it), under the run's name in its `launches_by_path`."""
    for k, c in counts.items():
        if c:
            results[k]["launches_by_path"][path] = c


def bound(nbytes: float, nops: float) -> tuple[float, str]:
    """(least ms the card could take, what bounds it)."""
    tb = 1e3 * nbytes / HBM_BYTES_PER_S
    to = 1e3 * nops / INT32_OPS_PER_S
    return (tb, "bytes") if tb >= to else (to, "operations")


def start_ptxas(tmp):
    """One `nvcc -Xptxas -v` compile per source of PTXAS_SOURCES, all
    started at once (the kernels' own build does not keep ptxas's
    report). Returns {source: process}."""
    from torch.utils.cpp_extension import CUDA_HOME

    from racon_tpu_torch.kernels.build import ARCH_FLAGS, CSRC as csrc

    nvcc = os.path.join(CUDA_HOME or "/usr/local/cuda", "bin", "nvcc")
    return {src: subprocess.Popen(
        [nvcc, *ARCH_FLAGS, "-std=c++17", "-O3", "-Xptxas", "-v", "-c",
         "-o", os.path.join(tmp, src + ".o"), os.path.join(csrc, src)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for src in PTXAS_SOURCES}


def kernel_name(mangled: str) -> str:
    """name<template arguments> of the kernel in a mangled symbol: its
    length-prefixed identifier that ends in "_kernel" (the hashes of an
    anonymous namespace hold digits too, so the length decides)."""
    import re

    for m in re.finditer(r"(?=(\d{1,3})([A-Za-z_]\w*))", mangled):
        n, ident = int(m.group(1)), m.group(2)
        if len(ident) >= n and ident[:n].endswith("_kernel"):
            t = re.match(r"I((?:L[a-z]\d+E)+)E", ident[n:])
            args = re.findall(r"L[a-z](\d+)E", t.group(1)) if t else []
            return ident[:n] + (f"<{','.join(args)}>" if args else "")
    return mangled


def ptxas_report(procs):
    """Registers, stack frame and spill bytes per kernel, from the output
    of start_ptxas's compiles."""
    import re

    for src, proc in procs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            raise SmokeFailure(f"nvcc -Xptxas -v {src} failed:\n{out}")
        name = None
        for line in out.splitlines():
            m = re.search(r"Compiling entry function '(\w+)'", line)
            if m:
                name = kernel_name(m.group(1))
                continue
            m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill "
                          r"stores, (\d+) bytes spill loads", line)
            if m and name:
                frame = m.groups()
                continue
            m = re.search(r"Used (\d+) registers", line)
            if m and name:
                PTXAS[name] = dict(registers=int(m.group(1)),
                                   stack_frame=int(frame[0]),
                                   spill_stores=int(frame[1]),
                                   spill_loads=int(frame[2]))
                log(f"[ptxas] {src} {name}: {m.group(1)} registers, "
                    f"{frame[0]} bytes stack frame, {frame[1]} bytes spill "
                    f"stores, {frame[2]} bytes spill loads")
                name = None


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


def _walk_steps_taken(payload):
    """Move words the RLE walk had to read for this payload: one per event
    pair up to the last event."""
    import numpy as np

    body = payload.numpy()[:, :-1]
    nz = body != 0
    last = np.where(nz.any(1), body.shape[1] - np.argmax(nz[:, ::-1], 1), 0)
    return int(((last + 1) // 2).sum())


def _sweep_bound(B, cap, W):
    nbytes = B * (cap // 2 + cap // 2 + cap // 8) + B * (cap // 16 * W * 4
                                                          + 4)
    return bound(nbytes, B * cap * W * OPS_SWEEP_CELL)


def _sweep16_bound(B, cap, W):
    """The int16 sweep's least time: the same bytes, two cells per 16x2
    instruction at the INT32 rate (the rate simd16_rate measures)."""
    nbytes = B * (cap // 2 + cap // 2 + cap // 8) + B * (cap // 16 * W * 4
                                                          + 4)
    return bound(nbytes, B * cap * W * OPS_SWEEP_CELL / CELLS_PER_OP16)


@contextlib.contextmanager
def setenv(key, value):
    """os.environ[key] = value for the block (None: unset), as it was
    after."""
    old = os.environ.pop(key, None)
    if value is not None:
        os.environ[key] = value
    try:
        yield
    finally:
        os.environ.pop(key, None)
        if old is not None:
            os.environ[key] = old


def dp16(on):
    """RACON_TPU_DP16 set to 1 (on) or unset (off) for the block."""
    return setenv("RACON_TPU_DP16", "1" if on else None)


def _walk_bound(B, cap, W, width, steps):
    nbytes = 4 * steps + B * (8 + width)
    return bound(nbytes, steps * OPS_WALK_STEP)


def _rows_bound(payload, m, n, cap, W):
    """(rows walked, least ms, what bounds it) of the rows walk on this
    payload. Bytes: m and n, the payload, and each distinct move word
    (16 rows of one lane) the walk's path needs (ops/walk_work.rows_path).
    12 operations per row walked (counted as the Myers walk's)."""
    from racon_tpu_torch.ops.walk_work import rows_path

    rows, nwords = rows_path(payload, m, n, cap, W)
    return (rows, *bound(4 * nwords + payload.shape[0] * (8 + cap + 2),
                         rows * OPS_WALK_STEP))


def _packed_bound(payload, m, n, cap, W):
    """(steps, least ms, what bounds it) of the packed2 walk on this
    payload. Bytes: m and n, the payload, and each distinct move word the
    walk's path reads (ops/walk_work.packed_path). 12 operations a step."""
    from racon_tpu_torch.ops.walk_work import packed_path

    steps, nwords = packed_path(payload, m, n, cap, W)
    B, width = payload.shape
    return (steps, *bound(4 * nwords + B * (8 + width),
                          steps * OPS_WALK_STEP))


def _longest(name, payload, m, ms):
    """The longest walk of a packed2 or rows payload (CPU): its steps or
    rows, and the kernel's us a step (row) of it. One warp walks an item,
    so that walk's chain sets the kernel's time."""
    from racon_tpu_torch.ops.walk_work import walk_units

    units = walk_units(payload, name, m)
    longest = int(units.max()) if len(units) else 0
    key = "steps" if name == "packed_walk" else "rows"
    return {f"longest_{key}": longest,
            f"us_per_{key[:-1]}_of_longest": 1e3 * ms / max(longest, 1)}


def _longest_note(longest):
    (k1, n), (k2, us) = longest.items()
    unit = k1.split("_")[1][:-1]
    return f"; the longest walk {n} {unit}s, {us:.5f} us a {unit}"


def _decode_ms(fmt, payload, cap, W, m, n, threads):
    """Host ms of the port's native decoder on one walk payload (all
    items, escaped ones included, as the stages decode): the best of
    three calls."""
    import numpy as np

    from racon_tpu_torch.ops.nw_kernel import payload_decoder

    m = np.asarray(m, np.int64)
    n = np.asarray(n, np.int64)
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        decode, codes, budget = payload_decoder(fmt, payload, cap, W)
        decode(codes, budget, m, n, threads)
        best = min(best, time.perf_counter() - t0)
    return 1e3 * best


def record_shape(results, name, cap, W, B, scores, **numbers):
    """One measured shape of a kernel; the first of each kernel also fills
    its contract keys."""
    results[name]["shapes"].append(dict(shape=[cap, W, B], scores=scores,
                                        **numbers))
    if results[name]["ms"] is None:
        results[name].update(numbers)


def myers_shape(results, cap, W, B, rng, sample, tag="", main=False):
    """Both Myers kernels at one shape; every item (sample None) or
    `sample` items spread over the launch, with item 3 (out of the
    band), item 6 (all PAD) and the last, against the plain
    versions, every word of their planes. `main`: the main path's
    shape, whose numbers fill the contract keys."""
    import numpy as np
    import torch

    from racon_tpu_torch.ops import myers_kernel as mk
    from racon_tpu_torch.ops.batch import to_device
    from racon_tpu_torch.ops.geometry import (myers_sweep_launch,
                                              myers_walk_launch)

    geo = dict(m_cap=cap, n_cap=cap, w_band=W)
    q4, t4, _, m, n = make_items(rng, B, cap, W, -1)
    gpu = to_device(q4, t4, None, m, n, m_cap=cap, n_cap=cap,
                    device="cuda")
    idx = np.arange(B) if sample is None else np.unique(np.r_[
        np.linspace(0, B - 1, sample).astype(int), 3, 6, B - 1])
    cpu = to_device(q4[idx], t4[idx], None, m[idx], n[idx], m_cap=cap,
                    n_cap=cap, device="cpu")
    sel = torch.from_numpy(idx).cuda()
    planes = mk.myers_sweep(gpu.q4, gpu.t4, **geo)
    payload = mk.myers_walk(planes, gpu.m, gpu.n, **geo)
    pl, sweep_plain = host_ms(lambda: mk.myers_sweep_plain(
        cpu.q4, cpu.t4, **geo))
    pp, walk_plain = host_ms(lambda: mk.myers_walk_plain(
        pl, cpu.m, cpu.n, **geo))
    err = compare("myers_sweep planes", planes[sel], pl)
    werr = compare("myers_walk payload", payload[sel], pp)
    sweep = cuda_ms(lambda: mk.myers_sweep(gpu.q4, gpu.t4, **geo))
    wms = cuda_ms(lambda: mk.myers_walk(planes, gpu.m, gpu.n, **geo))
    esc = int(payload[:, -1].sum())
    which = ("" if sample is None else
             f" (items {','.join(map(str, idx))} checked)")
    nbytes = B * (cap // 2 + cap // 2) + B * cap * 2 * (W // 32) * 4
    bs, bys = bound(nbytes, B * cap * (W // 32) * OPS_MYERS_WORD)
    log(f"[kernels] myers ({cap},{W}) B={B}{tag}: byte-equal{which}, "
        f"{esc} escapes; sweep {sweep:.3f} ms = {1e3 * sweep / B:.3f} "
        f"us an item, {100 * bs / sweep:.1f} % of its bound {bs:.3f} ms "
        f"by {bys} ({myers_sweep_launch(B, cap, W)[0]} blocks; plain "
        f"CPU {sweep_plain:.1f} ms), walk {wms:.3f} ms (plain CPU "
        f"{walk_plain:.1f} ms)")
    # the walk needs two plane words per query row it passes; reading
    # whole rows (2 W/32 words each) moves the planes once
    rows = int(np.asarray(m).sum())
    bw, byw = bound(8 * rows + B * (8 + cap + 2), rows * OPS_WALK_STEP)
    rows_ms = 1e3 * (rows * 2 * (W // 32) * 4) / HBM_BYTES_PER_S
    log(f"[kernels] myers_walk ({cap},{W}) B={B}: "
        f"{myers_walk_launch(B, W)[0]} blocks; bound {bw:.5f} ms by "
        f"{byw}, {100 * bw / wms:.2f} % of it; whole rows of both planes "
        f"{rows_ms:.3f} ms of HBM")
    for name, numbers in (
            ("myers_sweep", dict(max_abs_err=err, ms=sweep,
                                 plain_ms=sweep_plain, bound_ms=bs,
                                 bound_by=bys)),
            ("myers_walk", dict(max_abs_err=werr, ms=wms,
                                plain_ms=walk_plain, bound_ms=bw,
                                bound_by=byw))):
        if sample is not None:
            numbers["plain_items"] = idx.tolist()
        record_shape(results, name, cap, W, B, "align", **numbers)
        if main:
            results[name].update(numbers)
    results["myers_sweep"]["shapes"][-1].update(
        us_per_item=1e3 * sweep / B, bound_share=bs / sweep,
        blocks=myers_sweep_launch(B, cap, W)[0])
    results["myers_walk"]["shapes"][-1].update(
        bound_share=bw / wms, whole_rows_ms=rows_ms,
        blocks=myers_walk_launch(B, W)[0])


def _floor_numbers(B, cap, W, ms):
    """us a query row and the per-SM floor of a strip-sweep shape (none for
    the warp sweep): one item an SM, 15 ops a cell at its 64 INT32 lanes,
    an SM's items one after another (the card bound spreads the cells over
    every SM instead)."""
    if W <= 256:
        return {}
    row_us = 1e6 * OPS_SWEEP_CELL * W / (64 * 1.98e9)
    return dict(us_per_row=1e3 * ms / cap, sm_floor_us_per_row=row_us,
                sm_floor_ms=-(-B // 132) * cap * row_us / 1e3)


def _floor_note(B, cap, W, ms):
    n = _floor_numbers(B, cap, W, ms)
    if not n:
        return ""
    return (f"; {n['us_per_row']:.4f} us a row, per-SM floor "
            f"{n['sm_floor_us_per_row']:.4f} us a row = "
            f"{n['sm_floor_ms']:.4f} ms, {100 * n['sm_floor_ms'] / ms:.1f} "
            f"% of it")


def phase_kernels(results, threads):
    """Phase 2: each kernel vs its plain version at main-path shapes."""
    import numpy as np
    import torch

    from racon_tpu_torch.ops import nw_kernel as nk
    from racon_tpu_torch.native import loader
    from racon_tpu_torch.ops.align_stage import _chunk_size
    from racon_tpu_torch.ops.batch import to_device
    from racon_tpu_torch.ops.consensus_stage import chunk_size
    from racon_tpu_torch.ops.geometry import rows_walk_launch, sweep_kernel

    t0 = time.perf_counter()
    if loader.get() is None:
        raise SmokeFailure("the native runtime did not build")
    log(f"[build] native runtime built and loaded in "
        f"{time.perf_counter() - t0:.1f} s")
    rng = np.random.default_rng(2024)
    consensus = dict(match=5, mismatch=-4, gap=-8)
    align = dict(match=0, mismatch=-1, gap=-1)
    walks = {"rle": ("rle_walk", nk.rle_walk, nk.rle_walk_plain),
             "rows": ("rows_walk", nk.rows_walk, nk.rows_walk_plain),
             "packed2": ("packed_walk", nk.packed_walk,
                         nk.packed_walk_plain)}

    def shape(name, cap, W, B, sc, **numbers):
        record_shape(results, name, cap, W, B,
                     "align" if sc is align else "consensus", **numbers)

    def scored(cap, W, B, drift, fmts, rng, sc):
        """Sweep and walks at one shape against their plain versions, with
        the consensus stage's scores and deletion columns or the align
        stage's (0/-1/-1, unit deletion costs everywhere)."""
        geo = dict(m_cap=cap, n_cap=cap, w_band=W)
        sweep_name = sweep_kernel(W)
        q4, t4, dcb, m, n = make_items(rng, B, cap, W, sc["gap"], drift)
        if sc is align:
            dcb[:] = 0xFF
        gpu = to_device(q4, t4, dcb, m, n, m_cap=cap, n_cap=cap,
                        device="cuda")
        cpu = to_device(q4, t4, dcb, m, n, m_cap=cap, n_cap=cap,
                        device="cpu")
        moves, score = nk.nw_sweep(gpu.q4, gpu.t4, gpu.dcb, **geo, **sc)
        (pm, ps), sweep_plain = host_ms(lambda: nk.nw_sweep_plain(
            cpu.q4, cpu.t4, cpu.dcb, **geo, **sc))
        err = max(compare(f"{sweep_name} moves", moves, pm),
                  compare(f"{sweep_name} score", score, ps))
        sweep = cuda_ms(lambda: nk.nw_sweep(gpu.q4, gpu.t4, gpu.dcb, **geo,
                                            **sc))
        bs, bys = _sweep_bound(B, cap, W)
        tag = "" if sc is consensus else " (align scores)"
        log(f"[kernels] {sweep_name} ({cap},{W}) B={B}{tag}: byte-equal; "
            f"{sweep:.3f} ms (plain CPU {sweep_plain:.1f} ms, bound "
            f"{bs:.5f} ms){_floor_note(B, cap, W, sweep)}")
        numbers = dict(max_abs_err=err, ms=sweep, plain_ms=sweep_plain,
                       bound_ms=bs, bound_by=bys,
                       **_floor_numbers(B, cap, W, sweep))
        shape(sweep_name, cap, W, B, sc, **numbers)
        for fmt in fmts:
            walk_name, walk, plain_walk = walks[fmt]
            payload = walk(moves, gpu.m, gpu.n, **geo)
            pp, walk_plain = host_ms(lambda: plain_walk(pm, cpu.m, cpu.n,
                                                        **geo))
            werr = compare(f"{walk_name} payload", payload, pp)
            wms = cuda_ms(lambda: walk(moves, gpu.m, gpu.n, **geo))
            esc = int(pp[:, -1].sum())
            dec = _decode_ms(fmt, pp.numpy(), cap, W, m, n, threads)
            if fmt == "rows":
                steps, bw, byw = _rows_bound(pp, m, n, cap, W)
            elif fmt == "packed2":
                steps, bw, byw = _packed_bound(pp, m, n, cap, W)
            else:
                steps = _walk_steps_taken(pp)
                bw, byw = _walk_bound(B, cap, W, pp.shape[1], steps)
            unit = "rows" if fmt == "rows" else "steps"
            longest = ({} if fmt == "rle"
                       else _longest(walk_name, pp, m, wms))
            log(f"[kernels] {walk_name} ({cap},{W}) B={B}{tag}: "
                f"byte-equal, {esc} escapes, {steps} {unit}; {wms:.3f} ms "
                f"(plain CPU {walk_plain:.1f} ms, bound {bw:.5f} ms by "
                f"{byw}){_longest_note(longest) if longest else ''}; D2H "
                f"payload {pp.numel()} bytes, host decode {dec:.3f} ms on "
                f"{threads} threads")
            numbers = dict(max_abs_err=werr, ms=wms, plain_ms=walk_plain,
                           bound_ms=bw, bound_by=byw, **longest)
            shape(walk_name, cap, W, B, sc, **numbers)

    def chunk(cap, W, drift, rng, check_item):
        """One launch at a stage's chunk size (the 1 GiB move budget):
        the packed walk on a spread of its items against the plain walk;
        with check_item, the sweep's item 0 against the plain sweep."""
        geo = dict(m_cap=cap, n_cap=cap, w_band=W)
        sc = align if W == 4096 else consensus
        Bc = chunk_size(cap, W, 1024 if W == 4096 else 8192)
        q4, t4, dcb, m, n = make_items(rng, Bc, cap, W, sc["gap"], drift)
        if W == 4096:
            dcb[:] = 0xFF
        big = to_device(q4, t4, dcb, m, n, m_cap=cap, n_cap=cap,
                        device="cuda")
        mv_big, sc_big = nk.nw_sweep(big.q4, big.t4, big.dcb, **geo, **sc)
        pay_big = nk.packed_walk(mv_big, big.m, big.n, **geo)
        # the walk on a spread of the items' moves (item 3 leaves the
        # band, 6 is all PAD) and the last, copied to the CPU, against the
        # plain walk
        idx = np.unique(np.r_[np.arange(0, Bc, 7 if Bc < 64 else 29), 3, 6,
                              Bc - 1])
        sub = to_device(q4[idx], t4[idx], dcb[idx], m[idx], n[idx],
                        m_cap=cap, n_cap=cap, device="cpu")
        sel = torch.from_numpy(idx).cuda()
        werr = compare(f"packed_walk payload (chunk items "
                       f"{','.join(map(str, idx))})", pay_big[sel],
                       nk.packed_walk_plain(mv_big[sel].cpu(), sub.m, sub.n,
                                            **geo))
        s_big = cuda_ms(lambda: nk.nw_sweep(big.q4, big.t4, big.dcb, **geo,
                                            **sc), reps=3)
        w_big = cuda_ms(lambda: nk.packed_walk(mv_big, big.m, big.n,
                                               **geo), reps=3)
        bs, bys = _sweep_bound(Bc, cap, W)
        steps, bw, byw = _packed_bound(pay_big.cpu(), m, n, cap, W)
        longest = _longest("packed_walk", pay_big.cpu(), m, w_big)
        checked = ""
        err = sweep_plain = None  # the plain sweep, item 0 only
        if check_item:
            one = to_device(q4[:1], t4[:1], dcb[:1], m[:1], n[:1], m_cap=cap,
                            n_cap=cap, device="cpu")
            (pm, ps), sweep_plain = host_ms(lambda: nk.nw_sweep_plain(
                one.q4, one.t4, one.dcb, **geo, **sc))
            err = max(
                compare("nw_sweep_wide moves (chunk item 0)", mv_big[:1],
                        pm),
                compare("nw_sweep_wide score (chunk item 0)", sc_big[:1],
                        ps))
            checked = (f"; sweep item 0 byte-equal to the plain version "
                       f"(plain CPU sweep {sweep_plain:.1f} ms for that one "
                       f"item)")
        log(f"[kernels] nw_sweep_wide+packed_walk ({cap},{W}) B={Bc} (one "
            f"chunk): sweep {s_big:.3f} ms (bound {bs:.3f} ms"
            f"{_floor_note(Bc, cap, W, s_big)}), walk {w_big:.3f} ms (bound "
            f"{bw:.5f} ms, {steps} steps{_longest_note(longest)}; items "
            f"{','.join(map(str, idx))} byte-equal to the plain walk)"
            f"{checked}")
        shape("nw_sweep_wide", cap, W, Bc, sc, max_abs_err=err, ms=s_big,
              plain_ms_item0=sweep_plain, bound_ms=bs, bound_by=bys,
              **_floor_numbers(Bc, cap, W, s_big))
        shape("packed_walk", cap, W, Bc, sc, max_abs_err=werr, ms=w_big,
              bound_ms=bw, bound_by=byw, plain_items=idx.tolist(),
              **longest)

    def block_chunk(cap, W, Bc, rng, sc):
        """The block sweep at a stage's chunk, item 0 against the plain
        version."""
        geo = dict(m_cap=cap, n_cap=cap, w_band=W)
        q4, t4, dcb, m, n = make_items(rng, Bc, cap, W, sc["gap"])
        if sc is align:
            dcb[:] = 0xFF
        big = to_device(q4, t4, dcb, m, n, m_cap=cap, n_cap=cap,
                        device="cuda")
        mv, sco = nk.nw_sweep(big.q4, big.t4, big.dcb, **geo, **sc)
        ms = cuda_ms(lambda: nk.nw_sweep(big.q4, big.t4, big.dcb, **geo,
                                         **sc), reps=3)
        one = to_device(q4[:1], t4[:1], dcb[:1], m[:1], n[:1], m_cap=cap,
                        n_cap=cap, device="cpu")
        (pm, ps), plain = host_ms(lambda: nk.nw_sweep_plain(
            one.q4, one.t4, one.dcb, **geo, **sc))
        err = max(compare("nw_sweep_block moves (chunk item 0)", mv[:1], pm),
                  compare("nw_sweep_block score (chunk item 0)", sco[:1],
                          ps))
        bs, bys = _sweep_bound(Bc, cap, W)
        tag = "" if sc is consensus else " (align scores)"
        log(f"[kernels] nw_sweep_block ({cap},{W}) B={Bc} (one chunk){tag}: "
            f"{ms:.3f} ms (bound {bs:.4f} ms{_floor_note(Bc, cap, W, ms)}); "
            f"item 0 byte-equal to the plain version (plain CPU {plain:.1f}"
            f" ms for that one item)")
        shape("nw_sweep_block", cap, W, Bc, sc, max_abs_err=err, ms=ms,
              plain_ms_item0=plain, bound_ms=bs, bound_by=bys,
              **_floor_numbers(Bc, cap, W, ms))
        if sc is not align:
            return
        # the align stage's scored route walks this chunk with the rows
        # walk (RACON_TPU_WALK=rows): timed here, held against the plain
        # walk on a spread of items (3 leaves the band, 6 is all PAD)
        pay = nk.rows_walk(mv, big.m, big.n, **geo)
        wms = cuda_ms(lambda: nk.rows_walk(mv, big.m, big.n, **geo), reps=3)
        idx = np.unique(np.r_[np.linspace(0, Bc - 1, 8).astype(int), 3, 6,
                              Bc - 1])
        sub = to_device(q4[idx], t4[idx], dcb[idx], m[idx], n[idx],
                        m_cap=cap, n_cap=cap, device="cpu")
        sel = torch.from_numpy(idx).cuda()
        pp, walk_plain = host_ms(lambda: nk.rows_walk_plain(
            mv[sel].cpu(), sub.m, sub.n, **geo))
        werr = compare(f"rows_walk payload (chunk items "
                       f"{','.join(map(str, idx))})", pay[sel], pp)
        rows, bw, byw = _rows_bound(pay.cpu(), m, n, cap, W)
        longest = _longest("rows_walk", pay.cpu(), m, wms)
        log(f"[kernels] rows_walk ({cap},{W}) B={Bc} (one chunk){tag}: "
            f"{wms:.3f} ms (bound {bw:.5f} ms by {byw}, {rows} rows"
            f"{_longest_note(longest)}); items {','.join(map(str, idx))} "
            f"byte-equal to the plain walk (plain CPU {walk_plain:.1f} ms "
            f"for them); {rows_walk_launch(Bc, W)[0]} blocks")
        shape("rows_walk", cap, W, Bc, sc, max_abs_err=werr, ms=wms,
              plain_ms=walk_plain, plain_items=idx.tolist(), bound_ms=bw,
              bound_by=byw, **longest)

    scored(640, 128, 4096, None, ("rle", "rows"), rng, consensus)
    scored(5120, 1024, 8, None, ("rle", "rows"), rng, consensus)
    scored(10240, 2048, 16, 700, ("packed2",), rng, consensus)
    chunk(10240, 2048, 700, rng, False)

    myers_shape(results, 2560, 512, 1024, rng, None)
    myers_shape(results, 10240, 1024, 8, rng, None)
    # at its main tier the align stage's chunk was 409 items (29 launches
    # per initialize() at 4.6 Mb) until its planes budget replaced the
    # move budget; its chunk now is _chunk_size's (12 launches of ~959)
    myers_shape(results, 10240, 1024, 409, rng, 8,
                " (the former align chunk)")
    myers_shape(results, 10240, 1024, _chunk_size(10240, 1024, True), rng,
                8, " (the align chunk)", main=True)
    # the align stage's scored route (RACON_TPU_MYERS=0) at a W <= 1024
    # tier and at W = 4096, on its own seed so that the shapes above keep
    # their inputs
    rng4 = np.random.default_rng(4096)
    scored(10240, 4096, 4, 1500, ("packed2",), rng4, align)
    chunk(40960, 4096, 1500, rng4, True)
    scored(10240, 1024, 4, None, ("rle", "rows"), rng4, align)
    # the block sweep at the stages' chunks: the align stage's scored route
    # at (10240,1024), the consensus stage at (5120,1024)
    block_chunk(10240, 1024, _chunk_size(10240, 1024, False), rng4, align)
    block_chunk(5120, 1024, chunk_size(5120, 1024, 8192), rng4, consensus)
    # the warp sweep's other consensus tiers, on a seed of their own: a
    # ragged last block (B % 4 == 1) and W = 256 (eight lanes a thread)
    rng1 = np.random.default_rng(256)
    scored(256, 128, 4097, None, ("rle",), rng1, consensus)
    scored(1280, 256, 1024, None, ("rle",), rng1, consensus)
    # the RLE walk's main shape with a ragged last block (B % 32 == 1)
    scored(640, 128, 4097, None, ("rle",), np.random.default_rng(4097),
           consensus)


def phase_kernels16(results):
    """Phase 2, the int16 DP (RACON_TPU_DP16=1): at (640,128) B = 4096 and
    (256,128) B = 4097 with the consensus scores, the int16 warp kernel;
    at (2560,512) B = 1024 with the align route's scores (0/-1/-1, unit
    deletion costs), (640,288) B = 37 with the consensus scores (the last
    strip cut at W) and (5120,1024) B = 8 with the align scores, the int16
    strip kernel: the int16 kernel against the int32 kernel on every item
    and against the int16 plain version (every item, the first `check` at
    (2560,512)), byte for byte; ms of both kernels, in turns; the bound at
    two cells an instruction; ptxas's registers and spills per kernel."""
    import numpy as np

    from racon_tpu_torch.ops import nw_kernel as nk
    from racon_tpu_torch.ops.batch import to_device
    from racon_tpu_torch.ops.geometry import sweep_dp16, sweep_kernel

    consensus = dict(match=5, mismatch=-4, gap=-8)
    align = dict(match=0, mismatch=-1, gap=-1)
    rng = np.random.default_rng(1616)
    for cap, W, B, sc, check in ((640, 128, 4096, consensus, None),
                                 (256, 128, 4097, consensus, None),
                                 (2560, 512, 1024, align, 64),
                                 (640, 288, 37, consensus, None),
                                 (5120, 1024, 8, align, None)):
        geo = dict(m_cap=cap, n_cap=cap, w_band=W)
        q4, t4, dcb, m, n = make_items(rng, B, cap, W, sc["gap"])
        if sc is align:
            dcb[:] = 0xFF
        gpu = to_device(q4, t4, dcb, m, n, m_cap=cap, n_cap=cap,
                        device="cuda")
        c = B if check is None else check
        cpu = to_device(q4[:c], t4[:c], dcb[:c], m[:c], n[:c], m_cap=cap,
                        n_cap=cap, device="cpu")
        name, name32 = sweep_kernel(W, True), sweep_kernel(W)

        def run(on):
            with dp16(on):
                return nk.nw_sweep(gpu.q4, gpu.t4, gpu.dcb, **geo, **sc)

        with dp16(True):
            if not sweep_dp16(cap, cap, W, **sc):
                raise SmokeFailure(f"({cap},{W}) {sc} outside the int16 gate")
            (pm, ps), plain_ms = host_ms(lambda: nk.nw_sweep_plain(
                cpu.q4, cpu.t4, cpu.dcb, **geo, **sc))
        m32, s32 = run(False)
        m16, s16 = run(True)
        err = max(compare(f"{name} moves vs {name32}'s", m16, m32.cpu()),
                  compare(f"{name} score vs {name32}'s", s16, s32.cpu()),
                  compare(f"{name} moves", m16[:c], pm),
                  compare(f"{name} score", s16[:c], ps))
        # in turns: int32, int16, int16, int32
        t32a = cuda_ms(lambda: run(False))
        t16a = cuda_ms(lambda: run(True))
        t16b = cuda_ms(lambda: run(True))
        t32b = cuda_ms(lambda: run(False))
        ms16, ms32 = (t16a + t16b) / 2, (t32a + t32b) / 2
        numbers = dict(max_abs_err=err, ms=ms16, plain_ms=plain_ms,
                       int32_ms=ms32, int32_name=name32,
                       ms_runs=[t16a, t16b], int32_ms_runs=[t32a, t32b])
        bs, bys = _sweep16_bound(B, cap, W)
        numbers.update(bound_ms=bs, bound_by=bys)
        checked = "every" if check is None else f"the first {c}"
        tag = "" if sc is consensus else " (align scores)"
        log(f"[kernels16] {name} ({cap},{W}) B={B}{tag}: byte-equal to "
            f"{name32} on every item and to the int16 plain version on "
            f"{checked}; {ms16:.3f} ms ({t16a:.3f}, {t16b:.3f}) against "
            f"{name32}'s {ms32:.3f} ms ({t32a:.3f}, {t32b:.3f}) = "
            f"{ms32 / ms16:.2f}x; bound {bs:.5f} ms by {bys}; plain "
            f"CPU {plain_ms:.1f} ms")
        if check is not None:
            numbers["plain_items"] = c
        results[name]["shapes"].append(dict(
            shape=[cap, W, B], scores="align" if sc is align else
            "consensus", **numbers))
        kernel = "nw_sweep16_warp" if W <= 256 else "nw_sweep16_strip"
        results[name]["ptxas"] = {k: v for k, v in PTXAS.items()
                                  if k.startswith(kernel)}
        if results[name]["ms"] is None:
            results[name].update({k: numbers[k] for k in (
                "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by")})


def phase_bench(threads, results, state):
    """Phase 3: consensus stage on the bench workload, with the RLE walk
    (the default), then the rows walk (RACON_TPU_WALK=rows), at the
    default cohort count (3), then once in int16 and once in one cohort
    (RACON_TPU_COHORTS=1). Leaves the first run's consensus in `state`
    for phase 10."""
    from racon_tpu_torch.kernels import LAUNCHES, reset_launches
    from racon_tpu_torch.models.polish_model import PolisherConfig
    from racon_tpu_torch.native import bindings
    from racon_tpu_torch.ops.consensus_stage import TorchConsensusStage
    from racon_tpu_torch.testing.synth import build_workload
    from racon_tpu_torch.utils.logger import Logger

    windows, true = build_workload(seed=1234)
    cfg = PolisherConfig(backend="cuda", num_threads=threads, match=5,
                         mismatch=-4, gap=-8)
    escapes = {}
    try:
        for run, (walk, int16, cohorts) in enumerate((
                ("rle", False, None), ("rows", False, None),
                ("rle", True, None), ("rle", False, "1"))):
            if walk == "rows":
                os.environ["RACON_TPU_WALK"] = "rows"
            else:
                os.environ.pop("RACON_TPU_WALK", None)
            stage = TorchConsensusStage(cfg, "cuda")
            reset_launches()
            t0 = time.perf_counter()
            with contextlib.redirect_stderr(io.StringIO()), dp16(int16), \
                    setenv("RACON_TPU_COHORTS", cohorts):
                cons, _ = stage.consensus_windows(windows, cfg, Logger())
            dt = time.perf_counter() - t0
            counts = dict(LAUNCHES)
            d = bindings.edit_distance(b"".join(cons), true.tobytes())
            state.setdefault("bench_cons", cons)
            prof = {k: round(v, 3) for k, v in stage.prof.items()}
            label = walk + ("_dp16" if int16 else "")
            escapes.setdefault(label, int(stage.prof["escaped_items"]))
            if run < 2 or int16:
                record_launches(results, f"bench_{label}", counts)
            first = (" (the process's first run: includes first-launch "
                     "costs)" if run == 0 else "")
            log(f"[bench] walk {walk}{', RACON_TPU_DP16=1' * int16}, "
                f"{stage.n_cohorts} cohorts: {windows.num_windows} windows in "
                f"{dt:.3f} s = {windows.num_windows / dt:.2f} windows/s"
                f"{first}; launches {counts}; stage {prof}; edit distance "
                f"to truth {d}")
            if d != 91:
                raise SmokeFailure(
                    f"bench workload edit distance {d} != 91 with the {walk}"
                    f" walk; band escapes per walk so far {escapes} (rows "
                    "and RLE decode to the same ops wherever neither "
                    "escapes)")
            other = "rle" if walk == "rows" else "rows"
            sweep = "nw_sweep16" if int16 else "nw_sweep"
            if not (counts[sweep] and counts[f"{walk}_walk"]) \
                    or counts[f"{other}_walk"]:
                raise SmokeFailure(f"{label} walk run launched {counts}")
            if run == 1:
                results["rows_walk"]["launches"] = counts["rows_walk"]
            if stage.n_cohorts != (3 if cohorts is None else 1):
                raise SmokeFailure(f"bench run {run}: {stage.n_cohorts} "
                                   "cohorts")
    finally:
        os.environ.pop("RACON_TPU_WALK", None)
    log(f"[bench] band escapes per walk: {escapes}")


def _polish_cli(tag, wd, argv, around_polish=contextlib.nullcontext):
    """The CLI's own argument path (raconx-torch ...), then
    create_polisher -> initialize -> polish with the counts reset just
    before (polish inside the context around_polish() gives); the peak
    device memory of initialize() and of polish(), kept as p.peaks.
    Returns (polisher, polished contigs, launches)."""
    import torch

    from racon_tpu_torch import cli
    from racon_tpu_torch.kernels import LAUNCHES, reset_launches
    from racon_tpu_torch.polisher import create_polisher

    args = cli.parser().parse_args(
        [*argv, *(os.path.join(wd, f) for f in
                  ("reads.fasta", "ovl.paf", "draft.fasta"))])
    cfg = cli.make_config(args)
    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with contextlib.redirect_stderr(io.StringIO()):
        p = create_polisher(*args.inputs, cfg)
        p.initialize()
        t1 = time.perf_counter()
        peak = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        with around_polish():
            out = p.polish(drop_unpolished_sequences=True)
    t2 = time.perf_counter()
    counts = dict(LAUNCHES)
    p.wall_times = (t1 - t0, t2 - t1)
    p.peaks = (peak, torch.cuda.max_memory_allocated())
    n_win = p.windows.num_windows
    a = p.align_stage.stats
    c = p.consensus_stage.prof
    c_total = c["device_items"] + c["host_items"] - c["escaped_items"]
    log(f"[{tag}] initialize {t1 - t0:.3f} s (peak device memory "
        f"{peak / 2**30:.3f} GiB), polish {t2 - t1:.3f} s (peak "
        f"{p.peaks[1] / 2**30:.3f} GiB), {n_win} windows "
        f"= {n_win / (t2 - t1):.2f} windows/s; launches {counts}")
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


# the stages' host phases (torch.profiler.record_function names in
# ops/consensus_stage.py) whose overlap with the device's busy time the
# profile reports: decode, merge and realign, the work cohorts overlap
# with the device, then the dispatch (packing, uploads, launches)
HOST_SPANS = (("racon::decode", "racon::poa_round", "racon::host_fallback"),
              ("racon::dispatch",))


def _union(spans):
    """Sorted disjoint intervals covering `spans`."""
    out = []
    for a, b in sorted(spans):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _overlap(xs, ys):
    """Total length of the intersection of two sorted disjoint unions."""
    total, j = 0.0, 0
    for a, b in xs:
        while j < len(ys) and ys[j][1] <= a:
            j += 1
        k = j
        while k < len(ys) and ys[k][0] < b:
            total += min(b, ys[k][1]) - max(a, ys[k][0])
            k += 1
    return total


def _device_profile(fn):
    """fn() under torch.profiler (CPU and CUDA activity): wall s, device
    busy s (the union of the device's kernel and copy intervals), the
    part of it inside each group of HOST_SPANS (s), the H2D and D2H
    copies from and to pageable memory, and {kernel or copy name: [ms,
    count]} in descending ms."""
    import re

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    spans, host, by_name = [], [[] for _ in HOST_SPANS], {}
    pageable = {"HtoD": 0, "DtoH": 0}
    for e in prof.events():
        rng = (e.time_range.start, e.time_range.end)
        if e.name.startswith("racon::"):  # an annotation, not device work
            for group, names in zip(host, HOST_SPANS):
                if e.device_type == DeviceType.CPU and e.name in names:
                    group.append(rng)
            continue
        if e.device_type != DeviceType.CUDA:
            continue
        spans.append(rng)
        if "Pageable" in e.name:
            pageable["HtoD" if "HtoD" in e.name else "DtoH"] += 1
        k = re.search(r"(\w+_kernel)(<[^>]*>)?", e.name)
        name = k.group(0) if k else e.name[:40]
        ms_n = by_name.setdefault(name, [0.0, 0])
        ms_n[0] += (e.time_range.end - e.time_range.start) / 1e3
        ms_n[1] += 1
    busy = _union(spans)
    hidden = [_overlap(busy, _union(group)) / 1e6 for group in host]
    return dict(wall=wall, busy=sum(b - a for a, b in busy) / 1e6,
                hidden=hidden[0], in_dispatch=hidden[1], pageable=pageable,
                by_name=dict(sorted(by_name.items(), key=lambda kv:
                                    -kv[1][0])))


def _profile_polish(wd, argv, mode):
    """create_polisher -> initialize -> polish once more in this process,
    each of the two calls under torch.profiler: where the device time of
    the main path goes, and how much of it the host's decode and merge
    hide. Fails on any H2D copy from pageable memory. Returns polish()'s
    profile (_device_profile)."""
    from racon_tpu_torch import cli
    from racon_tpu_torch.polisher import create_polisher

    args = cli.parser().parse_args(
        [*argv, *(os.path.join(wd, f) for f in
                  ("reads.fasta", "ovl.paf", "draft.fasta"))])
    cfg = cli.make_config(args)
    with contextlib.redirect_stderr(io.StringIO()):
        p = create_polisher(*args.inputs, cfg)
        for call, fn in (("initialize", p.initialize),
                         ("polish", lambda: p.polish(True))):
            pr = _device_profile(fn)
            top = ", ".join(f"{k} {v[0]:.1f} ms / {v[1]}"
                            for k, v in list(pr["by_name"].items())[:6])
            busy = pr["busy"]
            share = {k: f"{pr[k]:.3f} s ({100 * pr[k] / max(busy, 1e-9):.1f}"
                        " %)" for k in ("hidden", "in_dispatch")}
            log(f"[profile] {call}() {mode}: {pr['wall']:.3f} s (profiled), "
                f"device busy {busy:.3f} s "
                f"({100 * busy / pr['wall']:.1f} %), of it inside host "
                f"decode/merge/realign {share['hidden']}, inside dispatch "
                f"{share['in_dispatch']}; copies from/to pageable memory "
                f"{pr['pageable']}: {top}")
            if pr["pageable"]["HtoD"]:
                raise SmokeFailure(f"{call}() {mode}: "
                                   f"{pr['pageable']['HtoD']} H2D copies "
                                   "from pageable memory")
    log(f"[profile] polish() {mode}: the consensus stage ran "
        f"{p.consensus_stage.n_cohorts} cohorts")
    return pr


POLISH_ARGV = ["--backend", "cuda", "-m", "5", "-x", "-4", "-g", "-8"]


def phase_polish(wd, genome_mb, threads, results, state):
    """Phase 4: the default polish path end to end at genome scale, on a
    dataset made in `wd` (phases 6 and 8 reuse it). Leaves in `state`
    what phase 8 compares with: the contigs, launches and wall times of
    the first polish and the 50 kb CLI run's FASTA."""
    from racon_tpu_torch.testing.synth import make_dataset

    t0 = time.perf_counter()
    true = make_dataset(wd, int(genome_mb * 1e6), 8000, 20, 0.12, seed=11)
    log(f"[polish] dataset {genome_mb} Mb, 20x 8 kb reads, 12% error, "
        f"seed 11: made in {time.perf_counter() - t0:.1f} s")
    p, out, counts = _polish_cli("polish", wd, [*POLISH_ARGV, "-t",
                                                str(threads)])
    state.update(out=out, counts=counts, times=p.wall_times,
                 items=p.align_stage.stats["items"],
                 windows=p.windows.num_windows, split=_split(p),
                 peaks=p.peaks)
    if _stage_split("polish", p, out) != 3:
        raise SmokeFailure("the default polish did not run 3 cohorts")
    record_launches(results, "polish_w500", counts)
    ident = _identity("polish", "polished", out[0][1], true)
    if ident < 99.99:
        raise SmokeFailure(f"identity {ident:.4f}% < 99.99%")
    missing = [k for k in MAIN_KERNELS if counts[k] == 0]
    if missing:
        raise SmokeFailure(f"kernels never launched on the default path: "
                           f"{missing}")
    for k in (*MAIN_KERNELS, "nw_sweep_block"):
        results[k]["launches"] = counts[k]
    # the same path with H in int16 (RACON_TPU_DP16=1): the same FASTA
    with dp16(True):
        _, out16, counts16 = _polish_cli("polish16", wd, [
            *POLISH_ARGV, "-t", str(threads)])
    record_launches(results, "polish_w500_dp16", counts16)
    if out16 != out:
        raise SmokeFailure("the RACON_TPU_DP16=1 polish differs from the "
                           "int32 one")
    if not counts16["nw_sweep16"]:
        raise SmokeFailure(f"RACON_TPU_DP16=1 polish launched {counts16}")
    results["nw_sweep16"]["launches"] = counts16["nw_sweep16"]
    log(f"[polish16] RACON_TPU_DP16=1: the FASTA is byte-equal to the int32 "
        f"run's (identity {ident:.4f}%); nw_sweep16 {counts16['nw_sweep16']}"
        f" launches, nw_sweep {counts16['nw_sweep']} (tiers above the int16 "
        f"gate)")
    _one_cohort(wd, threads, out)
    sweeps = {}
    argv = [*POLISH_ARGV, "-t", str(threads)]
    for tag, on in (("int32", False), ("dp16", True)):
        with dp16(on):
            pr = _profile_polish(wd, argv, tag)
        sweeps[tag] = {k: v for k, v in pr["by_name"].items()
                       if k.startswith("nw_sweep")}
        if tag == "int32":
            state["profile"] = pr
    log(f"[profile] polish() sweep kernels, int32 run: {sweeps['int32']}; "
        f"RACON_TPU_DP16=1 run: {sweeps['dp16']} ([ms, launches])")
    results["nw_sweep16"]["polish_profile"] = {
        k: sweeps[k] for k in ("int32", "dp16")}
    state["cli50"] = _profile_cli()


def _split(p):
    """The consensus stage's split (s) of polisher `p`."""
    return {k: round(p.consensus_stage.prof[k + "_s"], 3) for k in (
        "dispatch", "fetch", "decode", "poa_round", "host_fallback")}


def _stage_split(tag, p, out):
    """Log the consensus stage's cohort count and split (s) of polisher
    `p`, and its FASTA's sha256; returns the cohort count."""
    c = p.consensus_stage
    split = _split(p)
    log(f"[{tag}] the consensus stage ran {c.n_cohorts} cohorts; its "
        f"split (s) {split}; FASTA sha256 "
        f"{hashlib.sha256(out[0][1]).hexdigest()}")
    return c.n_cohorts


def _one_cohort(wd, threads, out):
    """Phase 4's polish once more with RACON_TPU_COHORTS=1 (the first
    polish ran the default count, 3; which is faster is the benchmark's
    question): its times and the consensus stage's split, and its FASTA
    must equal the first polish's."""
    with setenv("RACON_TPU_COHORTS", "1"):
        p, got, _ = _polish_cli("cohorts 1", wd, [*POLISH_ARGV, "-t",
                                                  str(threads)])
    if _stage_split("cohorts 1", p, got) != 1:
        raise SmokeFailure("RACON_TPU_COHORTS=1 ran more than one cohort")
    if got != out:
        raise SmokeFailure("cohorts 1: the FASTA differs from phase 4's")


def cli50(wd):
    """The 50 kb make_dataset (seed 11) of the --profile run, made in
    `wd`; its three input paths."""
    from racon_tpu_torch.testing.synth import make_dataset

    make_dataset(wd, 50_000, 8000, 20, 0.12, seed=11)
    return [os.path.join(wd, f) for f in
            ("reads.fasta", "ovl.paf", "draft.fasta")]


def _profile_cli():
    """raconx-torch --profile <dir> in a process of its own on a 50 kb
    make_dataset: the trace must name the warp sweep (K1) and the Myers
    sweep (K3), and the FASTA must be the run's without --profile, which
    is returned."""
    with tempfile.TemporaryDirectory() as wd:
        inputs = cli50(wd)
        fastas = []
        for extra in ([], ["--profile", os.path.join(wd, "trace")]):
            t0 = time.perf_counter()
            res = subprocess.run(
                [sys.executable, "-m", "racon_tpu_torch.cli", *extra,
                 *POLISH_ARGV, "-t", "8", *inputs], cwd=ROOT,
                capture_output=True, timeout=300)
            if res.returncode:
                raise SmokeFailure(f"raconx-torch {' '.join(extra)} exited "
                                   f"{res.returncode}: "
                                   f"{res.stderr.decode()[-2000:]}")
            fastas.append(res.stdout)
            log(f"[profile-cli] raconx-torch {' '.join(extra) or '(plain)'}"
                f" on 50 kb: {time.perf_counter() - t0:.1f} s, FASTA "
                f"{len(res.stdout)} bytes")
        traces = [os.path.join(wd, "trace", f)
                  for f in os.listdir(os.path.join(wd, "trace"))]
        text = "".join(open(f).read() for f in traces)
        want = ("nw_sweep_warp_kernel", "myers_sweep_kernel")
        log(f"[profile-cli] trace {[os.path.basename(f) for f in traces]}, "
            f"{len(text)} bytes; names "
            f"{ {k: text.count(k) for k in want} }")
        if fastas[0] != fastas[1] or not fastas[0].startswith(b">"):
            raise SmokeFailure("--profile changed the FASTA")
        missing = [k for k in want if k not in text]
        if missing:
            raise SmokeFailure(f"the --profile trace lacks {missing}")
    return fastas[0]


MESH2 = ("cuda:0", "cuda:0")  # a two-device mesh on the one card


def _run_group(cmd, timeout):
    """cmd from the checkout's root in a process group of its own, its
    output captured; the whole group (torchrun and its workers) killed if
    it outlasts `timeout` s. Returns (returncode, stdout, stderr)."""
    proc = subprocess.Popen(cmd, cwd=ROOT, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, start_new_session=True)
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        raise SmokeFailure(f"{' '.join(cmd[2:8])} ... outlasted {timeout} s")
    return proc.returncode, out, err


def _wall_ms(fn, reps=3):
    """Host ms of fn() up to the end of its device work: the mean of
    `reps` calls after a warm-up."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0) / reps


def phase_multi(wd, threads, results, state):
    """Phase 8: the multi-device path (parallel/mesh.py, parallel/dist.py)
    on the one card, after phase 4 and on its dataset: the sharded
    kernels, an in-process mesh of (cuda:0, cuda:0), and two processes
    under torchrun. It shows what splitting costs, not a scaling."""
    _sharded_kernels(results)
    _mesh_polish(wd, threads, results, state)
    _dist_polish(wd, threads, results, state)


def _sharded_kernels(results):
    """mesh.sharded_align_walk on MESH2 at (640,128) B = 4097 (fmt rle,
    consensus scores) and (10240,1024) B = 1023 (fmt myers; odd B, so the
    shards are uneven): each shard on cuda:0 with the sizes
    dist.shard_range gives, and every item's payload and score equal to
    the unsharded launch's; both timed from the packed numpy batch to the
    end of the device work."""
    import numpy as np
    import torch

    from racon_tpu_torch.ops import myers_kernel as mk
    from racon_tpu_torch.ops import nw_kernel as nk
    from racon_tpu_torch.ops.batch import to_device
    from racon_tpu_torch.parallel import dist, mesh

    dev = torch.device("cuda", 0)
    mesh2 = mesh.window_mesh(MESH2)
    rng = np.random.default_rng(8)
    for cap, W, B, fmt, sc in (
            (640, 128, 4097, "rle", dict(match=5, mismatch=-4, gap=-8)),
            (10240, 1024, 1023, "myers", dict(match=0, mismatch=-1,
                                               gap=-1))):
        geo = dict(m_cap=cap, n_cap=cap, w_band=W)
        q4, t4, dcb, m, n = make_items(rng, B, cap, W, sc["gap"])

        def sharded():
            return mesh.sharded_align_walk(mesh2, q4, t4, dcb, m, n, **geo,
                                           **sc, fmt=fmt)

        def whole():
            g = to_device(q4, t4, None if fmt == "myers" else dcb, m, n,
                          m_cap=cap, n_cap=cap, device=dev)
            if fmt == "myers":
                planes = mk.myers_sweep(g.q4, g.t4, **geo)
                return (mk.myers_walk(planes, g.m, g.n, **geo),
                        torch.zeros_like(g.m))
            moves, score = nk.nw_sweep(g.q4, g.t4, g.dcb, **geo, **sc)
            return nk.rle_walk(moves, g.m, g.n, **geo), score

        payloads, scores = sharded()
        sizes = [len(p) for p in payloads]
        want_sizes = [hi - lo for lo, hi in (dist.shard_range(B, i, 2)
                                             for i in range(2))]
        devices = {str(t.device) for t in payloads + scores}
        if sizes != want_sizes or devices != {"cuda:0"}:
            raise SmokeFailure(f"sharded {fmt}: shards of {sizes} items on "
                               f"{devices}, expected {want_sizes} on cuda:0")
        want_p, want_s = whole()
        err = max(compare(f"sharded {fmt} payload", torch.cat(payloads),
                          want_p.cpu()),
                  compare(f"sharded {fmt} score", torch.cat(scores),
                          want_s.cpu()))
        t_whole, t_sharded = _wall_ms(whole), _wall_ms(sharded)
        walk = "myers_walk" if fmt == "myers" else "rle_walk"
        results[walk]["mesh2_dispatch"] = dict(
            shape=[cap, W, B], shards=sizes, max_abs_err=err,
            sharded_ms=t_sharded, unsharded_ms=t_whole)
        log(f"[mesh2] sharded_align_walk {fmt} ({cap},{W}) B={B} on "
            f"{list(MESH2)}: shards {sizes}, every item's payload and score "
            f"byte-equal to the unsharded launch's; upload + kernels "
            f"{t_sharded:.3f} ms sharded, {t_whole:.3f} ms unsharded")


def _mesh_polish(wd, threads, results, state):
    """The bench workload and phase 4's polish in this process with the
    mesh pinned to MESH2 (mesh.set_active_mesh): edit distance 91, the
    FASTA byte-equal to phase 4's, every fused dispatch split into two
    shards on cuda:0 (mesh.sharded_align_walk watched), each kernel of the
    main path launched once a shard; then initialize and polish once more
    under torch.profiler: device busy."""
    from racon_tpu_torch.kernels import LAUNCHES, reset_launches
    from racon_tpu_torch.models.polish_model import PolisherConfig
    from racon_tpu_torch.native import bindings
    from racon_tpu_torch.ops.consensus_stage import TorchConsensusStage
    from racon_tpu_torch.parallel import mesh
    from racon_tpu_torch.testing.synth import build_workload
    from racon_tpu_torch.utils.logger import Logger

    real = mesh.sharded_align_walk
    seen = {"calls": 0, "shards": 0, "devices": set(), "short": 0}

    def watch(m, q4, *args, **kwargs):
        payloads, scores = real(m, q4, *args, **kwargs)
        seen["calls"] += 1
        seen["shards"] += len(payloads)
        seen["short"] += len(payloads) != min(2, len(q4))
        seen["devices"].update(str(p.device) for p in payloads)
        return payloads, scores

    argv = [*POLISH_ARGV, "-t", str(threads)]
    mesh.sharded_align_walk = watch
    mesh.set_active_mesh(MESH2)
    try:
        windows, true = build_workload(seed=1234)
        cfg = PolisherConfig(backend="cuda", num_threads=threads, match=5,
                             mismatch=-4, gap=-8)
        stage = TorchConsensusStage(cfg, "cuda")
        reset_launches()
        t0 = time.perf_counter()
        with contextlib.redirect_stderr(io.StringIO()):
            cons, _ = stage.consensus_windows(windows, cfg, Logger())
        dt = time.perf_counter() - t0
        d = bindings.edit_distance(b"".join(cons), true.tobytes())
        record_launches(results, "bench_mesh2", dict(LAUNCHES))
        log(f"[mesh2] bench workload on {list(MESH2)}: {dt:.3f} s, edit "
            f"distance to truth {d}; launches {dict(LAUNCHES)}")
        if d != 91:
            raise SmokeFailure(f"mesh2 bench edit distance {d} != 91")
        for k in seen:
            seen[k] = set() if k == "devices" else 0
        p, out, counts = _polish_cli("mesh2", wd, argv)
        record_launches(results, "mesh2", counts)
        walks = state["counts"]["rle_walk"] + state["counts"]["myers_walk"]
        log(f"[mesh2] 4.6 Mb polish: {seen['calls']} fused dispatches (phase "
            f"4: {walks}) in {seen['shards']} shards on "
            f"{sorted(seen['devices'])}; initialize {p.wall_times[0]:.3f} "
            f"s, polish {p.wall_times[1]:.3f} s (phase 4: "
            f"{state['times'][0]:.3f}, {state['times'][1]:.3f} s); FASTA "
            f"sha256 {hashlib.sha256(out[0][1]).hexdigest()}")
        if out != state["out"]:
            raise SmokeFailure("the mesh2 polish differs from phase 4's")
        shards = counts["rle_walk"] + counts["myers_walk"]
        if (seen["calls"] != walks or seen["short"]
                or seen["devices"] != {"cuda:0"}
                or seen["shards"] != shards
                or any(not counts[k] for k in MAIN_KERNELS)):
            raise SmokeFailure(f"mesh2 polish: dispatches {seen}, launches "
                               f"{counts}; phase 4 launched "
                               f"{state['counts']}")
        pr = _profile_polish(wd, argv, "mesh2")
        ref = state["profile"]
        log(f"[mesh2] polish() device busy {pr['busy']:.3f} s of "
            f"{pr['wall']:.3f} s profiled (phase 4: {ref['busy']:.3f} s of "
            f"{ref['wall']:.3f} s)")
        for k in MAIN_KERNELS:
            results[k]["mesh2"] = dict(
                launches=counts[k], initialize_s=p.wall_times[0],
                polish_s=p.wall_times[1], busy_s=pr["busy"],
                phase4=dict(launches=state["counts"][k],
                            initialize_s=state["times"][0],
                            polish_s=state["times"][1],
                            busy_s=ref["busy"]))
    finally:
        mesh.sharded_align_walk = real
        mesh.clear_active_mesh()


def _dist_polish(wd, threads, results, state):
    """Two processes on the one card: `python -m torch.distributed.run
    --standalone --nproc-per-node 2 -m racon_tpu_torch.testing.dist_polish`
    on phase 4's dataset (each with half the host threads): both ranks in
    a world of 2 on cuda:0, each aligning and polishing a share only and
    launching every kernel of the main path, rank 0's FASTA byte-equal to
    phase 4's; then the CLI itself, `... -m racon_tpu_torch.cli
    --distributed`, on the 50 kb dataset of phase 4's --profile run: its
    stdout exactly the single-process CLI's FASTA."""
    torchrun = [sys.executable, "-m", "torch.distributed.run",
                "--standalone", "--nproc-per-node", "2"]
    inputs = [os.path.join(wd, f) for f in
              ("reads.fasta", "ovl.paf", "draft.fasta")]
    half = ["-t", str(max(1, threads // 2))]
    with tempfile.TemporaryDirectory() as rep:
        t0 = time.perf_counter()
        rc, _, err = _run_group([*torchrun, "-m",
                                 "racon_tpu_torch.testing.dist_polish",
                                 "--report", rep, "--", *POLISH_ARGV, *half,
                                 *inputs], 600)
        dt = time.perf_counter() - t0
        if rc:
            raise SmokeFailure(f"torchrun dist_polish exited {rc}: "
                               f"{err.decode()[-3000:]}")
        ranks = []
        for r in range(2):
            with open(os.path.join(rep, f"rank{r}.json")) as f:
                ranks.append(json.load(f))
        with open(os.path.join(rep, "polished.fasta"), "rb") as f:
            fasta = f.read()
    total = {k: sum(x["launches"][k] for x in ranks)
             for k in ranks[0]["launches"]}
    record_launches(results, "dist2", total)
    for x in ranks:
        launched = {k: c for k, c in x["launches"].items() if c}
        log(f"[dist2] rank {x['rank']} of {x['world_size']} on cuda:"
            f"{x['current_device']} (local devices {x['local_devices']}, "
            f"stage on {x['stage_device']}): aligned {x['align_items']} "
            f"overlaps, polished {x['consensus_windows']} windows; "
            f"initialize {x['initialize_s']:.3f} s (of it loading the "
            f"kernels {x['kernel_load_s']:.3f} s), polish "
            f"{x['polish_s']:.3f} s; launches {launched}")
    log(f"[dist2] torchrun command {dt:.3f} s in all (phase 4 in one "
        f"process: initialize {state['times'][0]:.3f} s, polish "
        f"{state['times'][1]:.3f} s)")
    want = b"".join(b">" + n + b"\n" + d + b"\n" for n, d in state["out"])
    bad = [x["rank"] for x in ranks if not (
        x["world_size"] == 2 and x["current_device"] == 0
        and x["local_devices"] == ["cuda:0"]
        and all(x["launches"][k] for k in MAIN_KERNELS)
        and 0 < x["align_items"] < state["items"])]
    if ([x["rank"] for x in ranks] != [0, 1] or bad
            or sum(x["align_items"] for x in ranks) != state["items"]
            or sum(x["consensus_windows"] for x in ranks)
            != state["windows"]):
        raise SmokeFailure(f"dist2: ranks {bad} at fault: {ranks}")
    if fasta != want:
        raise SmokeFailure("dist2: rank 0's FASTA differs from phase 4's")
    for k in MAIN_KERNELS:
        results[k]["dist2"] = dict(
            launches=[x["launches"][k] for x in ranks],
            initialize_s=[x["initialize_s"] for x in ranks],
            kernel_load_s=[x["kernel_load_s"] for x in ranks],
            polish_s=[x["polish_s"] for x in ranks], command_s=dt)
    log("[dist2] both ranks in a world of 2 on cuda:0, each on its share; "
        "rank 0's FASTA byte-equal to phase 4's")
    with tempfile.TemporaryDirectory() as wd50:
        t0 = time.perf_counter()
        rc, out, err = _run_group([*torchrun, "-m", "racon_tpu_torch.cli",
                                   "--distributed", *POLISH_ARGV, *half,
                                   *cli50(wd50)], 300)
        if rc:
            raise SmokeFailure(f"torchrun raconx-torch --distributed exited "
                               f"{rc}: {err.decode()[-3000:]}")
    log(f"[dist2] torchrun raconx-torch --distributed on 50 kb: "
        f"{time.perf_counter() - t0:.1f} s, stdout {len(out)} bytes")
    if out != state["cli50"]:
        raise SmokeFailure("torchrun raconx-torch --distributed: stdout is "
                           "not the single-process CLI's FASTA")


def phase_gather(wd, threads, results, state):
    """Phase 10 (right after phase 8, on phase 4's dataset): the gather
    route (J6, RACON_TPU_DEVGATHER=1) and the Myers "rle" payload (J5).
    The gather kernel against its plain version and the host packers; the
    bench workload, phase 4's polish and the bench on the mesh (cuda:0,
    cuda:0) under the gather route, each equal to its dense run with no
    host row packer called; then J5 and J1 at the Myers tiers."""
    _gather_kernel(results, state)
    _gather_bench(threads, results, state)
    _gather_polish(wd, threads, results, state)
    _gather_mesh(threads, results)
    _myers_rle(results, threads)


@contextlib.contextmanager
def _count_packers(calls):
    """Count the host row packers' calls (bindings.pack_rows_nib /
    pack_rows_bits) into calls["n"] for the block."""
    from racon_tpu_torch.native import bindings

    real = {k: getattr(bindings, k) for k in ("pack_rows_nib",
                                              "pack_rows_bits")}
    calls["n"] = 0

    def counted(fn):
        def call(*args, **kwargs):
            calls["n"] += 1
            return fn(*args, **kwargs)
        return call

    for k, fn in real.items():
        setattr(bindings, k, counted(fn))
    try:
        yield calls
    finally:
        for k, fn in real.items():
            setattr(bindings, k, fn)


def _gather_kernel(results, state):
    """Phase 10 (a): pack_gather at (640,128) B = 4096, (256,128) B = 4097
    and (5120,1024) B = 8 against its plain version and the host packers,
    byte for byte; CUDA-event ms, the host packers' ms, and the share of
    the bytes bound; beside the kernel in a CUDA graph, the empty kernel
    of the same grid (the floor of a launch, built at the start) and the
    share of the bound over the time above it."""
    import ctypes

    import numpy as np
    import torch

    from racon_tpu_torch.benchmarks.kernel_ab import (GATHER_SHAPES,
                                                      gather_bytes,
                                                      gather_items, graph_ms)
    from racon_tpu_torch.kernels.build import kernels
    from racon_tpu_torch.native import bindings
    from racon_tpu_torch.ops import gather
    from racon_tpu_torch.ops.geometry import PAD_CODE

    empty = state["gather_empty"]
    rng = np.random.default_rng(1476)
    for cap, W, B in GATHER_SHAPES:
        words, meta, (q8, t8, del8) = gather_items(rng, B, cap)
        dev = [torch.from_numpy(x).cuda() for x in (*words, meta)]
        geo = dict(m_cap=cap, n_cap=cap)
        got = gather.pack_gather(*dev, **geo)
        plain, plain_ms = host_ms(lambda: gather.pack_gather_plain(
            *(torch.from_numpy(x) for x in (*words, meta)), **geo))
        qs, m, ts, n = meta.T.astype(np.int64)
        packers, packers_ms = host_ms(lambda: (
            bindings.pack_rows_nib(q8, qs, qs + m, cap, PAD_CODE, 8),
            bindings.pack_rows_nib(t8, ts, ts + n, cap, PAD_CODE, 8),
            bindings.pack_rows_bits(del8, ts, ts + n, cap, 8)))
        err = 0
        for part, g, p, h in zip(("q4", "t4", "dcb"), got, plain, packers):
            err = max(err, compare(f"pack_gather {part} ({cap}) B={B}", g,
                                   p))
            compare(f"pack_gather {part} plain vs the host packer", p,
                    torch.from_numpy(h))
        ms = cuda_ms(lambda: gather.pack_gather(*dev, **geo))
        outs = [torch.empty_like(x) for x in got]
        dms = graph_ms(lambda: kernels().pack_gather(*dev, *outs, cap, cap))
        for part, g, p in zip(("q4", "t4", "dcb"), outs, plain):
            compare(f"pack_gather {part} ({cap}) B={B}, graph replay", g, p)
        ptrs = [ctypes.c_void_p(x.data_ptr()) for x in (*dev, *outs)]
        fms = graph_ms(lambda: empty.rtt_pack_gather(
            ptrs[0], len(words[0]), ptrs[1], len(words[1]), ptrs[2],
            len(words[2]), *ptrs[3:], B, cap, cap, ctypes.c_void_p(
                torch.cuda.current_stream().cuda_stream)))
        out_words = B * (cap // 8 + cap // 8 + cap // 32)
        nbytes = gather_bytes(B, cap, meta)
        bg, byg = bound(nbytes, out_words * OPS_GATHER_WORD)
        over = bg / (dms - fms) if dms > fms else None
        log(f"[gather] pack_gather ({cap},{W}) B={B}: byte-equal to its "
            f"plain version and to the host packers ({int((m == 0).sum())} "
            f"all-PAD items); {ms:.4f} ms a call (CUDA events), "
            f"{dms:.5f} ms a launch in a CUDA graph, {100 * bg / dms:.2f} "
            f"% of its bound {bg:.5f} ms by {byg} ({nbytes} bytes); the "
            f"empty kernel of its grid {fms:.5f} ms, the bound "
            + (f"{100 * over:.1f} %" if over else "-") + " of the time "
            f"above it; plain CPU {plain_ms:.1f} ms, host packers "
            f"{packers_ms:.2f} ms on 8 threads")
        record_shape(results, "pack_gather", cap, W, B, "consensus",
                     max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bg,
                     bound_by=byg, graph_ms=dms, graph_floor_ms=fms,
                     bound_share_over_floor=over,
                     host_packers_ms=packers_ms)


def _gather_bench(threads, results, state):
    """Phase 10 (b): the bench workload under RACON_TPU_DEVGATHER=1: edit
    distance 91, the consensus equal to phase 3's, 3 cohorts, the gather
    kernel launched and no host row packer called."""
    from racon_tpu_torch.kernels import LAUNCHES, reset_launches
    from racon_tpu_torch.models.polish_model import PolisherConfig
    from racon_tpu_torch.native import bindings
    from racon_tpu_torch.ops.consensus_stage import TorchConsensusStage
    from racon_tpu_torch.testing.synth import build_workload
    from racon_tpu_torch.utils.logger import Logger

    windows, true = build_workload(seed=1234)
    cfg = PolisherConfig(backend="cuda", num_threads=threads, match=5,
                         mismatch=-4, gap=-8)
    packs = {}
    stage = TorchConsensusStage(cfg, "cuda")
    reset_launches()
    t0 = time.perf_counter()
    with setenv("RACON_TPU_DEVGATHER", "1"), _count_packers(packs), \
            contextlib.redirect_stderr(io.StringIO()):
        cons, _ = stage.consensus_windows(windows, cfg, Logger())
    dt = time.perf_counter() - t0
    counts = dict(LAUNCHES)
    record_launches(results, "gather_bench", counts)
    d = bindings.edit_distance(b"".join(cons), true.tobytes())
    prof = {k: round(v, 3) for k, v in stage.prof.items()}
    log(f"[gather] bench workload, RACON_TPU_DEVGATHER=1, "
        f"{stage.n_cohorts} cohorts: {dt:.3f} s = "
        f"{windows.num_windows / dt:.2f} windows/s; edit distance {d}; "
        f"host row packer calls {packs['n']}; launches {counts}; stage "
        f"{prof}")
    if d != 91 or cons != state["bench_cons"]:
        raise SmokeFailure(f"gather bench: edit distance {d}, consensus "
                           "equal to phase 3's: "
                           f"{cons == state['bench_cons']}")
    if (not counts["pack_gather"] or packs["n"] or stage.n_cohorts != 3
            or stage.prof["gather_dense_chunks"]):
        raise SmokeFailure(f"gather bench: launches {counts}, packer calls "
                           f"{packs['n']}, {stage.n_cohorts} cohorts")


def _gather_polish(wd, threads, results, state):
    """Phase 10 (c): phase 4's polish under RACON_TPU_DEVGATHER=1: the
    FASTA byte-equal to phase 4's, no host row packer called in polish(),
    the stage split beside phase 4's dense one, the blob and meta H2D
    bytes, the peak device memory; then polish() profiled: device busy."""
    argv = [*POLISH_ARGV, "-t", str(threads)]
    packs = {}
    with setenv("RACON_TPU_DEVGATHER", "1"):
        p, out, counts = _polish_cli("gather", wd, argv,
                                     lambda: _count_packers(packs))
    record_launches(results, "gather_polish", counts)
    results["pack_gather"]["launches"] = counts["pack_gather"]
    c = p.consensus_stage.prof
    log(f"[gather] 4.6 Mb polish, RACON_TPU_DEVGATHER=1: stage split (s) "
        f"{_split(p)} against phase 4's dense {state['split']}; polish "
        f"{p.wall_times[1]:.3f} s (phase 4 {state['times'][1]:.3f} s); "
        f"H2D blobs {int(c['gather_blob_bytes'])} bytes, meta "
        f"{int(c['gather_meta_bytes'])} bytes for {int(c['gather_items'])} "
        f"items; peak device memory of polish() {p.peaks[1] / 2**30:.3f} "
        f"GiB (phase 4 {state['peaks'][1] / 2**30:.3f} GiB); host row "
        f"packer calls in polish() {packs['n']}; pack_gather "
        f"{counts['pack_gather']} launches")
    if out != state["out"]:
        raise SmokeFailure("the gather polish differs from phase 4's")
    if (packs["n"] or not counts["pack_gather"]
            or c["gather_dense_chunks"] or not c["gather_items"]):
        raise SmokeFailure(f"gather polish: packer calls {packs['n']}, "
                           f"launches {counts}, stage {dict(c)}")
    with setenv("RACON_TPU_DEVGATHER", "1"):
        pr = _profile_polish(wd, argv, "gather")
    ref = state["profile"]
    log(f"[gather] polish() device busy {pr['busy']:.3f} s of "
        f"{pr['wall']:.3f} s profiled, {pr['in_dispatch']:.3f} s of it "
        f"inside dispatch (phase 4 dense: {ref['busy']:.3f} s of "
        f"{ref['wall']:.3f} s, {ref['in_dispatch']:.3f} s)")
    results["pack_gather"]["gather_polish"] = dict(
        split=_split(p), dense_split=state["split"], polish_s=p.wall_times[1],
        dense_polish_s=state["times"][1],
        blob_bytes=c["gather_blob_bytes"], meta_bytes=c["gather_meta_bytes"],
        peak_bytes=p.peaks[1], busy_s=pr["busy"], dense_busy_s=ref["busy"])


def _gather_mesh(threads, results):
    """Phase 10 (d): the bench workload under the gather route with the
    mesh pinned to MESH2: edit distance 91, every fused dispatch in two
    shards on cuda:0, one gather launch a shard."""
    from racon_tpu_torch.kernels import LAUNCHES, reset_launches
    from racon_tpu_torch.models.polish_model import PolisherConfig
    from racon_tpu_torch.native import bindings
    from racon_tpu_torch.ops.consensus_stage import TorchConsensusStage
    from racon_tpu_torch.parallel import mesh
    from racon_tpu_torch.testing.synth import build_workload
    from racon_tpu_torch.utils.logger import Logger

    real = mesh.sharded_align_walk_gather
    seen = {"calls": 0, "shards": 0, "short": 0, "devices": set()}

    def watch(m, qb, tb, db, meta, **kwargs):
        payloads, scores = real(m, qb, tb, db, meta, **kwargs)
        seen["calls"] += 1
        seen["shards"] += len(payloads)
        seen["short"] += len(payloads) != min(2, len(meta))
        seen["devices"].update(str(x.device) for x in payloads)
        return payloads, scores

    windows, true = build_workload(seed=1234)
    cfg = PolisherConfig(backend="cuda", num_threads=threads, match=5,
                         mismatch=-4, gap=-8)
    mesh.sharded_align_walk_gather = watch
    mesh.set_active_mesh(MESH2)
    try:
        stage = TorchConsensusStage(cfg, "cuda")
        reset_launches()
        with setenv("RACON_TPU_DEVGATHER", "1"), \
                contextlib.redirect_stderr(io.StringIO()):
            cons, _ = stage.consensus_windows(windows, cfg, Logger())
    finally:
        mesh.sharded_align_walk_gather = real
        mesh.clear_active_mesh()
    counts = dict(LAUNCHES)
    record_launches(results, "gather_mesh2", counts)
    d = bindings.edit_distance(b"".join(cons), true.tobytes())
    log(f"[gather] bench on {list(MESH2)} under the gather route: edit "
        f"distance {d}; {seen['calls']} fused dispatches in "
        f"{seen['shards']} shards on {sorted(seen['devices'])}; launches "
        f"{counts}")
    if (d != 91 or not seen["calls"] or seen["short"]
            or seen["devices"] != {"cuda:0"}
            or counts["pack_gather"] != seen["shards"]
            or counts["rle_walk"] != seen["shards"]):
        raise SmokeFailure(f"gather mesh2: edit distance {d}, dispatches "
                           f"{seen}, launches {counts}")


def _myers_ops(fmt, payload, cap, W, m, n, threads):
    """Decoded op lists of a walk payload, one array an item."""
    import numpy as np

    from racon_tpu_torch.ops.nw_kernel import payload_decoder

    decode, codes, budget = payload_decoder(fmt, payload, cap, W)
    ops, off, cnt = decode(codes, budget, np.asarray(m, np.int64),
                           np.asarray(n, np.int64), threads)
    return [ops[int(o):int(o) + int(k)] for o, k in zip(off, cnt)]


def _myers_rle(results, threads):
    """Phase 10 (e): align_walk_myers_padded(fmt="rle") at the align
    chunks of (10240,1024) and the kF tier (40960,1024) (items made as
    phases 2 and 9 make them), counts reset before and read after both:
    the peak device memory of each. Then on each shape's planes: J5
    against its plain version and J1 against its plain version on 8 items
    spread over the launch (an escape, an all-PAD item and the last among
    them), J1's payload equal to the fused call's, the rle op lists equal
    to the rows route's for every item that neither escapes; payload bytes
    an item on both routes and the ms of K3, J5 and J1."""
    import numpy as np
    import torch

    from racon_tpu_torch.kernels import LAUNCHES, reset_launches
    from racon_tpu_torch.ops import myers_kernel as mk
    from racon_tpu_torch.ops import nw_kernel as nk
    from racon_tpu_torch.ops.align_stage import _chunk_size
    from racon_tpu_torch.ops.batch import to_device
    from racon_tpu_torch.ops.geometry import moves_live_tiles, rle_events

    runs = []
    reset_launches()
    for cap, W in ((10240, 1024), KF_TIER):
        B = _chunk_size(cap, W, True)
        items = make_items(np.random.default_rng(cap + 5), B, cap, W, -1)
        q4, t4, _, m, n = items
        torch.cuda.reset_peak_memory_stats()
        payload, _, fmt = mk.align_walk_myers_padded(
            q4, t4, m, n, m_cap=cap, n_cap=cap, w_band=W, device="cuda",
            fmt="rle")
        torch.cuda.synchronize()
        if fmt != "rle":
            raise SmokeFailure(f"myers rle at ({cap},{W}): payload {fmt}")
        runs.append((cap, W, B, items, payload,
                     torch.cuda.max_memory_allocated()))
    counts = dict(LAUNCHES)
    record_launches(results, "myers_rle", counts)
    results["myers_moves"]["launches"] = counts["myers_moves"]
    if not all(counts[k] == 2 for k in ("myers_sweep", "myers_moves",
                                        "rle_walk")) or counts["myers_walk"]:
        raise SmokeFailure(f"myers rle launched {counts}")
    for cap, W, B, (q4, t4, _, m, n), fused, peak in runs:
        geo = dict(m_cap=cap, n_cap=cap, w_band=W)
        g = to_device(q4, t4, None, m, n, m_cap=cap, n_cap=cap,
                      device="cuda")
        idx = np.unique(np.r_[np.linspace(0, B - 1, 8).astype(int), 3, 6,
                              B - 1])
        sel = torch.from_numpy(idx).cuda()
        planes = mk.myers_sweep(g.q4, g.t4, **geo)
        moves = mk.myers_moves(planes, g.m, **geo)
        pl, ms, ns = planes[sel].cpu(), g.m[sel].cpu(), g.n[sel].cpu()
        mp, moves_plain = host_ms(lambda: mk.myers_moves_plain(pl, ms,
                                                               **geo))
        err = compare(f"myers_moves ({cap},{W})", moves[sel], mp)
        rle = nk.rle_walk(moves, g.m, g.n, **geo)
        compare(f"rle_walk on J5's moves vs the fused call ({cap},{W})",
                rle, fused.cpu())
        pp, rle_plain = host_ms(lambda: nk.rle_walk_plain(mp, ms, ns,
                                                          **geo))
        rerr = compare(f"rle_walk ({cap},{W}) on J5's moves", rle[sel], pp)
        rows = mk.myers_walk(planes, g.m, g.n, **geo)
        rle_np, rows_np = rle.cpu().numpy(), rows.cpu().numpy()
        esc = (rle_np[:, -1] != 0) | (rows_np[:, -1] != 0)
        got = _myers_ops("rle", rle_np, cap, W, m, n, threads)
        want = _myers_ops("rows", rows_np, cap, W, m, n, threads)
        bad = [b for b in np.flatnonzero(~esc)
               if not np.array_equal(got[b], want[b])]
        if bad or not esc[3]:
            raise SmokeFailure(f"myers rle ({cap},{W}): op lists differ "
                               f"from the rows route's at items {bad[:8]}; "
                               f"escapes {int(esc.sum())}")
        k3 = cuda_ms(lambda: mk.myers_sweep(g.q4, g.t4, **geo), reps=3)
        j5 = cuda_ms(lambda: mk.myers_moves(planes, g.m, **geo), reps=3)
        j1 = cuda_ms(lambda: nk.rle_walk(moves, g.m, g.n, **geo), reps=3)
        # the bound counts the tiles that hold a valid cell (their plane
        # words read, 40 ops a move word), every move word written and m;
        # the whole planes' bound is kept beside it
        tile_bytes = 32 * 4
        tiles = B * (cap // 16) * (W // 32)
        live = moves_live_tiles(m, cap, cap, W)
        b5, by5 = bound((live + tiles) * tile_bytes + 4 * B,
                        live * 32 * OPS_MOVES_WORD)
        b5_whole, _ = bound(2 * tiles * tile_bytes + 4 * B,
                            tiles * 32 * OPS_MOVES_WORD)
        E = rle_events(cap, cap, W)
        steps = _walk_steps_taken(rle.cpu())
        b1, by1 = _walk_bound(B, cap, W, E + 1, steps)
        log(f"[myers_rle] ({cap},{W}) B={B}: J5 byte-equal on items "
            f"{idx.tolist()} ({moves_plain:.1f} ms plain CPU), J1 too "
            f"({rle_plain:.1f} ms plain CPU); the rle op lists equal the "
            f"rows route's on all {int((~esc).sum())} items that neither "
            f"escapes ({int(esc.sum())} escape); payload {E + 1} bytes an "
            f"item (rows {cap + 2}); K3 {k3:.3f} ms, J5 {j5:.3f} ms "
            f"({100 * b5 / j5:.1f} % of its bound {b5:.3f} ms by {by5} "
            f"over the {100 * live / tiles:.1f} % of tiles with a valid "
            f"cell; the whole planes' bound {b5_whole:.3f} ms), "
            f"J1 {j1:.3f} ms (bound {b1:.5f} ms by {by1}, {steps} steps); "
            f"peak device memory of the fused call {peak / 2**30:.3f} GiB")
        del planes, moves
        record_shape(results, "myers_moves", cap, W, B, "align",
                     max_abs_err=err, ms=j5, plain_ms=moves_plain,
                     bound_ms=b5, bound_by=by5, plain_items=idx.tolist(),
                     live_tile_share=live / tiles,
                     whole_planes_bound_ms=b5_whole,
                     k3_ms=k3, j1_ms=j1, peak_bytes=peak,
                     payload_bytes_item={"rle": E + 1, "rows": cap + 2})
        record_shape(results, "rle_walk", cap, W, B, "align",
                     max_abs_err=rerr, ms=j1, plain_ms=rle_plain,
                     bound_ms=b1, bound_by=by1, plain_items=idx.tolist(),
                     on="myers_moves")


def short_reads(wd):
    """Phase 6's third dataset, made in `wd`: testing.synth.make_dataset
    at 0.5 Mb with 20x 2 kb reads, 12 % error, seed 11, whose overlaps fit
    the align stage's (2560,512) tier."""
    from racon_tpu_torch.testing.synth import make_dataset

    make_dataset(wd, 500_000, 2000, 20, 0.12, seed=11)
    return wd


WIDE_ARGV = ["--backend", "cuda", "-w", "10000", "-m", "5", "-x", "-4",
             "-g", "-8"]


def phase_wide(wd, genome_mb, threads, results):
    """Phase 5: the wide-band slice (-w 10000) end to end, on a dataset
    made in `wd` (phase 6 reuses it)."""
    from racon_tpu_torch.testing.synth import make_dataset

    t0 = time.perf_counter()
    true = make_dataset(wd, int(genome_mb * 1e6), 20000, 20, 0.12, seed=11,
                        mix=(0.2, 0.5, 0.3))
    with open(os.path.join(wd, "draft.fasta"), "rb") as f:
        draft = f.read().split(b"\n")[1]
    log(f"[wide] dataset {genome_mb} Mb, 20x 20 kb reads, 12% error "
        f"(ins/del/sub 0.2/0.5/0.3), seed 11: made in "
        f"{time.perf_counter() - t0:.1f} s")
    p, out, counts = _polish_cli("wide", wd, [*WIDE_ARGV, "-t",
                                              str(threads)])
    record_launches(results, "polish_w10000", counts)
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


def phase_align(datasets, threads, results):
    """Phase 6: the scored align route (RACON_TPU_MYERS=0 with
    RACON_TPU_WALK=rows) against the default Myers route: create_polisher
    -> initialize, once each, on phase 4's dataset (8 kb overlaps: the
    W <= 1024 tiers, where the rows walk runs) and on phase 5's (20 kb
    deletion-biased overlaps drift past 448 bases: the W = 4096 tier),
    with the counts reset just before each run. On the w = 500 datasets
    (phase 4's and a 0.5 Mb one of 2 kb reads, whose overlaps fall in the
    (2560,512) tier) the scored route runs once more under
    RACON_TPU_DP16=1, where the int16 gate holds at (2560,512): the block
    kernel's int16 form. Breaking points are taken from the align stage
    as it returns them. `datasets` lists (tag, directory, CLI
    arguments)."""
    import numpy as np

    from racon_tpu_torch import cli
    from racon_tpu_torch.kernels import LAUNCHES, reset_launches
    from racon_tpu_torch.ops.align_stage import TorchAlignStage
    from racon_tpu_torch.polisher import create_polisher

    real = TorchAlignStage.breaking_points
    seen = {"indices": [], "points": []}

    def capture(self, overlaps, indices, *rest):
        out = real(self, overlaps, indices, *rest)
        seen["indices"] += list(indices)
        seen["points"] += out
        return out

    scored_env = {"RACON_TPU_MYERS": "0", "RACON_TPU_WALK": "rows"}
    launched = {"myers": {}, "scored": {}, "scored16": {}}
    wide = 0
    TorchAlignStage.breaking_points = capture
    try:
        for data, wd, argv in datasets:
            args = cli.parser().parse_args(
                [*argv, "-t", str(threads),
                 *(os.path.join(wd, f) for f in ("reads.fasta", "ovl.paf",
                                                 "draft.fasta"))])
            cfg = cli.make_config(args)
            runs = {}
            routes = [("myers", {}), ("scored", scored_env)]
            if data.startswith("w500"):
                routes.append(("scored16", {**scored_env,
                                            "RACON_TPU_DP16": "1"}))
            for route, env in routes:
                os.environ.update(env)
                seen["indices"], seen["points"] = [], []
                reset_launches()
                t0 = time.perf_counter()
                with contextlib.redirect_stderr(io.StringIO()):
                    p = create_polisher(*args.inputs, cfg)
                    p.initialize()
                dt = time.perf_counter() - t0
                counts = dict(LAUNCHES)
                for k in env:
                    del os.environ[k]
                st = p.align_stage.stats
                shown = ", ".join(f"{t}: {c}" for t, c in sorted(
                    st["tier_items"].items(),
                    key=lambda tc: (tc[0] == -1, str(tc[0]))))
                log(f"[align] {data} {route}: initialize {dt:.3f} s; items "
                    f"per tier {shown} (-1 = beyond the tiers); host "
                    f"{st['host_items']}/{st['items']} overlaps "
                    f"({100 * st['host_items'] / max(1, st['items']):.3f}"
                    f"%); launches {counts}")
                record_launches(results, f"align_{route}_{data}", counts)
                for k, c in counts.items():
                    launched[route][k] = launched[route].get(k, 0) + c
                if route == "scored":
                    wide += sum(c for t, c in st["tier_items"].items()
                                if t != -1 and t[1] == 4096)
                runs[route] = dict(seen, host=st["host_items"])
            a = runs["myers"]
            for route in runs:
                if route == "myers":
                    continue
                b = runs[route]
                # a host-aligned overlap would break ties otherwise than
                # the device walks; no route sends one here
                if a["host"] or b["host"]:
                    raise SmokeFailure(
                        f"{data}: overlaps aligned on the host: "
                        f"{a['host']} (Myers), {b['host']} ({route})")
                if a["indices"] != b["indices"]:
                    raise SmokeFailure(f"{data}: the Myers and {route} runs "
                                       "aligned different overlaps")
                differ = [i for i, x, y in zip(a["indices"], a["points"],
                                               b["points"])
                          if not np.array_equal(x, y)]
                log(f"[align] {data} {route}: breaking points of all "
                    f"{len(a['indices'])} overlaps: "
                    f"{len(a['indices']) - len(differ)} equal to the Myers "
                    f"route's, {len(differ)} differ")
                if differ:
                    raise SmokeFailure(f"{data} {route}: breaking points "
                                       f"differ on overlaps {differ[:20]}")
    finally:
        TorchAlignStage.breaking_points = real
        for k in scored_env:
            os.environ.pop(k, None)
    need = ("nw_sweep_block", "rows_walk", "nw_sweep_wide", "packed_walk")
    missing = [k for k in need if not launched["scored"][k]]
    if (missing or launched["scored"]["myers_sweep"]
            or not launched["myers"]["myers_sweep"]):
        raise SmokeFailure(f"scored align route launched "
                           f"{launched['scored']}, Myers route "
                           f"{launched['myers']}")
    if not wide:
        raise SmokeFailure("no item in a W = 4096 tier")
    log(f"[align] scored route: {wide} items in W = 4096 tiers; launches "
        f"{launched['scored']}")
    if not launched["scored16"].get("nw_sweep_block16"):
        raise SmokeFailure(f"the RACON_TPU_DP16=1 scored route launched "
                           f"{launched['scored16']}")
    results["nw_sweep_block16"]["launches"] = \
        launched["scored16"]["nw_sweep_block16"]
    log(f"[align] scored route under RACON_TPU_DP16=1: launches "
        f"{launched['scored16']}")
    # the block sweep's launches: the default path's where its consensus
    # tiers above W = 256 ran, else the scored align route's
    if not results["nw_sweep_block"]["launches"]:
        results["nw_sweep_block"]["launches"] = \
            launched["scored"]["nw_sweep_block"]


def _sweep_t_bound(B, m_cap, n_cap, W, variant):
    """(least ms, what bounds it) of one panel-sweep variant on B items,
    by what that variant must read, compute and write
    (profile_ablate.variant_work)."""
    from racon_tpu_torch.benchmarks.profile_ablate import variant_work

    return bound(*variant_work(B, m_cap, n_cap, W, variant, OPS_SWEEP_CELL))


def phase_ablate(results):
    """Phase 7: the ablation harness at the JAX harness's default shape,
    with the counts reset just before it; then each panel-sweep launch of
    its run against its plain version on the first 256 items, K7 against
    K1 on the same items packed, and the fused line against the walk."""
    import torch

    from racon_tpu_torch.benchmarks import profile_ablate as pa
    from racon_tpu_torch.kernels import LAUNCHES, reset_launches
    from racon_tpu_torch.ops import nw_kernel as nk
    from racon_tpu_torch.ops.batch import to_device

    B, cap, W, n = 8192, 640, 128, 256
    geo = dict(m_cap=cap, n_cap=cap, w_band=W)
    inp = pa.make_inputs(B, cap, W)
    reset_launches()
    lines = pa.run_lines(inp, "cuda", out=lambda s: log(f"[ablate] {s}"))
    torch.cuda.synchronize()
    counts = dict(LAUNCHES)
    log(f"[ablate] launches {counts}")
    record_launches(results, "ablate", counts)
    if not (counts["nw_sweep_t"] and counts["nw_ablate"]):
        raise SmokeFailure(f"the harness launched {counts}")
    for k in ("nw_sweep_t", "nw_ablate"):
        results[k]["launches"] = counts[k]
        # the warp kernel at the harness's W = 128 (four lanes a thread):
        # K7 is <4,1,1,1,0>, the K8 variants every instantiation
        results[k]["ptxas"] = {
            x: v for x, v in PTXAS.items()
            if x.startswith("nw_sweep_t_warp_kernel<4,")
            and (k == "nw_ablate" or x.endswith("<4,1,1,1,0>"))}
    cpu = [torch.from_numpy(inp[k][:n]) for k in ("q", "tp", "gcp")]
    checks = [("nw_ablate", v, v, lambda v=v: pa.run_variant_plain(
        *cpu, **geo, variant=v)) for v in pa.VARIANTS]
    checks.append(("nw_sweep_t", "nwonly", "full", lambda: nk.nw_sweep_t_plain(
        *cpu, **geo, **pa.SCORES)))
    for name, line, v, plain in checks:
        ms, (moves, score) = lines[line]
        (pm, ps), plain_ms = host_ms(plain)
        err = compare(f"{line} score", score[:n], ps)
        if v != "nomoves":
            err = max(err, compare(f"{line} moves", moves[:n], pm))
        bms, by = _sweep_t_bound(B, cap, cap, W, v)
        log(f"[ablate] {line} ({cap},{W}) B={B}: byte-equal on the first "
            f"{n} items{' (score only)' if v == 'nomoves' else ''}; "
            f"{ms:.3f} ms (bound {bms:.5f} ms by {by}; plain CPU "
            f"{plain_ms:.1f} ms for {n} items)")
        numbers = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                       bound_ms=bms, bound_by=by)
        results[name]["shapes"].append(dict(shape=[cap, W, B], variant=line,
                                             plain_items=n, **numbers))
        if v == "full":
            results[name].update(numbers)
    k7_moves, k7_score = lines["nwonly"][1]
    pk = to_device(inp["q4"], inp["t4"], inp["dcb"], inp["m"], inp["n"],
                   m_cap=cap, n_cap=cap, device="cuda")
    k1_moves, k1_score = nk.nw_sweep(pk.q4, pk.t4, pk.dcb, **geo,
                                     **pa.SCORES)
    compare("nw_sweep_t moves vs nw_sweep's", k7_moves, k1_moves.cpu())
    compare("nw_sweep_t score vs nw_sweep's", k7_score, k1_score.cpu())
    payload, _, fmt = lines["fused+h2d"][1]
    compare(f"fused+h2d {fmt} payload vs walkonly's", payload,
            lines["walkonly"][1].cpu())
    k1_ms, _ = pa.timed(lambda: nk.nw_sweep(pk.q4, pk.t4, pk.dcb, **geo,
                                            **pa.SCORES), "cuda")
    bs, bys = _sweep_bound(B, cap, W)
    results["nw_sweep"]["shapes"].append(dict(
        shape=[cap, W, B], scores="ablation harness", ms=k1_ms, bound_ms=bs,
        bound_by=bys))
    k7_ms = lines["nwonly"][0]
    log(f"[ablate] K7 byte-equal to K1 (nw_sweep) on all {B} items packed; "
        f"K1 on them {k1_ms:.3f} ms (median of 5, bound {bs:.5f} ms by "
        f"{bys}) against K7's {k7_ms:.3f} ms: K1 {k7_ms / k1_ms:.2f}x "
        f"faster; the fused line's {fmt} payload equals the walk-only "
        f"line's")


# phase 9's kF dataset: genome (Mb) and read length, 20x coverage. At
# 0.2 Mb the cuda and native runs took 116 s together (NVIDIA H100 80GB
# HBM3 and its 8 host cores, the native run 100 s of it), above the 60 s
# they may take
KF_GENOME_MB = 0.1
KF_READ_LEN = 30000
# the Myers kernels' kF tier: all-vs-all overlaps of 30 kb reads
KF_TIER = (40960, 1024)


def phase_modes(wd, threads, results):
    """Phase 9: racon's other modes on the card. K3 and K4 at the kF tier;
    kF through the port's genome_scale against the native backend; SAM
    with CIGARs and FASTQ with MHAP against the plain versions; the
    companion tools' wrapper against the CLI."""
    import numpy as np

    from racon_tpu_torch.ops.align_stage import _chunk_size

    cap, band = KF_TIER
    myers_shape(results, cap, band, _chunk_size(cap, band, True),
                np.random.default_rng(cap), 8, " (the kF tier's align chunk)")
    _modes_kf(os.path.join(wd, "kf"), threads, results)
    _modes_formats(os.path.join(wd, "formats"), threads, results)
    _modes_wrapper(os.path.join(wd, "wrapper"), threads, results)


def _modes_kf(wd, threads, results):
    """Fragment correction (racon -f) of make_dataset(KF_GENOME_MB, 20x
    30 kb reads, 12 % error, ava=True) through the port's genome_scale kf
    path, with --backend cuda, then native on the same data: the cuda run
    must launch K3, K4, K1 and J1, align every overlap at the kF tier or
    below and none on the host for want of a tier, and correct the reads
    by >= 5 identity points and to within 0.05 of native's identity."""
    from racon_tpu_torch.benchmarks import genome_scale
    from racon_tpu_torch.kernels import LAUNCHES, reset_launches

    recs = {}
    t_all = time.perf_counter()
    for backend in ("cuda", "native"):
        a = genome_scale.parser().parse_args([
            "--mode", "kf", "--genome-mb", str(KF_GENOME_MB), "--read-len",
            str(KF_READ_LEN), "--backend", backend, "--threads", str(threads),
            "--workdir", wd, *(["--reuse-data"] if backend == "native"
                               else [])])
        reset_launches()
        rec = genome_scale.run(a)
        counts = dict(LAUNCHES)
        recs[backend] = rec
        log(f"[kf] --backend {backend}: initialize {rec['initialize_s']:.3f} "
            f"s, polish {rec['polish_s']:.3f} s, {rec['windows']} windows, "
            f"{rec['reads_corrected']} reads corrected; identity "
            f"{rec['identity_pct']:.4f}% (raw "
            f"{rec['raw_read_identity_pct']:.4f}%); launches {counts}")
        if backend == "cuda":
            record_launches(results, "kf", counts)
            missing = [k for k in MAIN_KERNELS if not counts[k]]
            if missing:
                raise SmokeFailure(f"kF never launched {missing}")
            tiers = rec["align_tier_items"]
            log(f"[kf] align stage: {rec['align_items']} overlaps, per tier "
                f"{tiers}, {rec['align_host_items']} on the host (band "
                f"escapes); peak device memory "
                f"{rec['peak_device_bytes'] / 2**30:.3f} GiB")
            wide = [t for t in tiers if t["tier"] is None
                    or t["tier"][0] > KF_TIER[0] or t["tier"][1] > KF_TIER[1]]
            if wide:
                raise SmokeFailure(f"kF overlaps above the {KF_TIER} tier: "
                                   f"{wide}")
    dt = time.perf_counter() - t_all
    cuda, native = recs["cuda"], recs["native"]
    log(f"[kf] both runs {dt:.1f} s with the dataset; identity cuda "
        f"{cuda['identity_pct']:.4f}%, native {native['identity_pct']:.4f}%, "
        f"raw {cuda['raw_read_identity_pct']:.4f}%")
    if cuda["identity_pct"] < cuda["raw_read_identity_pct"] + 5:
        raise SmokeFailure("kF corrected the reads by less than 5 points")
    if cuda["identity_pct"] < native["identity_pct"] - 0.05:
        raise SmokeFailure("kF on the card is more than 0.05 points below "
                           "native's identity")


def _modes_formats(wd, threads, results):
    """make_cigar_dataset(50 kb, 20x 2 kb reads, 12 % error): SAM with
    CIGARs (breaking points from the CIGARs: K1 and J1, no Myers kernel,
    no item to the align stage) and FASTQ reads with MHAP overlaps under
    -q 10 (K3, K4, K1 and J1), each polished on the card and with the
    plain versions (device="cpu"): the FASTA byte-equal, and closer to
    the truth than the draft."""
    from racon_tpu_torch import cli
    from racon_tpu_torch.kernels import LAUNCHES, reset_launches
    from racon_tpu_torch.polisher import create_polisher
    from racon_tpu_torch.testing.synth import make_cigar_dataset

    os.makedirs(wd)
    true = make_cigar_dataset(wd, 50_000, 2000, 20, 0.12)
    with open(os.path.join(wd, "draft.fasta"), "rb") as f:
        draft = f.read().split(b"\n")[1]
    for tag, files, extra, want in (
            ("sam", ("reads.fasta", "ovl.sam"), [],
             ("nw_sweep", "rle_walk")),
            ("mhap_fastq", ("reads.fastq", "ovl.mhap"), ["-q", "10"],
             MAIN_KERNELS)):
        args = cli.parser().parse_args([
            *POLISH_ARGV, "-t", str(threads), *extra,
            *(os.path.join(wd, f) for f in (*files, "draft.fasta"))])
        cfg = cli.make_config(args)
        outs, times = {}, {}
        for device in (None, "cpu"):
            reset_launches()
            t0 = time.perf_counter()
            with contextlib.redirect_stderr(io.StringIO()):
                p = create_polisher(*args.inputs, cfg, device=device)
                p.initialize()
                outs[device] = p.polish(True)
            times[device] = time.perf_counter() - t0
            if device is None:
                counts, stats = dict(LAUNCHES), p.align_stage.stats
        record_launches(results, tag, counts)
        log(f"[{tag}] on the card {times[None]:.3f} s, plain versions "
            f"{times['cpu']:.3f} s; align stage {stats['items']} items "
            f"({stats['host_items']} on the host); launches {counts}")
        if outs[None] != outs["cpu"] or len(outs[None]) != 1:
            raise SmokeFailure(f"{tag}: the card's FASTA differs from the "
                               "plain versions'")
        missing = [k for k in want if not counts[k]]
        if missing or (tag == "sam" and (
                stats["items"] or counts["myers_sweep"]
                or counts["myers_walk"])):
            raise SmokeFailure(f"{tag}: launches {counts}, align stage "
                               f"{stats['items']} items")
        before = _identity(tag, "draft", draft, true)
        after = _identity(tag, "polished", outs[None][0][1], true)
        if not after > before:
            raise SmokeFailure(f"{tag}: polished identity {after:.4f}% does "
                               f"not beat the draft's {before:.4f}%")


def _stdout_of(fn):
    """(fn()'s return value, the bytes it wrote to sys.stdout.buffer);
    its stderr is dropped."""
    buf = io.BytesIO()
    text = io.TextIOWrapper(buf, write_through=True)
    with contextlib.redirect_stdout(text), \
            contextlib.redirect_stderr(io.StringIO()):
        try:
            rc = fn()
        except SystemExit as e:
            rc = e.code
    text.flush()
    return rc, buf.getvalue()


def _modes_wrapper(wd, threads, results):
    """`raconx-torch-tools wrapper --split` on the card, on make_dataset
    (0.2 Mb, 20x 8 kb reads, 12 % error, seed 11) with its contig cut in
    two targets (the overlaps across the cut dropped): two splits, the
    stdout equal to the CLI's FASTA on each split in turn, and the work
    directory removed."""
    from racon_tpu_torch import cli
    from racon_tpu_torch.kernels import LAUNCHES, reset_launches
    from racon_tpu_torch.testing.synth import make_dataset
    from racon_tpu_torch.tools import cli as tools_cli
    from racon_tpu_torch.tools import rampler

    os.makedirs(wd)
    make_dataset(wd, 200_000, 8000, 20, 0.12, seed=11)
    with open(os.path.join(wd, "draft.fasta"), "rb") as f:
        draft = f.read().split(b"\n")[1]
    h = len(draft) // 2
    lines = []
    with open(os.path.join(wd, "ovl.paf"), "rb") as f:
        for line in f:
            c = line.rstrip(b"\n").split(b"\t")
            s, e = int(c[7]), int(c[8])
            if e <= h:
                c[5:9] = [b"ctg_a", b"%d" % h, c[7], c[8]]
            elif s >= h:
                c[5:9] = [b"ctg_b", b"%d" % (len(draft) - h), b"%d" % (s - h),
                          b"%d" % (e - h)]
            else:
                continue
            lines.append(b"\t".join(c) + b"\n")
    with open(os.path.join(wd, "two.paf"), "wb") as f:
        f.write(b"".join(lines))
    with open(os.path.join(wd, "two.fasta"), "wb") as f:
        f.write(b">ctg_a\n%s\n>ctg_b\n%s\n" % (draft[:h], draft[h:]))
    inputs = [os.path.join(wd, f) for f in ("reads.fasta", "two.paf",
                                            "two.fasta")]
    cwd = os.getcwd()
    os.chdir(wd)  # the wrapper's work directory goes there
    try:
        reset_launches()
        t0 = time.perf_counter()
        rc, got = _stdout_of(lambda: tools_cli.main([
            "wrapper", "--split", str(h), "--backend", "cuda", "-t",
            str(threads), *inputs]))
        dt = time.perf_counter() - t0
        counts = dict(LAUNCHES)
        left = [d for d in os.listdir(wd)
                if d.startswith("racon_work_directory_")]
    finally:
        os.chdir(cwd)
    record_launches(results, "wrapper", counts)
    splitdir = os.path.join(wd, "splits")
    os.makedirs(splitdir)
    want = []
    for part in rampler.split(inputs[2], h, splitdir):
        rc_cli, out = _stdout_of(lambda: cli.main([
            *POLISH_ARGV, "-t", str(threads), *inputs[:2], part]))
        if rc_cli:
            raise SmokeFailure(f"raconx-torch on {part} exited {rc_cli}")
        want.append(out)
    log(f"[wrapper] --split {h} on two targets ({len(lines)} overlaps): "
        f"exit {rc}, {dt:.3f} s, {len(got)} bytes on stdout, "
        f"{len(want)} splits; launches {counts}")
    if rc or left:
        raise SmokeFailure(f"wrapper exited {rc}, work directories {left}")
    if len(want) != 2 or got != b"".join(want):
        raise SmokeFailure("the wrapper's stdout is not the CLI's FASTA on "
                           "each split")
    missing = [k for k in MAIN_KERNELS if not counts[k]]
    if missing:
        raise SmokeFailure(f"the wrapper never launched {missing}")


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
    from racon_tpu_torch.benchmarks import kernel_ab

    state = {}  # what phases 3 and 4 leave for phases 8 and 10
    with tempfile.TemporaryDirectory() as tmp:
        procs = start_ptxas(tmp)
        # J6's empty kernel of the same grid, for phase 10's floor
        floor, floor_so = kernel_ab.start_gather_variants(
            tmp, ("empty",))["empty"]
        try:
            build.kernels()
            log(f"[build] kernels built and loaded in "
                f"{build.build_seconds:.1f} s")
            ptxas_report(procs)
            if floor.wait():
                raise SmokeFailure("the empty gather kernel did not build")
            state["gather_empty"] = kernel_ab.load(floor_so)
        except SmokeFailure as e:
            sys.stderr.write(f"chip_smoke: FAILED: {e}\n")
            return 1
        finally:
            for proc in (*procs.values(), floor):
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
    threads = os.cpu_count() or 8
    # the keys of the contract, from one shape and one main-path run each,
    # then every shape phase 2 measured and every run's launches
    results = {k: {"name": k, "route": "cuda", "source": src,
                   "replaces": rep, "launches": 0, "max_abs_err": None,
                   "ms": None, "plain_ms": None, "bound_ms": None,
                   "bound_by": None, "library_ms": None, "shapes": [],
                   "launches_by_path": {}}
               for k, (src, rep) in KERNELS.items()}
    t0 = time.perf_counter()
    try:
        with tempfile.TemporaryDirectory() as wd4, \
                tempfile.TemporaryDirectory() as wd5, \
                tempfile.TemporaryDirectory() as wd6, \
                tempfile.TemporaryDirectory() as wd9:
            for phase in (lambda: phase_kernels(results, threads),
                          lambda: phase_kernels16(results),
                          lambda: phase_bench(threads, results, state),
                          lambda: phase_polish(wd4, args.genome_mb, threads,
                                               results, state),
                          lambda: phase_multi(wd4, threads, results, state),
                          lambda: phase_gather(wd4, threads, results, state),
                          lambda: phase_wide(wd5, args.wide_genome_mb,
                                             threads, results),
                          lambda: phase_align(
                              [("w500", wd4, POLISH_ARGV),
                               ("w500_2kb", short_reads(wd6), POLISH_ARGV),
                               ("w10000", wd5, WIDE_ARGV)], threads,
                              results),
                          lambda: phase_ablate(results),
                          lambda: phase_modes(wd9, threads, results)):
                phase()
                log(f"[time] {time.perf_counter() - t0:.1f} s since the "
                    "build")
        unlaunched = [k for k, r in results.items() if not r["launches"]]
        if unlaunched:
            raise SmokeFailure(f"no main-path launches recorded for "
                               f"{unlaunched}")
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

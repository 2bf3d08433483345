"""The Myers sweep (K3, kernels/csrc/myers_sweep.cu), the RLE walk (J1,
kernels/csrc/rle_walk.cu), the scored sweep's strip kernel (K2 and K5,
kernels/csrc/nw_sweep.cu at W > 256), the packed2 walk (J4,
kernels/csrc/packed_walk.cu), the rows walk (K6,
kernels/csrc/rows_walk.cu), the panel sweep and its ablation variants
(K7, K8, kernels/csrc/nw_sweep_t.cu), the int16 sweeps (K1-16 and K2-16,
kernels/csrc/nw_sweep16.cu), the Myers plane-to-move transform (J5,
kernels/csrc/myers_moves.cu) and the row gather (J6,
kernels/csrc/pack_gather.cu) of this checkout against those of another
version of the sources, on one card, timed in turns:

    python -m racon_tpu_torch.benchmarks.kernel_ab OTHER_CSRC [--json PATH]
        [--only myers_sweep rle_walk strip walks sweep_t sweep16 moves
                gather]

OTHER_CSRC is a directory holding the other version's myers_sweep.cu,
rle_walk.cu, nw_sweep.cu, packed_walk.cu, rows_walk.cu, nw_sweep_t.cu,
nw_sweep16.cu, myers_moves.cu, pack_gather.cu, sweep_scan.cuh and
common.cuh (for
example unpacked with `git archive <commit>
racon_tpu_torch/kernels/csrc | tar -x`); a file it lacks is taken from
this checkout, so that a directory of one variant source (such as
benchmarks/variants/rows_walk_producer/) builds against the rest of this
version. Both versions are built alike, by nvcc into a shared library
of their plain C launchers bound with ctypes, and fed the same inputs (seed 7: every 7th item all PAD, every
11th cut short so that it leaves the band). Per shape: both outputs byte
for byte on every item, then CUDA-event ms (mean of 5 launches after a
warm-up) in the order other, this, this, other; each version's mean, us
per item and the share of the bound (the least time, as chip_smoke.py
computes it: bytes over 3.35 TB/s or INT32 ops over 16.73 T/s, whichever
is larger). Shapes: K3 at (10240,1024) B = 409 (the align stage's former
chunk) and B = 1024 (its chunk now), (2560,512) B = 1024 and
(10240,4096) B = 409; J1 at (640,128) B = 4096 and 4097, with the steps
its items take (one move word each) and the longest walk's, and this
build's time over that walk's steps; the strip sweep at K2's
(10240,1024) B = 4 and B = 409 (the align stage's scored chunk) with the
align scores (0/-1/-1, every column's deletion bit set) and (5120,1024)
B = 8 with the consensus scores (5/-4/-8, 30 % free deletion columns),
and at K5's (10240,2048) B = 16 and B = 204 (the consensus chunk) with
the consensus scores and (10240,4096) B = 4 and (40960,4096) B = 25 (the
align chunk) with the align scores: besides, its us a query row and the
per-SM floor (15 ops a cell over an SM's 64 INT32 lanes at 1.98 GHz, the
items of an SM one after another). The packed2 walk at K5's four shapes
and the rows walk at (640,128) B = 4096 (consensus scores) and
(10240,1024) B = 4 and B = 409 (align scores), on this build's sweep of
the same items (seed 14): besides, the steps (rows) of the longest walk
and each build's us a step (row) of it; their bound counts each distinct
move word the walk's path needs (ops/walk_work, as chip_smoke.py does).
The panel sweep: every variant (full = K7, noclosure, nomoves, noload,
empty) at the ablation harness's (640,128) B = 8192 on its items
(profile_ablate.make_inputs), each against its work
(profile_ablate.variant_work), and this build's K1 (nw_sweep) on the same
items packed, byte-equal to K7 and timed beside it. The int16 warp sweep
at (640,128) B = 4096 and (256,128) B = 4097 with the consensus scores
(30 % free deletion columns), both builds against this build's int32 K1
on every item, K1 timed beside them, and the int16 strip sweep at
(2560,512) B = 1024 with the align scores (every deletion bit set; the
scored align route's 2 kb tier), both builds against this build's int32
strip kernel on every item, timed beside them; their bound counts two
cells a 16x2 instruction. J5 at (10240,1024) B = 1024 and (40960,1024)
B = 409 (the Myers "rle" payload's chunks) on planes this build's K3
makes of seed 17's items; its bound counts the plane words of the
tiles that hold a valid cell (geometry.moves_live_tiles) read and every
move word written, or 40 ops a move word of those tiles (the whole
planes' bound beside it). J6 (`gather`, kernels/csrc/pack_gather.cu) at
the gather route's chunks (640,128) B = 4096, (256,128) B = 4097 and
(5120,1024) B = 8 on gather_items' inputs (seed 1476, as chip_smoke.py's
phase 10), beside this build's variants (the unit rule fixed at "row",
"pair" and "item", and the empty kernel of the same grid: the floor of a
launch), every build but the empty one byte-equal to pack_gather_plain;
times a launch inside a CUDA graph of 20 (graph_ms) in the order of the
builds and back; the share of the bound (chip_smoke.py's bytes) and of
the bound over the time above the floor; and the host's us of one
gather.pack_gather call split into allocation, binding and launch
(perf_counter, _host_split), the parent's three allocations beside them.

Needs nvcc and a CUDA device (exit 2 without one). Prints the card's
name and power limit first and one JSON line last.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
import tempfile

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_HERE, "..", "kernels", "csrc")
SOURCES = ("myers_sweep.cu", "rle_walk.cu", "nw_sweep.cu", "packed_walk.cu",
           "rows_walk.cu", "nw_sweep_t.cu", "nw_sweep16.cu", "myers_moves.cu",
           "pack_gather.cu")
ARCH = "-gencode=arch=compute_90a,code=sm_90a"
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 132 * 64 * 1.98e9
OPS_MYERS_WORD = 20
OPS_WALK_STEP = 12
OPS_SWEEP_CELL = 15
OPS_MOVES_WORD = 40
CELLS_PER_OP16 = 2   # the int16 sweep: two cells per 16x2 instruction
SMS, SM_INT32_OPS_PER_S = 132, 64 * 1.98e9


def start_build(csrc: str, out: str, sources) -> subprocess.Popen:
    """Start nvcc on `sources` of `csrc` into `out`; a source or header
    that `csrc` lacks comes from this checkout's."""
    from torch.utils.cpp_extension import CUDA_HOME

    nvcc = os.path.join(CUDA_HOME or "/usr/local/cuda", "bin", "nvcc")
    srcs = [os.path.join(csrc if os.path.exists(os.path.join(csrc, s))
                         else CSRC, s) for s in sources]
    return subprocess.Popen([nvcc, ARCH, "-std=c++17", "-O3", "-shared",
                             "-Xcompiler", "-fPIC", "-I", csrc, "-I", CSRC,
                             "-o", out, *srcs])


def load(out: str) -> ctypes.CDLL:
    """The built library at `out`, the launchers it holds typed."""
    lib = ctypes.CDLL(out)
    P, I = ctypes.c_void_p, ctypes.c_int
    sigs = {"rtt_myers_sweep": [P] * 3 + [I] * 4 + [P],
            "rtt_rle_walk": [P] * 4 + [I] * 5 + [P],
            "rtt_nw_sweep": [P] * 5 + [I] * 8 + [P],
            "rtt_packed_walk": [P] * 4 + [I] * 5 + [P],
            "rtt_rows_walk": [P] * 4 + [I] * 4 + [P],
            "rtt_nw_sweep_t": [P] * 5 + [I] * 9 + [P],
            "rtt_nw_sweep16": [P] * 5 + [I] * 9 + [P],
            "rtt_myers_moves": [P] * 3 + [I] * 4 + [P],
            "rtt_pack_gather": [P, I, P, I, P, I] + [P] * 4 + [I] * 3 + [P]}
    for name, argtypes in sigs.items():
        fn = getattr(lib, name, None)
        if fn is not None:
            fn.argtypes = argtypes
            fn.restype = I
    return lib


def items(rng, B, cap, w_band):
    """(q4, t4, m, n) of B mutated read pairs at cap (4 % each of
    substitutions, insertions and deletions)."""
    from racon_tpu_torch.ops.geometry import PAD_CODE, encode

    acgt = np.frombuffer(b"ACGT", np.uint8)
    q8 = np.full((B, cap), PAD_CODE, np.uint8)
    t8 = np.full((B, cap), PAD_CODE, np.uint8)
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
    return (q8[:, 0::2] | (q8[:, 1::2] << 4),
            t8[:, 0::2] | (t8[:, 1::2] << 4), m, n)


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


def bound_ms(nbytes: float, nops: float) -> tuple[float, str]:
    tb = 1e3 * nbytes / HBM_BYTES_PER_S
    to = 1e3 * nops / INT32_OPS_PER_S
    return (tb, "bytes") if tb >= to else (to, "operations")


def ptr(t):
    return ctypes.c_void_p(t.data_ptr())


def in_turns(name, shape, B, libs, run, out, bound):
    """Outputs of both builds byte for byte, then other, this, this,
    other; one result row."""
    import torch

    outs = {}
    for tag, lib in libs.items():
        out().fill_(0x55)  # a byte either build leaves unwritten differs
        run(lib)
        torch.cuda.synchronize()
        outs[tag] = out().clone()
    if not torch.equal(outs["this"], outs["other"]):
        raise SystemExit(f"{name} {shape} B={B}: the two builds differ")
    times = {"other": [], "this": []}
    for tag in ("other", "this", "this", "other"):
        times[tag].append(cuda_ms(lambda: run(libs[tag])))
    bms, by = bound
    row = {"kernel": name, "shape": list(shape), "B": B,
           "bound_ms": bms, "bound_by": by, "byte_equal": True}
    for tag, ts in times.items():
        ms = sum(ts) / len(ts)
        row[tag] = {"ms_runs": ts, "ms": ms, "us_per_item": 1e3 * ms / B,
                    "bound_share": bms / ms}
    print(f"{name} {shape} B={B}: other {row['other']['ms']:.4f} ms "
          f"{times['other']}, this {row['this']['ms']:.4f} ms "
          f"{times['this']} ({row['other']['ms'] / row['this']['ms']:.2f}x);"
          f" {row['this']['us_per_item']:.3f} us an item, bound "
          f"{bms:.4f} ms by {by} ({100 * row['this']['bound_share']:.1f} % "
          f"of it)", flush=True)
    return row


def strip_sweeps(libs, rng, stream):
    """The strip sweep (K2, K5) of both builds at the stages' shapes."""
    import torch

    from racon_tpu_torch.ops.batch import to_device
    from racon_tpu_torch.ops.geometry import scan_span

    consensus, align = (5, -4, -8), (0, -1, -1)
    rows = []
    for cap, W, B, sc in ((10240, 1024, 4, align), (10240, 1024, 409, align),
                          (5120, 1024, 8, consensus),
                          (10240, 2048, 16, consensus),
                          (10240, 2048, 204, consensus),
                          (10240, 4096, 4, align),
                          (40960, 4096, 25, align)):
        q4, t4, m, n = items(rng, B, cap, W)
        dcb = np.packbits(rng.random((B, cap)) >= 0.3, axis=1,
                          bitorder="little")
        if sc == align:
            dcb[:] = 0xFF
        g = to_device(q4, t4, dcb, m, n, m_cap=cap, n_cap=cap,
                      device="cuda")
        # moves (B, cap/16, W) and score (B,) in one buffer, so that one
        # comparison covers both
        nmv = B * (cap // 16) * W
        buf = torch.empty(nmv + B, dtype=torch.int32, device="cuda")

        def sweep(lib):
            rc = lib.rtt_nw_sweep(ptr(g.q4), ptr(g.t4), ptr(g.dcb),
                                  ptr(buf), ptr(buf[nmv:]), B, cap, cap, W,
                                  *sc, scan_span(W), stream())
            if rc:
                raise SystemExit(f"rtt_nw_sweep: error {rc}")

        nbytes = B * (cap // 2 + cap // 2 + cap // 8) + 4 * (nmv + B)
        row = in_turns("nw_sweep_block" if W <= 1024 else "nw_sweep_wide",
                       (cap, W), B, libs, sweep, lambda: buf,
                       bound_ms(nbytes, B * cap * W * OPS_SWEEP_CELL))
        # one item an SM: its rows one after another at the SM's INT32 rate
        floor_row = 1e6 * OPS_SWEEP_CELL * W / SM_INT32_OPS_PER_S
        floor_ms = -(-B // SMS) * cap * floor_row / 1e3
        row.update(us_per_row={k: 1e3 * row[k]["ms"] / cap
                               for k in ("other", "this")},
                   sm_floor_us_per_row=floor_row, sm_floor_ms=floor_ms,
                   sm_floor_share={k: floor_ms / row[k]["ms"]
                                   for k in ("other", "this")})
        print(f"  {cap} rows: other {row['us_per_row']['other']:.4f}, this "
              f"{row['us_per_row']['this']:.4f} us a row; per-SM floor "
              f"{floor_row:.4f} us a row, {floor_ms:.4f} ms "
              f"({100 * row['sm_floor_share']['this']:.1f} % of it)",
              flush=True)
        rows.append(row)
        del buf, g
        torch.cuda.empty_cache()
    return rows


WALK_SHAPES = (("packed_walk", 10240, 2048, 16, "consensus"),
               ("packed_walk", 10240, 2048, 204, "consensus"),
               ("packed_walk", 10240, 4096, 4, "align"),
               ("packed_walk", 40960, 4096, 25, "align"),
               ("rows_walk", 640, 128, 4096, "consensus"),
               ("rows_walk", 10240, 1024, 4, "align"),
               ("rows_walk", 10240, 1024, 409, "align"))


def walks(libs, rng, stream):
    """The packed2 and rows walks of both builds on this build's sweep of
    the same items, drawn from their own generator (seed 14), so that
    they do not depend on the sections timed before them."""
    import torch

    from racon_tpu_torch.ops.batch import to_device
    from racon_tpu_torch.ops.geometry import scan_span, walk_steps
    from racon_tpu_torch.ops.walk_work import (packed_path, rows_path,
                                               walk_units)

    rng = np.random.default_rng(14)
    scores = {"consensus": (5, -4, -8), "align": (0, -1, -1)}
    rows = []
    for name, cap, W, B, kind in WALK_SHAPES:
        sc = scores[kind]
        q4, t4, m, n = items(rng, B, cap, W)
        dcb = np.packbits(rng.random((B, cap)) >= 0.3, axis=1,
                          bitorder="little")
        if kind == "align":
            dcb[:] = 0xFF
        g = to_device(q4, t4, dcb, m, n, m_cap=cap, n_cap=cap,
                      device="cuda")
        moves = torch.empty((B, cap // 16, W), dtype=torch.int32,
                            device="cuda")
        score = torch.empty(B, dtype=torch.int32, device="cuda")
        rc = libs["this"].rtt_nw_sweep(ptr(g.q4), ptr(g.t4), ptr(g.dcb),
                                       ptr(moves), ptr(score), B, cap, cap,
                                       W, *sc, scan_span(W), stream())
        if rc:
            raise SystemExit(f"rtt_nw_sweep: error {rc}")
        S = walk_steps(cap, cap, W)
        width = S // 4 + 1 if name == "packed_walk" else cap + 2
        payload = torch.empty((B, width), dtype=torch.uint8, device="cuda")

        def walk(lib):
            if name == "packed_walk":
                rc = lib.rtt_packed_walk(ptr(moves), ptr(g.m), ptr(g.n),
                                         ptr(payload), B, cap, cap, W, S,
                                         stream())
            else:
                rc = lib.rtt_rows_walk(ptr(moves), ptr(g.m), ptr(g.n),
                                       ptr(payload), B, cap, cap, W,
                                       stream())
            if rc:
                raise SystemExit(f"rtt_{name}: error {rc}")

        walk(libs["this"])
        torch.cuda.synchronize()
        longest = int(walk_units(payload, name, m).max())
        # bytes: m and n, the payload, and each distinct move word the
        # walk's path needs (16 rows of one lane); 12 ops a step (row)
        path = packed_path if name == "packed_walk" else rows_path
        total, nwords = path(payload.cpu(), m, n, cap, W)
        row = in_turns(name, (cap, W), B, libs, walk, lambda: payload,
                       bound_ms(4 * nwords + B * (8 + width),
                                total * OPS_WALK_STEP))
        unit = "step" if name == "packed_walk" else "row"
        row.update(units=total, unit=unit, move_words=nwords,
                   longest=longest,
                   us_per_unit_of_longest={
                       k: 1e3 * row[k]["ms"] / longest
                       for k in ("other", "this")})
        print(f"  {total} {unit}s, the longest walk {longest}: other "
              f"{row['us_per_unit_of_longest']['other']:.5f}, this "
              f"{row['us_per_unit_of_longest']['this']:.5f} us a {unit}",
              flush=True)
        rows.append(row)
        del moves, payload, g
        torch.cuda.empty_cache()
    return rows


def myers_sweeps(libs, rng, stream):
    """The Myers sweep (K3) of both builds at the align stage's shapes."""
    import torch

    from racon_tpu_torch.ops.batch import to_device

    rows = []
    for cap, W, B in ((10240, 1024, 409), (10240, 1024, 1024),
                      (2560, 512, 1024), (10240, 4096, 409)):
        q4, t4, m, n = items(rng, B, cap, W)
        g = to_device(q4, t4, None, m, n, m_cap=cap, n_cap=cap,
                      device="cuda")
        planes = torch.empty((B, cap, 2, W // 32), dtype=torch.int32,
                             device="cuda")

        def sweep(lib):
            rc = lib.rtt_myers_sweep(ptr(g.q4), ptr(g.t4), ptr(planes),
                                     B, cap, cap, W, stream())
            if rc:
                raise SystemExit(f"rtt_myers_sweep: error {rc}")

        nbytes = B * cap + B * cap * 2 * (W // 32) * 4
        rows.append(in_turns(
            "myers_sweep", (cap, W), B, libs, sweep, lambda: planes,
            bound_ms(nbytes, B * cap * (W // 32) * OPS_MYERS_WORD)))
        del planes, g
        torch.cuda.empty_cache()
    return rows


def rle_walks(libs, rng, stream):
    """The RLE walk (J1) of both builds at the consensus stage's tier."""
    import torch

    from racon_tpu_torch.ops import nw_kernel as nk
    from racon_tpu_torch.ops.batch import to_device
    from racon_tpu_torch.ops.geometry import rle_events

    rows = []
    for B in (4096, 4097):
        cap, W = 640, 128
        E = rle_events(cap, cap, W)
        q4, t4, m, n = items(rng, B, cap, W)
        dcb = np.full((B, cap // 8), 0xB7, np.uint8)
        g = to_device(q4, t4, dcb, m, n, m_cap=cap, n_cap=cap,
                      device="cuda")
        moves, _ = nk.nw_sweep(g.q4, g.t4, g.dcb, m_cap=cap, n_cap=cap,
                               w_band=W, match=5, mismatch=-4, gap=-8)
        payload = torch.empty((B, E + 1), dtype=torch.uint8, device="cuda")

        def walk(lib):
            rc = lib.rtt_rle_walk(ptr(moves), ptr(g.m), ptr(g.n),
                                  ptr(payload), B, cap, cap, W, E, stream())
            if rc:
                raise SystemExit(f"rtt_rle_walk: error {rc}")

        # bytes: m and n, the payload, one move word per event pair
        walk(libs["this"])
        body = payload[:, :-1].cpu().numpy()
        nz = body != 0
        last = np.where(nz.any(1), E - np.argmax(nz[:, ::-1], 1), 0)
        per_item = (last + 1) // 2
        steps = int(per_item.sum())
        row = in_turns("rle_walk", (cap, W), B, libs, walk, lambda: payload,
                       bound_ms(4 * steps + B * (8 + E + 1),
                                steps * OPS_WALK_STEP))
        # a warp runs until its longest walk ends: that walk's chain of
        # dependent move-word loads sets the kernel's time
        row.update(steps=steps, max_steps=int(per_item.max()),
                   ns_per_step_of_longest=1e6 * row["this"]["ms"]
                   / int(per_item.max()))
        print(f"rle_walk B={B}: {steps} steps, the longest walk "
              f"{row['max_steps']}: {row['ns_per_step_of_longest']:.1f} ns "
              "a step", flush=True)
        rows.append(row)
    return rows


def sweep_t(libs, rng, stream):
    """The panel sweep's variants (K7 = full, K8) of both builds at the
    ablation harness's shape and items, and this build's K1 on the same
    items packed."""
    import torch

    from racon_tpu_torch.benchmarks import profile_ablate as pa
    from racon_tpu_torch.ops.batch import to_device
    from racon_tpu_torch.ops.geometry import scan_span

    B, cap, W = 8192, 640, 128
    inp = pa.make_inputs(B, cap, W)
    q, tp, gcp = (torch.from_numpy(inp[k]).cuda()
                  for k in ("q", "tp", "gcp"))
    sc = tuple(pa.SCORES.values())
    nmv = B * (cap // 16) * W
    buf = torch.empty(nmv + B, dtype=torch.int32, device="cuda")
    rows = []
    for v, name in enumerate(pa.VARIANTS):
        def run(lib, v=v):
            rc = lib.rtt_nw_sweep_t(ptr(q), ptr(tp), ptr(gcp), ptr(buf),
                                    ptr(buf[nmv:]), B, cap, cap, W, *sc,
                                    scan_span(W), v, stream())
            if rc:
                raise SystemExit(f"rtt_nw_sweep_t: error {rc}")

        row = in_turns(f"nw_sweep_t {name}", (cap, W), B, libs, run,
                       lambda: buf, bound_ms(*pa.variant_work(
                           B, cap, cap, W, name, OPS_SWEEP_CELL)))
        row["variant"] = name
        rows.append(row)
        if name == "full":
            k7 = buf.clone()
    g = to_device(inp["q4"], inp["t4"], inp["dcb"], inp["m"], inp["n"],
                  m_cap=cap, n_cap=cap, device="cuda")

    def k1():
        rc = libs["this"].rtt_nw_sweep(ptr(g.q4), ptr(g.t4), ptr(g.dcb),
                                       ptr(buf), ptr(buf[nmv:]), B, cap, cap,
                                       W, *sc, scan_span(W), stream())
        if rc:
            raise SystemExit(f"rtt_nw_sweep: error {rc}")

    k1()
    torch.cuda.synchronize()
    if not torch.equal(buf, k7):
        raise SystemExit("nw_sweep_t full and nw_sweep (K1) differ")
    k1_ms = cuda_ms(k1)
    print(f"  K1 (nw_sweep, this build) on the same items packed: "
          f"{k1_ms:.4f} ms, byte-equal to K7", flush=True)
    rows[0]["k1_ms"] = k1_ms
    del buf, q, tp, gcp, g
    torch.cuda.empty_cache()
    return rows


def sweep16(libs, rng, stream):
    """The int16 warp sweep (K1-16) of both builds at the consensus
    stage's (640,128) and (256,128) chunks, each against this build's
    int32 K1 on every item, and the int16 strip sweep (K2-16) at the
    scored align route's (2560,512) chunk against this build's int32
    strip kernel."""
    import torch

    from racon_tpu_torch.ops.batch import to_device
    from racon_tpu_torch.ops.geometry import scan_span

    rng = np.random.default_rng(16)
    rows = []
    for cap, W, B, sc in ((640, 128, 4096, (5, -4, -8)),
                          (256, 128, 4097, (5, -4, -8)),
                          (2560, 512, 1024, (0, -1, -1))):
        q4, t4, m, n = items(rng, B, cap, W)
        dcb = np.packbits(rng.random((B, cap)) >= 0.3, axis=1,
                          bitorder="little")
        if sc == (0, -1, -1):
            dcb[:] = 0xFF
        g = to_device(q4, t4, dcb, m, n, m_cap=cap, n_cap=cap,
                      device="cuda")
        neg = -((cap + cap) * max(map(abs, sc)) + 64)
        nmv = B * (cap // 16) * W
        buf = torch.empty(nmv + B, dtype=torch.int32, device="cuda")

        def run(lib):
            rc = lib.rtt_nw_sweep16(ptr(g.q4), ptr(g.t4), ptr(g.dcb),
                                    ptr(buf), ptr(buf[nmv:]), B, cap, cap, W,
                                    *sc, scan_span(W), neg, stream())
            if rc:
                raise SystemExit(f"rtt_nw_sweep16: error {rc}")

        def k1():
            rc = libs["this"].rtt_nw_sweep(ptr(g.q4), ptr(g.t4), ptr(g.dcb),
                                           ptr(buf), ptr(buf[nmv:]), B, cap,
                                           cap, W, *sc, scan_span(W),
                                           stream())
            if rc:
                raise SystemExit(f"rtt_nw_sweep: error {rc}")

        k1()
        torch.cuda.synchronize()
        want = buf.clone()
        nbytes = B * (cap // 2 + cap // 2 + cap // 8) + 4 * (nmv + B)
        name = "nw_sweep16" if W <= 256 else "nw_sweep_block16"
        row = in_turns(name, (cap, W), B, libs, run, lambda: buf,
                       bound_ms(nbytes, B * cap * W * OPS_SWEEP_CELL
                                / CELLS_PER_OP16))
        if not torch.equal(buf, want):
            raise SystemExit(f"{name} ({cap},{W}) B={B}: differs from the "
                             "int32 sweep")
        row["int32_ms"] = cuda_ms(k1)
        print(f"  byte-equal to the int32 sweep on every item; the int32 "
              f"sweep {row['int32_ms']:.4f} ms", flush=True)
        rows.append(row)
        del buf, g
        torch.cuda.empty_cache()
    return rows


def moves(libs, rng, stream):
    """The Myers plane-to-move transform (J5) of both builds at the
    "rle" payload's chunks, on planes this build's K3 makes."""
    import torch

    from racon_tpu_torch.ops.batch import to_device
    from racon_tpu_torch.ops.geometry import moves_live_tiles

    rng = np.random.default_rng(17)
    rows = []
    for cap, W, B in ((10240, 1024, 1024), (40960, 1024, 409)):
        q4, t4, m, n = items(rng, B, cap, W)
        g = to_device(q4, t4, None, m, n, m_cap=cap, n_cap=cap,
                      device="cuda")
        planes = torch.empty((B, cap, 2, W // 32), dtype=torch.int32,
                             device="cuda")
        rc = libs["this"].rtt_myers_sweep(ptr(g.q4), ptr(g.t4), ptr(planes),
                                          B, cap, cap, W, stream())
        if rc:
            raise SystemExit(f"rtt_myers_sweep: error {rc}")
        out = torch.empty((B, cap // 16, W), dtype=torch.int32,
                          device="cuda")

        def run(lib):
            rc = lib.rtt_myers_moves(ptr(planes), ptr(g.m), ptr(out), B, cap,
                                     cap, W, stream())
            if rc:
                raise SystemExit(f"rtt_myers_moves: error {rc}")

        # the tiles (16 rows x 32 lanes) that hold a valid cell: their
        # plane words read and 40 ops a move word; every move word written
        tiles = out.numel() // 32
        live = moves_live_tiles(m, cap, cap, W)
        row = in_turns("myers_moves", (cap, W), B, libs, run, lambda: out,
                       bound_ms((live + tiles) * 128 + 4 * B,
                                live * 32 * OPS_MOVES_WORD))
        row["live_tile_share"] = live / tiles
        row["whole_planes_bound"] = bound_ms(2 * tiles * 128 + 4 * B,
                                             tiles * 32 * OPS_MOVES_WORD)
        print(f"  tiles with a valid cell: {100 * live / tiles:.1f} %; the "
              f"whole planes' bound {row['whole_planes_bound'][0]:.4f} ms",
              flush=True)
        rows.append(row)
        del planes, out, g
        torch.cuda.empty_cache()
    return rows


GATHER_SHAPES = ((640, 128, 4096), (256, 128, 4097), (5120, 1024, 8))
_MODE_RULE = "static int gather_mode(int m_cap, int n_cap, int B) {"
_J_RULE = "  const int J = few ? 1 : whole;"
_LOAD = "lo[j] = 32 * j < avail ? __ldg(src + 32 * j) : 0u;"
_META = ("  const int qs = __ldg(mrow), m = __ldg(mrow + 1);\n"
         "  const int ts = __ldg(mrow + 2), n = __ldg(mrow + 3);\n")
# this checkout's pack_gather.cu with one line rewritten: the unit rule's
# grouping fixed at each of the three, its lane words fixed at 1
# ("j1") or at whole rows ("jrow"), kWarps warps a block whatever the
# units ("w8"), the meta row loaded by lanes 0-3 and broadcast by shuffle
# ("metashfl"); and three that give wrong bytes and
# time a part: the kernel's body cut ("empty": the floor, the same
# launches doing nothing), no meta load (items at fixed starts:
# "nometa"), no blob load ("noblob": meta, then the stores)
GATHER_VARIANTS = {
    "row": [(_MODE_RULE, _MODE_RULE + "\n  return kRow;")],
    "pair": [(_MODE_RULE, _MODE_RULE + "\n  return kPair;")],
    "item": [(_MODE_RULE, _MODE_RULE + "\n  return kItem;")],
    "j1": [(_J_RULE, "  const int J = 1;")],
    "metashfl": [(_META, """  const int mv = lane < 4 ? __ldg(mrow + lane) : 0;
  const int qs = __shfl_sync(kFull, mv, 0), m = __shfl_sync(kFull, mv, 1);
  const int ts = __shfl_sync(kFull, mv, 2), n = __shfl_sync(kFull, mv, 3);
""")],
    "jrow": [(_J_RULE, "  const int J = whole;")],
    "w8": [("  while (warps > 1 && units < static_cast<long long>(warps) * kSms)",
            "  while (false)")],
    "empty": [("  if (b >= B) return;  // warp-uniform", "  return;")],
    "nometa": [(_META, "  const int qs = 8 * b, m = 8 * wq, ts = 8 * b, "
                "n = 8 * wt;\n")],
    "noblob": [(_LOAD, "lo[j] = 32 * j < avail ? avail : 0u;")]}
GATHER_EXACT = ("row", "pair", "item", "j1", "jrow", "w8", "metashfl")


def gather_items(rng, B, cap):
    """The gather route's inputs for B items at cap: code blobs of layer
    and backbone codes (0..4) and a deletion-cost bit blob 30 % clear, as
    the stage makes them, and meta rows with odd starts, rows of length
    cap and one ending at each blob's end, every 7th item all PAD.
    Returns (word blobs, meta, the numpy blobs the host packers read)."""
    from racon_tpu_torch.ops import gather

    L = B * cap // 2 + cap + 7
    q8 = rng.integers(0, 5, L).astype(np.int8)
    t8 = rng.integers(0, 5, L).astype(np.int8)
    dmask = rng.random(L) >= 0.3
    lens = rng.integers(cap // 2, cap + 1, (2, B))
    lens[:, 0] = cap
    lens[:, 6::7] = 0
    starts = rng.integers(0, L - cap, (2, B))
    starts[:, 1] = L - lens[:, 1]
    starts[:, 2::2] |= 1
    meta = np.stack([starts[0], lens[0], starts[1], lens[1]],
                    1).astype(np.int32)
    words = (gather.code_words(q8), gather.code_words(t8),
             gather.bit_words(dmask))
    return words, meta, (q8, t8, dmask.view(np.int8))


def gather_bytes(B, cap, meta) -> int:
    """The bytes J6 must move (chip_smoke.py's count): every output word
    written, the meta rows and the blob bytes the rows cover read once."""
    m, n = meta[:, 1].astype(np.int64), meta[:, 3].astype(np.int64)
    return (4 * B * (cap // 8 + cap // 8 + cap // 32) + meta.nbytes
            + int(m.sum() + n.sum()) // 2 + int(n.sum()) // 8)


def graph_ms(launch, reps=20, replays=5):
    """CUDA-event ms a launch of `launch` (a raw kernel call on
    preallocated outputs), captured reps times in a CUDA graph and the
    graph replayed: the kernel's own time, where cuda_ms's loop around a
    kernel of a few microseconds times the host's calls instead."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        launch()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            launch()
    return cuda_ms(graph.replay, reps=replays) / reps


def start_gather_variants(tmp: str, names=tuple(GATHER_VARIANTS)) -> dict:
    """nvcc on each GATHER_VARIANTS copy of pack_gather.cu named, all
    started at once: {name: (process, library path)}."""
    import shutil

    procs = {}
    for name in names:
        edits = GATHER_VARIANTS[name]
        src = os.path.join(tmp, f"gather_{name}")
        os.makedirs(src)
        shutil.copy(os.path.join(CSRC, "pack_gather.cu"), src)
        path = os.path.join(src, "pack_gather.cu")
        text = open(path).read()
        for old, new in edits:
            if old not in text:
                raise SystemExit(f"kernel_ab: gather variant {name} no "
                                 "longer applies")
            text = text.replace(old, new)
        open(path, "w").write(text)
        so = src + ".so"
        procs[name] = (start_build(src, so, ("pack_gather.cu",)), so)
    return procs


def _host_split(dev, m_cap, n_cap, calls=200, rounds=2):
    """us of one gather.pack_gather call on the host (perf_counter, the
    median over `rounds` turns of its parts in order and back, each the
    mean of `calls` after a warm-up) and of its parts: the outputs'
    allocation (one buffer and three views; the parent's three
    torch.empty beside it), the binding's call on preallocated outputs
    (its checks and the launch), and the same call at B = 0, where the C
    launcher returns before it launches (the checks alone). The parent's
    wrapper, line for line, beside them."""
    import statistics
    import time

    import torch

    from racon_tpu_torch.kernels import LAUNCHES
    from racon_tpu_torch.kernels.build import kernels
    from racon_tpu_torch.ops import gather

    B = dev[3].shape[0]
    widths = (m_cap // 2, n_cap // 2, n_cap // 8)
    outs = gather.pack_gather(*dev, m_cap=m_cap, n_cap=n_cap)
    meta0 = dev[3][:0]
    outs0 = [x[:0] for x in outs]

    def alloc_one():
        offsets, _, nbytes = gather.out_layout(B, m_cap, n_cap)
        buf = torch.empty(nbytes, dtype=torch.uint8, device=dev[3].device)
        return [buf.as_strided((B, w), (w, 1), o)
                for o, w in zip(offsets, widths)]

    def alloc_three():
        return [torch.empty((B, w), dtype=torch.uint8, device=dev[3].device)
                for w in widths]

    def parent_call():  # the parent's gather.pack_gather, line for line
        meta = dev[3]
        if meta.device.type == "cpu":
            return gather.pack_gather_plain(*dev, m_cap=m_cap, n_cap=n_cap)
        if meta.device.type != "cuda":
            raise ValueError(f"unsupported device {meta.device}")
        from racon_tpu_torch.kernels.build import kernels

        B = meta.shape[0]
        out = [torch.empty((B, w), dtype=torch.uint8, device=meta.device)
               for w in (m_cap // 2, n_cap // 2, n_cap // 8)]
        kernels().pack_gather(*dev, *out, m_cap, n_cap)
        LAUNCHES["pack_gather"] += 1
        return tuple(out)

    parts = {"call": lambda: gather.pack_gather(*dev, m_cap=m_cap,
                                                n_cap=n_cap),
             "parent_call": parent_call, "alloc_one": alloc_one,
             "alloc_three": alloc_three,
             "binding": lambda: kernels().pack_gather(*dev, *outs, m_cap,
                                                      n_cap),
             "binding_b0": lambda: kernels().pack_gather(
                 *dev[:3], meta0, *outs0, m_cap, n_cap)}
    runs = {k: [] for k in parts}
    order = list(parts)
    for tag in (order + order[::-1]) * rounds:
        fn = parts[tag]
        for _ in range(20):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        runs[tag].append(1e6 * (time.perf_counter() - t0) / calls)
        torch.cuda.synchronize()
    us = {k: statistics.median(v) for k, v in runs.items()}
    us["launch"] = us["binding"] - us["binding_b0"]
    us["rest"] = us["call"] - us["alloc_one"] - us["binding"]
    return us


def gathers(libs, rng, stream):
    """The row gather (J6) of both builds and of this build's variants (the
    unit rule's variants of GATHER_VARIANTS: the empty kernel is the
    floor) at the gather route's chunks on gather_items' inputs (seed
    1476, as chip_smoke.py's phase 10): ms a launch inside a CUDA graph of
    20, the median of four, in turns (the builds in order and back,
    twice); every build of GATHER_EXACT byte-equal to pack_gather_plain.
    Then the host time of one gather.pack_gather call and its parts."""
    import statistics

    import torch

    from racon_tpu_torch.ops import gather

    rng = np.random.default_rng(1476)
    with tempfile.TemporaryDirectory() as tmp:
        procs = start_gather_variants(tmp)
        from racon_tpu_torch.kernels.build import kernels

        kernels()  # the binding, for the host split; nvcc runs meanwhile
        for name, (proc, so) in procs.items():
            if proc.wait():
                raise SystemExit(f"kernel_ab: the gather {name} build "
                                 "failed")
        gl = {"other": libs["other"], "this": libs["this"],
              **{k: load(so) for k, (_, so) in procs.items()}}
        rows = []
        for cap, W, B in GATHER_SHAPES:
            words, meta, _ = gather_items(rng, B, cap)
            dev = [torch.from_numpy(x).cuda() for x in (*words, meta)]
            plain = gather.pack_gather_plain(
                *(torch.from_numpy(x) for x in (*words, meta)), m_cap=cap,
                n_cap=cap)
            want = torch.cat([x.reshape(-1) for x in plain])
            size = want.numel()
            buf = torch.empty(size, dtype=torch.uint8, device="cuda")
            outs = torch.split(buf, [x.numel() for x in plain])
            ptrs = [ptr(x) for x in (*dev, *outs)]

            def run(lib):
                rc = lib.rtt_pack_gather(ptrs[0], len(words[0]), ptrs[1],
                                         len(words[1]), ptrs[2],
                                         len(words[2]), *ptrs[3:], B, cap,
                                         cap, stream())
                if rc:
                    raise SystemExit(f"rtt_pack_gather: error {rc}")

            for tag, lib in gl.items():
                if tag not in ("other", "this", *GATHER_EXACT):
                    continue
                buf.fill_(0xA7)  # neither PAD nibbles nor set bits
                run(lib)
                torch.cuda.synchronize()
                if not torch.equal(buf.cpu(), want):
                    raise SystemExit(f"gather ({cap},{W}) B={B}: {tag} "
                                     "differs from pack_gather_plain")
            order = list(gl)
            times = {k: [] for k in order}
            for tag in (order + order[::-1]) * 2:
                times[tag].append(graph_ms(lambda: run(gl[tag])))
            bms, by = bound_ms(gather_bytes(B, cap, meta),
                               B * (cap // 8 + cap // 8 + cap // 32) * 10)
            row = {"kernel": "pack_gather", "shape": [cap, W], "B": B,
                   "bound_ms": bms, "bound_by": by, "byte_equal": True}
            for tag, ts in times.items():
                ms = statistics.median(ts)
                row[tag] = {"ms_runs": ts, "ms": ms, "bound_share": bms / ms}
            floor = row["empty"]["ms"]
            for tag in ("other", "this", *GATHER_EXACT):
                above = row[tag]["ms"] - floor
                row[tag]["bound_share_over_floor"] = (
                    bms / above if above > 0 else None)
            row["host_us"] = _host_split(dev, cap, cap)
            this = row["this"]
            print(f"gather ({cap},{W}) B={B}: "
                  + ", ".join(f"{k} {row[k]['ms']:.5f}" for k in order)
                  + f" ms a launch in a graph (this "
                  f"{row['other']['ms'] / this['ms']:.2f}x the other); "
                  f"bound {bms:.5f} ms by {by}: "
                  f"{100 * this['bound_share']:.1f} % of this, floor "
                  f"{floor:.5f} ms; host us " + ", ".join(
                      f"{k} {v:.2f}" for k, v in row["host_us"].items()),
                  flush=True)
            rows.append(row)
            del buf, outs, dev
            torch.cuda.empty_cache()
    return rows


# each section's kernels of both builds, in this order; the first three
# draw their items from one generator (seed 7), the others from their own
SECTIONS = {"myers_sweep": myers_sweeps, "rle_walk": rle_walks,
            "strip": strip_sweeps, "walks": walks, "sweep_t": sweep_t,
            "sweep16": sweep16, "moves": moves, "gather": gathers}
# the sources each section builds (both versions)
SECTION_SOURCES = {"myers_sweep": ("myers_sweep.cu",),
                   "rle_walk": ("rle_walk.cu", "nw_sweep.cu"),
                   "strip": ("nw_sweep.cu",),
                   "walks": ("nw_sweep.cu", "packed_walk.cu",
                             "rows_walk.cu"),
                   "sweep_t": ("nw_sweep_t.cu", "nw_sweep.cu"),
                   "sweep16": ("nw_sweep16.cu", "nw_sweep.cu"),
                   "moves": ("myers_moves.cu", "myers_sweep.cu"),
                   "gather": ("pack_gather.cu",)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("other", help="directory of the other version's "
                    "sources (those it lacks come from this checkout)")
    ap.add_argument("--json", help="also write the result rows here")
    ap.add_argument("--only", nargs="+", choices=list(SECTIONS),
                    default=list(SECTIONS), help="time only these kernels")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        sys.stderr.write("kernel_ab: no CUDA device\n")
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    rows = []
    with tempfile.TemporaryDirectory() as tmp:
        outs = {"other": (args.other, os.path.join(tmp, "other.so")),
                "this": (CSRC, os.path.join(tmp, "this.so"))}
        sources = [src for src in SOURCES
                   if any(src in SECTION_SOURCES[x] for x in args.only)]
        procs = {k: start_build(*v, sources) for k, v in outs.items()}
        for k, proc in procs.items():
            if proc.wait():
                raise SystemExit(f"kernel_ab: the {k} build failed")
        libs = {k: load(out) for k, (_, out) in outs.items()}
        rng = np.random.default_rng(7)
        stream = lambda: ctypes.c_void_p(
            torch.cuda.current_stream().cuda_stream)
        for name, section in SECTIONS.items():
            if name in args.only:
                rows += section(libs, rng, stream)
    line = json.dumps({"device": torch.cuda.get_device_name(0),
                       "rows": rows})
    if args.json:
        with open(args.json, "w") as f:
            f.write(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())

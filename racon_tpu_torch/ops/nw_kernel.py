"""Scored banded-NW sweep and the RLE, rows and packed2 traceback walks:
the consensus stage's device core, and the align stage's under
RACON_TPU_MYERS=0 (port of racon_tpu/ops/nw_kernel.py). The fused calls:
align_walk_padded takes the host's packed rows; align_walk_gather (the
device-gather form, RACON_TPU_DEVGATHER=1) takes word blobs already on
the device and per-item meta rows, cuts the rows out on the device
(ops/gather.pack_gather) and runs the same sweep and walk.

Each function takes its tensors on one device. On a CUDA tensor it
launches the hand-written kernel (kernels/csrc/nw_sweep.cu,
kernels/csrc/nw_sweep16.cu, kernels/csrc/rle_walk.cu,
kernels/csrc/rows_walk.cu, kernels/csrc/packed_walk.cu,
kernels/csrc/nw_sweep_t.cu) and counts the launch; on a CPU tensor it runs the plain PyTorch version beside it,
which is the readable specification and what the CPU tests hold against
the JAX package. Any other device raises.

Layouts (see ops/batch.py for the packed inputs):
  moves (B, m_cap // 16, W) int32  2-bit moves DIAG=0 > UP=1 > LEFT=2,
                                   3 = outside; 16 rows per word, bit
                                   2*((i-1) % 16) for row i -- the words of
                                   nw_band_batch_t8, transposed from its
                                   (m_cap // 16, W, B)
  score (B,) int32                 H at the end lane
  payload (B, E + 1) uint8         RLE events then the escape flag,
                                   E = rle_events(m_cap, n_cap, W)
  payload (B, m_cap + 2) uint8     rows: one record per query row
                                   (REC_DIAG/REC_UP | deletions << 2, 0 for
                                   an inactive row), the final-deletions
                                   byte, the escape flag
  payload (B, S // 4 + 1) uint8    packed2: 2-bit step codes, 4 per byte,
                                   then the escape flag,
                                   S = walk_steps(m_cap, n_cap, W)
  q (B, m_cap), tp (B, n_cap + 2W), gcp (B, n_cap + 1 + 2W) int32
                                   nw_sweep_t's unpacked panels
                                   (sweep_t_panels): codes, target codes
                                   with W PAD columns on both sides, and
                                   the cumulative deletion costs
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..kernels import LAUNCHES
from ..native import bindings
from .batch import to_device, unpack_bits, unpack_codes, upload
from .geometry import (GROUP, NEG, OP_STREAM_SKIP, PAD_CODE, PACK,
                       REC_DIAG, REC_UP, RLE_LEFT, RLE_SKIP, RLE_UP,
                       SCAN_FILL, band_dlo, dp_consts, rle_events,
                       rows_payload_width, scan_span, sweep_dp16,
                       sweep_fits, sweep_kernel, sweep_t_fits,
                       walk_steps)


def _device_kind(t: torch.Tensor) -> str:
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {t.device}")
    return t.device.type


def _as_int32_bits(x: torch.Tensor) -> torch.Tensor:
    """int64 holding 32-bit patterns -> int32 with the same bits."""
    return torch.where(x >= 2 ** 31, x - 2 ** 32, x).to(torch.int32)


# ------------------------------------------------------------------ sweep


def nw_sweep(q4, t4, dcb, *, m_cap, n_cap, w_band, match, mismatch, gap):
    """q4 (B, m_cap//2), t4 (B, n_cap//2), dcb (B, n_cap//8) uint8 ->
    (moves (B, m_cap//16, W) int32, score (B,) int32). Replaces the TPU
    kernels nw_band_batch_t8 (W <= 256: one warp per item, launches
    counted as "nw_sweep"), nw_band_batch_t8big (W = 288 .. 1024,
    "nw_sweep_block") and nw_band_batch (W = 2048 and 4096,
    "nw_sweep_wide"), the last two by the strip kernel, one block of warp
    strips per item; see geometry.sweep_kernel and sweep_launch. Where geometry.sweep_dp16 holds
    (RACON_TPU_DP16=1 and the int16 gate), H runs in int16, as the
    reference's t8 and t8big do there: kernels/csrc/nw_sweep16.cu's warp
    or block kernel ("nw_sweep16", "nw_sweep_block16"), equal bit for bit
    to the int32 sweep."""
    if not sweep_fits(m_cap, n_cap, w_band):
        raise ValueError(f"sweep shape ({m_cap}, {n_cap}, {w_band}) "
                         "unsupported")
    if _device_kind(q4) == "cpu":
        return nw_sweep_plain(q4, t4, dcb, m_cap=m_cap, n_cap=n_cap,
                              w_band=w_band, match=match, mismatch=mismatch,
                              gap=gap)
    if sweep_dp16(m_cap, n_cap, w_band, match, mismatch, gap):
        return launch_sweep16(q4, t4, dcb, m_cap=m_cap, n_cap=n_cap,
                              w_band=w_band, match=match, mismatch=mismatch,
                              gap=gap)
    from ..kernels.build import kernels

    B = q4.shape[0]
    out = (torch.empty((B, m_cap // PACK, w_band), dtype=torch.int32,
                       device=q4.device),
           torch.empty((B,), dtype=torch.int32, device=q4.device))
    kernels().nw_sweep(q4, t4, dcb, *out, m_cap, n_cap, w_band, match,
                       mismatch, gap, scan_span(w_band))
    LAUNCHES[sweep_kernel(w_band)] += 1
    return out


def launch_sweep16(q4, t4, dcb, *, m_cap, n_cap, w_band, match, mismatch,
                   gap):
    """Launch kernels/csrc/nw_sweep16.cu on CUDA inputs, H in int16 with
    the sentinel of geometry.dp_consts (which must give int16), counted
    as "nw_sweep16" (W <= 256) or "nw_sweep_block16"."""
    from ..kernels.build import kernels

    dt, neg, _ = dp_consts(m_cap, n_cap, match, mismatch, gap)
    if dt != torch.int16:
        raise ValueError("launch_sweep16 outside the int16 gate")
    B = q4.shape[0]
    moves = torch.empty((B, m_cap // PACK, w_band), dtype=torch.int32,
                        device=q4.device)
    score = torch.empty((B,), dtype=torch.int32, device=q4.device)
    kernels().nw_sweep16(q4, t4, dcb, moves, score, m_cap, n_cap, w_band,
                         match, mismatch, gap, scan_span(w_band), neg)
    LAUNCHES[sweep_kernel(w_band, True)] += 1
    return moves, score


def nw_sweep_plain(q4, t4, dcb, *, m_cap, n_cap, w_band, match, mismatch,
                   gap):
    """Plain PyTorch version of nw_sweep on CPU tensors: the packed batch
    unpacked into K7's panels and sweep_t_rows' row loop, the same
    recurrence as nw_band_batch_ref (gc integrated here once, not per
    row); H in int16 with the int16 sentinels where geometry.sweep_dp16
    holds, as the reference's t8 and t8big run it."""
    if q4.device.type != "cpu":
        raise ValueError("nw_sweep_plain takes CPU tensors")
    q = unpack_codes(q4, m_cap)
    t = unpack_codes(t4, n_cap)
    dc = unpack_bits(dcb, n_cap) * gap
    q, tp, gcp = sweep_t_panels(q, t, dc, w_band=w_band)
    dt, neg, fill = (dp_consts(m_cap, n_cap, match, mismatch, gap)
                     if sweep_dp16(m_cap, n_cap, w_band, match, mismatch, gap)
                     else (torch.int32, NEG, SCAN_FILL))
    return sweep_t_rows(q, tp, gcp.to(dt), m_cap=m_cap, n_cap=n_cap,
                        w_band=w_band, match=match, mismatch=mismatch,
                        gap=gap, dt=dt, neg=neg, fill=fill)


# ------------------------------------------ int32 panel sweep (K7, K8)

# the ablation variants of the panel sweep (benchmarks/profile_ablate.py);
# the index is the kernel's `variant` argument
SWEEP_T_VARIANTS = ("full", "noclosure", "nomoves", "noload", "empty")


def sweep_t_panels(q, t, dc, *, w_band):
    """Codes q (B, m_cap) and t (B, n_cap) and per-column deletion costs
    dc (B, n_cap), integer tensors on one device -> nw_sweep_t's int32
    panels (q, tp, gcp): tp (B, n_cap + 2W) the target codes with W PAD
    columns on both sides, gcp (B, n_cap + 1 + 2W) the prefix sums gc[j]
    (j = 0..n_cap, gc[0] = 0) with W zeros before and W copies of
    gc[n_cap] after. The JAX harness's panels (profile_ablate.py:170-182),
    item-major."""
    B = q.shape[0]
    W = w_band
    tp = torch.nn.functional.pad(t.to(torch.int32), (W, W), value=PAD_CODE)
    gc = torch.cat([q.new_zeros((B, 1), dtype=torch.int32),
                    torch.cumsum(dc, 1, dtype=torch.int32)], 1)
    gcp = torch.cat([q.new_zeros((B, W), dtype=torch.int32), gc,
                     gc[:, -1:].expand(B, W)], 1)
    return q.to(torch.int32).contiguous(), tp.contiguous(), gcp


def check_sweep_t(m_cap, n_cap, w_band, variant="full"):
    """Raise ValueError, on every device, for a shape the panel sweep does
    not take (sweep_t_fits) or an unknown variant."""
    if not sweep_t_fits(m_cap, n_cap, w_band):
        raise ValueError(f"panel sweep shape ({m_cap}, {n_cap}, {w_band}) "
                         "unsupported")
    if variant not in SWEEP_T_VARIANTS:
        raise ValueError(f"unknown sweep variant {variant!r}")


def nw_sweep_t(q, tp, gcp, *, m_cap, n_cap, w_band, match, mismatch, gap):
    """Panels from sweep_t_panels -> (moves (B, m_cap//16, W) int32,
    score (B,) int32): the TPU kernel nw_band_batch_t (K7) it replaces,
    whose (m_cap//16, W, B) moves and (1, B) score are these transposed.
    Shapes as sweep_t_fits says (a band right of the diagonal too); any B.
    Launches counted as "nw_sweep_t". Where both take the shape (dlo <=
    0), equal to nw_sweep on the same items packed."""
    check_sweep_t(m_cap, n_cap, w_band)
    if _device_kind(q) == "cpu":
        return nw_sweep_t_plain(q, tp, gcp, m_cap=m_cap, n_cap=n_cap,
                                w_band=w_band, match=match,
                                mismatch=mismatch, gap=gap)
    out = launch_sweep_t(q, tp, gcp, m_cap=m_cap, n_cap=n_cap,
                         w_band=w_band, match=match, mismatch=mismatch,
                         gap=gap, variant="full")
    LAUNCHES["nw_sweep_t"] += 1
    return out


def nw_sweep_t_plain(q, tp, gcp, *, m_cap, n_cap, w_band, match, mismatch,
                     gap):
    """Plain PyTorch version of nw_sweep_t on CPU tensors."""
    check_sweep_t(m_cap, n_cap, w_band)
    if q.device.type != "cpu":
        raise ValueError("nw_sweep_t_plain takes CPU tensors")
    return sweep_t_rows(q, tp, gcp, m_cap=m_cap, n_cap=n_cap, w_band=w_band,
                        match=match, mismatch=mismatch, gap=gap)


def launch_sweep_t(q, tp, gcp, *, m_cap, n_cap, w_band, match, mismatch,
                   gap, variant):
    """Launch kernels/csrc/nw_sweep_t.cu's instantiation for `variant` on
    CUDA panels; outputs allocated here (moves left unwritten by
    "nomoves"). Counting is the caller's: nw_sweep_t counts K7, the
    ablation harness's run_variant K8."""
    from ..kernels.build import kernels

    B = q.shape[0]
    moves = torch.empty((B, m_cap // PACK, w_band), dtype=torch.int32,
                        device=q.device)
    score = torch.empty((B,), dtype=torch.int32, device=q.device)
    kernels().nw_sweep_t(q, tp, gcp, moves, score, m_cap, n_cap, w_band,
                         match, mismatch, gap, scan_span(w_band),
                         SWEEP_T_VARIANTS.index(variant))
    return moves, score


def sweep_t_rows(q, tp, gcp, *, m_cap, n_cap, w_band, match, mismatch, gap,
                 variant="full", dt=torch.int32, neg=NEG, fill=SCAN_FILL):
    """The plain row loop over the panels (CPU tensors) behind
    nw_sweep_plain, nw_sweep_t_plain and the ablation variants: per row i
    a (B, W) band tile read at off = i - 1 + W + dlo, the recurrence of
    nw_band_batch_ref, the max-plus scan as torch.cummax with the TPU
    scan's fill on lanes k <= scan_span(W) - 2. A variant switches off what
    profile_ablate.make_kernel does: "noclosure" keeps h = cand, "nomoves"
    leaves the moves unwritten (torch.empty, never to be compared),
    "noload" reads every row at off = W + dlo and query row 0, and
    "empty" gives moves[b, 8g + p, k] = gcp[b, k] + p and score
    gcp[b, 0] + 8. H, gcp and every value derived from them are of dtype
    dt with the sentinel neg and the scan's fill `fill` (int16 in the
    reference's dp16 mode, nw_kernel.py:811-815; its arithmetic wraps as
    the TPU's does)."""
    B = q.shape[0]
    W = w_band
    dlo = band_dlo(m_cap, n_cap, W)
    steps = GROUP // PACK
    if variant == "empty":
        slot = torch.arange(m_cap // PACK, dtype=torch.int32) % steps
        return (gcp[:, None, :W] + slot[None, :, None],
                gcp[:, 0] + steps)
    closure = variant != "noclosure"
    store = variant != "nomoves"
    dynload = variant != "noload"
    k = torch.arange(W, dtype=torch.int32)
    fill_lane = k <= scan_span(W) - 2
    j0 = dlo + k
    negt = torch.tensor(neg, dtype=dt)
    h = torch.where((j0 >= 0) & (j0 <= n_cap), gcp[:, W + dlo : 2 * W + dlo],
                    negt)
    neg_col = torch.full((B, 1), neg, dtype=dt)
    match_t = torch.tensor(match, dtype=dt)
    mismatch_t = torch.tensor(mismatch, dtype=dt)
    moves = torch.zeros((B, m_cap // PACK, W), dtype=torch.int64)
    for i in range(1, m_cap + 1):
        jrow = i + dlo + k
        valid = (jrow >= 1) & (jrow <= n_cap)
        inside = valid | (jrow == 0)
        start = (i - 1 if dynload else 0) + W + dlo
        t_row = tp[:, start : start + W]
        qi = q[:, i - 1 : i] if dynload else q[:, :1]
        sub = torch.where((t_row == PAD_CODE) ^ (qi == PAD_CODE), negt,
                          torch.where(t_row == qi, match_t, mismatch_t))
        diag_c = h + sub
        up_c = torch.cat([h[:, 1:], neg_col], 1) + gap
        cand = torch.maximum(diag_c, up_c)
        cand = torch.where(jrow == 0, torch.tensor(i * gap, dtype=dt), cand)
        cand = torch.where(inside, cand, negt)
        if closure:
            gc_here = gcp[:, start + 1 : start + 1 + W]
            a = torch.cummax(cand - gc_here, dim=1).values
            a = torch.where(fill_lane, torch.clamp(a, min=fill), a)
            cand = a + gc_here
        h = torch.where(inside, cand, negt)
        if store:
            mv = torch.where(h == diag_c, 0, torch.where(h == up_c, 1, 2))
            mv = torch.where(valid, mv, 3).to(torch.int64)
            moves[:, (i - 1) // PACK] |= mv << (2 * ((i - 1) % PACK))
    score = h[:, n_cap - m_cap - dlo].to(torch.int32)
    if not store:
        return torch.empty((B, m_cap // PACK, W), dtype=torch.int32), score
    return _as_int32_bits(moves), score


# -------------------------------------------------------------- RLE walk


def rle_walk(moves, m, n, *, m_cap, n_cap, w_band, max_events=None):
    """moves from nw_sweep, m/n (B,) int32 -> payload (B, E + 1) uint8:
    RLE events emitted backward from (m, n) and the escape flag, byte for
    byte those of walk_moves_rle_t (the TPU's jnp walk it replaces).
    E = max_events, by default rle_events(m_cap, n_cap, w_band); a walk
    that needs more is flagged escaped."""
    E = max_events or rle_events(m_cap, n_cap, w_band)
    if _device_kind(moves) == "cpu":
        return rle_walk_plain(moves, m, n, m_cap=m_cap, n_cap=n_cap,
                              w_band=w_band, max_events=E)
    from ..kernels.build import kernels

    payload = torch.empty((moves.shape[0], E + 1), dtype=torch.uint8,
                          device=moves.device)
    kernels().rle_walk(moves, m, n, payload, m_cap, n_cap, w_band, E)
    LAUNCHES["rle_walk"] += 1
    return payload


def _nlz31(z: torch.Tensor) -> torch.Tensor:
    """Leading zeros of 32-bit values held in int64, counting 31 for zero
    (the reference's binary search, nw_kernel.py:1284-1290)."""
    nlz = torch.zeros_like(z)
    for sh, thr in ((16, 0x0000FFFF), (8, 0x00FFFFFF), (4, 0x0FFFFFFF),
                    (2, 0x3FFFFFFF), (1, 0x7FFFFFFF)):
        take = z <= thr
        nlz = nlz + torch.where(take, sh, 0)
        if sh > 1:
            z = torch.where(take, (z << sh) & 0xFFFFFFFF, z)
    return nlz


def rle_walk_plain(moves, m, n, *, m_cap, n_cap, w_band, max_events=None):
    """Plain PyTorch version of rle_walk on CPU tensors: the reference's
    batch-synchronous loop, every item stepping once per iteration."""
    if moves.device.type != "cpu":
        raise ValueError("rle_walk_plain takes CPU tensors")
    B = moves.shape[0]
    W = w_band
    E = max_events or rle_events(m_cap, n_cap, W)
    dlo = band_dlo(m_cap, n_cap, W)
    mflat = (moves.to(torch.int64) & 0xFFFFFFFF).reshape(B, -1)
    i = m.to(torch.int64).clone()
    j = n.to(torch.int64).clone()
    esc = torch.zeros(B, dtype=torch.bool)
    events = torch.full((B, E), RLE_SKIP, dtype=torch.uint8)
    s = 0
    while s + 1 < E and bool((((i != 0) | (j != 0)) & ~esc).any()):
        at_origin = (i == 0) & (j == 0)
        interior = (i > 0) & (j > 0)
        row = torch.clamp(i - 1, min=0)
        k = j - i - dlo
        widx = (row // PACK) * W + torch.clamp(k, 0, W - 1)
        word = torch.gather(mflat, 1, widx[:, None])[:, 0]
        p = row % PACK
        mv = (word >> (2 * p)) & 3
        mv = torch.where(i == 0, 2, mv)
        mv = torch.where((j == 0) & (i > 0), 1, mv)
        inband = (k >= 0) & (k < W)
        esc = esc | (~at_origin & interior & (~inband | (mv == 3)))
        stop = esc | at_origin
        nlz = _nlz31((word << (2 * (PACK - 1 - p))) & 0xFFFFFFFF)
        d = torch.minimum(nlz >> 1, p + 1)
        d = torch.where(interior & ~esc,
                        torch.minimum(d, torch.minimum(i, j)), 0)
        single = torch.where(mv == 1, RLE_UP,
                             torch.where(mv == 2, RLE_LEFT, RLE_SKIP))
        out = torch.where(stop, RLE_SKIP, torch.where(d > 0, d, single))
        di = torch.where(stop, 0, torch.where(d > 0, d, (mv == 1).long()))
        dj = torch.where(stop, 0, torch.where(d > 0, d, (mv == 2).long()))
        i1 = i - di
        j1 = j - dj
        # fused second event from the same word
        p2 = p - d
        mv2 = (word >> (2 * torch.clamp(p2, min=0))) & 3
        mv2 = torch.where(i1 == 0, 2, mv2)
        mv2 = torch.where((j1 == 0) & (i1 > 0), 1, mv2)
        take2 = (~esc & (d > 0) & ~((i1 == 0) & (j1 == 0))
                 & (~((i1 > 0) & (j1 > 0))
                    | ((p2 >= 0) & ((mv2 == 1) | (mv2 == 2)))))
        out2 = torch.where(take2, torch.where(mv2 == 1, RLE_UP, RLE_LEFT),
                           RLE_SKIP)
        events[:, s] = out.to(torch.uint8)
        events[:, s + 1] = out2.to(torch.uint8)
        i = i1 - (take2 & (mv2 == 1)).long()
        j = j1 - (take2 & (mv2 == 2)).long()
        s += 2
    esc = esc | (i != 0) | (j != 0)
    return torch.cat([events, esc[:, None].to(torch.uint8)], 1)


# -------------------------------------------------------------- rows walk


def rows_walk(moves, m, n, *, m_cap, n_cap, w_band):
    """moves from nw_sweep, m/n (B,) int32 -> rows payload (B, m_cap + 2)
    uint8, byte for byte that of walk_rows_t (the TPU kernel it replaces)
    with its (B, m_cap + 2) payload: per query row, from m down to 1, the
    deletion run taken in that row and the move that leaves it."""
    if _device_kind(moves) == "cpu":
        return rows_walk_plain(moves, m, n, m_cap=m_cap, n_cap=n_cap,
                               w_band=w_band)
    from ..kernels.build import kernels

    payload = torch.empty((moves.shape[0], rows_payload_width(m_cap)),
                          dtype=torch.uint8, device=moves.device)
    kernels().rows_walk(moves, m, n, payload, m_cap, n_cap, w_band)
    LAUNCHES["rows_walk"] += 1
    return payload


def rows_walk_plain(moves, m, n, *, m_cap, n_cap, w_band):
    """Plain PyTorch version of rows_walk on CPU tensors: walk_rows_ref's
    row loop, every item stepping one query row per iteration, the
    deletion-run exit of a row found by a running max over the band
    (torch.cummax) instead of the reference's log-step scan. Rows above
    every item's m are inactive everywhere and skipped."""
    if moves.device.type != "cpu":
        raise ValueError("rows_walk_plain takes CPU tensors")
    B = moves.shape[0]
    W = w_band
    dlo = band_dlo(m_cap, n_cap, W)
    words = moves.to(torch.int64) & 0xFFFFFFFF
    kcol = torch.arange(W)
    m64 = m.to(torch.int64)[:, None]
    kvec = n.to(torch.int64)[:, None] - m64 - dlo
    esc = torch.zeros((B, 1), dtype=torch.bool)
    recs = torch.zeros((B, m_cap), dtype=torch.int64)
    top = min(int(m64.max()), m_cap) if B else 0
    for i in range(top, 0, -1):
        mv = (words[:, (i - 1) // PACK] >> (2 * ((i - 1) % PACK))) & 3
        mv = torch.where(kcol == -(i + dlo), 1, mv)  # j = 0: forced UP
        # nearest non-LEFT lane at or below each lane, -1 where none
        base = torch.cummax(torch.where(mv != 2, kcol, -1), dim=1).values
        hit = (kvec >= 0) & (kvec < W)
        k_exit = torch.gather(base, 1, torch.clamp(kvec, 0, W - 1))
        mv_exit = torch.gather(mv, 1, torch.clamp(k_exit, 0, W - 1))
        nleft = kvec - k_exit
        active = (i <= m64) & ~esc
        esc = esc | (active & (~hit | (k_exit < 0) | (mv_exit == 3)
                               | (nleft > 63)))
        act2 = active & ~esc
        op = torch.where(mv_exit == 1, REC_UP, REC_DIAG)
        recs[:, i - 1] = torch.where(act2, op | (nleft << 2), 0)[:, 0]
        kvec = torch.where(act2, k_exit + (mv_exit == 1).long(), kvec)
    jfin = dlo + kvec
    esc = esc | (jfin < 0) | (jfin > 255)
    return torch.cat([recs, torch.clamp(jfin, 0, 255), esc.long()],
                     1).to(torch.uint8)


# ----------------------------------------------------------- packed2 walk


def packed_walk(moves, m, n, *, m_cap, n_cap, w_band, max_steps=None):
    """moves from nw_sweep, m/n (B,) int32 -> payload (B, S // 4 + 1)
    uint8: the 2-bit step stream emitted backward from (m, n), four steps
    per byte and padded with OP_STREAM_SKIP, then the escape flag; byte
    for byte walk_moves_device(packed=True) (the TPU's jnp walk it
    replaces). S = max_steps, by default walk_steps(m_cap, n_cap,
    w_band); a walk that needs more is flagged escaped."""
    S = max_steps or walk_steps(m_cap, n_cap, w_band)
    if _device_kind(moves) == "cpu":
        return packed_walk_plain(moves, m, n, m_cap=m_cap, n_cap=n_cap,
                                 w_band=w_band, max_steps=S)
    from ..kernels.build import kernels

    payload = torch.empty((moves.shape[0], S // 4 + 1), dtype=torch.uint8,
                          device=moves.device)
    kernels().packed_walk(moves, m, n, payload, m_cap, n_cap, w_band, S)
    LAUNCHES["packed_walk"] += 1
    return payload


def packed_walk_plain(moves, m, n, *, m_cap, n_cap, w_band, max_steps=None):
    """Plain PyTorch version of packed_walk on CPU tensors: the reference's
    batch-synchronous loop, every item stepping once per iteration."""
    if moves.device.type != "cpu":
        raise ValueError("packed_walk_plain takes CPU tensors")
    B = moves.shape[0]
    W = w_band
    S = max_steps or walk_steps(m_cap, n_cap, W)
    if S % 4:
        raise ValueError(f"step budget {S} is not a multiple of 4")
    dlo = band_dlo(m_cap, n_cap, W)
    mflat = (moves.to(torch.int64) & 0xFFFFFFFF).reshape(B, -1)
    m = m.to(torch.int64)
    n = n.to(torch.int64)
    i = m.clone()
    j = n.clone()
    esc = torch.zeros(B, dtype=torch.bool)
    codes = torch.full((B, S), OP_STREAM_SKIP, dtype=torch.uint8)
    s = 0
    while s < S and bool((((i != 0) | (j != 0)) & ~esc).any()):
        k = j - i - dlo
        at_origin = (i == 0) & (j == 0)
        row = torch.clamp(i - 1, min=0)
        widx = (row // PACK) * W + torch.clamp(k, 0, W - 1)
        word = torch.gather(mflat, 1, widx[:, None])[:, 0]
        mv = (word >> (2 * (row % PACK))) & 3
        mv = torch.where(i == 0, 2, mv)              # row 0: all deletions
        mv = torch.where((j == 0) & (i > 0), 1, mv)  # column 0: insertions
        inband = (k >= 0) & (k < W)
        esc = esc | (~at_origin & (i > 0) & (j > 0)
                     & (~inband | (mv == 3)))
        mv = torch.where(esc | at_origin, OP_STREAM_SKIP, mv)
        real = torch.where(mv == 0, (i <= m) & (j <= n),
                           torch.where(mv == 1, i <= m, j <= n))
        codes[:, s] = torch.where((mv == OP_STREAM_SKIP) | ~real,
                                  OP_STREAM_SKIP, mv).to(torch.uint8)
        i = i - ((mv == 0) | (mv == 1)).long()
        j = j - ((mv == 0) | (mv == 2)).long()
        s += 1
    esc = esc | (i != 0) | (j != 0)  # truncated walk -> host realign
    shifts = 2 * torch.arange(4, dtype=torch.int32)
    packed = (codes.reshape(B, S // 4, 4).to(torch.int32) << shifts).sum(-1)
    return torch.cat([packed.to(torch.uint8), esc[:, None].to(torch.uint8)],
                     1)


# ------------------------------------------------------------ fused call

WALKS = {"rle": rle_walk, "rows": rows_walk, "packed2": packed_walk}


def _mesh_for(device):
    """The active mesh (parallel.mesh.active_mesh) when its devices are of
    `device`'s type, else None: a stage asked for the CPU (the tests) is
    never sent to the GPUs of a derived mesh."""
    from ..parallel.mesh import active_mesh

    mesh = active_mesh()
    if mesh is None or mesh[0].type != torch.device(device).type:
        return None
    return mesh


def walk_fmt(w_band: int) -> str:
    """Payload format of a scored-sweep tier (nw_kernel.py:2129-2160 on a
    real chip): "packed2" at the lane-major tiers (W = 2048, 4096); where
    the reference's transposed sweeps run (W <= 1024), "rows" or "rle" as
    RACON_TPU_WALK says (read at call time), and "rle" for "auto" or any
    other value."""
    if w_band > 1024:
        return "packed2"
    forced = os.environ.get("RACON_TPU_WALK", "auto")
    return forced if forced in ("rows", "rle") else "rle"


def payload_decoder(fmt, payload, cap, w_band):
    """(decoder, codes, budget) of the port's native runtime for a walk
    payload (numpy, escape flag last) of format `fmt` at (cap, cap,
    w_band): call decoder(codes, budget, m, n, threads, ...). The rows
    decoder reads the whole payload row; the others every byte but the
    escape flag."""
    if fmt == "rows":
        return (bindings.opstream_rows_to_ops_batch, payload,
                rows_payload_width(cap))
    codes = np.ascontiguousarray(payload[:, :-1])
    if fmt == "rle":
        return (bindings.opstream_rle_to_ops_batch, codes,
                rle_events(cap, cap, w_band))
    return (bindings.opstream_packed_to_ops_batch, codes,
            walk_steps(cap, cap, w_band))


def align_walk_padded(q4, t4, dcb, m, n, *, m_cap, n_cap, w_band, match,
                      mismatch, gap, device):
    """The scored stages' fused dispatch: the packed numpy batch goes to
    `device`, through the sweep and a walk, and comes back as (payload,
    score (B,) int32, fmt) on that device, in the reference's payload
    format: fmt "rle", "rows" or "packed2", as walk_fmt picks (decode
    with payload_decoder). Unlike the reference there is no padding of the
    batch: a kernel launch takes any B. When parallel.mesh.active_mesh()
    holds devices of `device`'s type, the batch is split over them
    instead (mesh.sharded_align_walk) and payload and score are lists of
    per-shard tensors, in shard order (ops/prefetch.resolve joins
    them)."""
    fmt = walk_fmt(w_band)
    mesh = _mesh_for(device)
    if mesh is not None:
        from ..parallel.mesh import sharded_align_walk

        payload, score = sharded_align_walk(
            mesh, q4, t4, dcb, m, n, m_cap=m_cap, n_cap=n_cap,
            w_band=w_band, match=match, mismatch=mismatch, gap=gap, fmt=fmt)
        return payload, score, fmt
    batch = to_device(q4, t4, dcb, m, n, m_cap=m_cap, n_cap=n_cap,
                      device=device)
    moves, score = nw_sweep(batch.q4, batch.t4, batch.dcb, m_cap=m_cap,
                            n_cap=n_cap, w_band=w_band, match=match,
                            mismatch=mismatch, gap=gap)
    payload = WALKS[fmt](moves, batch.m, batch.n, m_cap=m_cap, n_cap=n_cap,
                         w_band=w_band)
    return payload, score, fmt


def gather_devices(device) -> tuple:
    """The devices the gather route's blobs must be on for `device`: the
    active mesh's (_mesh_for), else `device` alone."""
    return _mesh_for(device) or (torch.device(device),)


def gather_sweep_walk(qblob, tblob, dcblob, meta, *, m_cap, n_cap, w_band,
                      match, mismatch, gap, fmt):
    """The gather route's body on one device: meta (B, 4) int32 on the
    blobs' device -> (payload, score) there. The rows are gathered
    (ops/gather.pack_gather), then swept and walked as align_walk_padded
    does."""
    from .gather import pack_gather

    q4, t4, dcb = pack_gather(qblob, tblob, dcblob, meta, m_cap=m_cap,
                              n_cap=n_cap)
    moves, score = nw_sweep(q4, t4, dcb, m_cap=m_cap, n_cap=n_cap,
                            w_band=w_band, match=match, mismatch=mismatch,
                            gap=gap)
    payload = WALKS[fmt](moves, meta[:, 1].contiguous(),
                         meta[:, 3].contiguous(), m_cap=m_cap, n_cap=n_cap,
                         w_band=w_band)
    return payload, score


def align_walk_gather(qblob, tblob, dcblob, meta, *, m_cap, n_cap, w_band,
                      match, mismatch, gap, device):
    """The consensus stage's fused dispatch in the device-gather form
    (racon_tpu's align_walk_gather_padded / align_walk_gather_batch):
    qblob, tblob and dcblob are word blobs already uploaded to every
    device of gather_devices(device) ({torch.device: tensor},
    ops/gather.put_blob), meta the chunk's (B, 4) int32 numpy rows
    [q_start, m, t_start, n]. Only meta goes up; returns (payload, score,
    fmt) as align_walk_padded does, byte for byte its result on the same
    rows packed by the host. fmt is walk_fmt's, as on the dense route (the
    reference's gather_fmt, which turns tiers failing its VMEM model into
    packed2, has no counterpart: decoded op lists do not depend on the
    walk format). No batch padding and no blob buckets: a launch takes any
    B and any blob length. On an active mesh the meta rows are split over
    it (mesh.sharded_align_walk_gather) and payload and score are lists of
    per-shard tensors."""
    from .gather import check_meta

    fmt = walk_fmt(w_band)
    geo = dict(m_cap=m_cap, n_cap=n_cap, w_band=w_band, match=match,
               mismatch=mismatch, gap=gap, fmt=fmt)
    any_dev = next(iter(qblob))
    check_meta(meta, len(qblob[any_dev]), len(tblob[any_dev]), m_cap=m_cap,
               n_cap=n_cap)
    mesh = _mesh_for(device)
    if mesh is not None:
        from ..parallel.mesh import sharded_align_walk_gather

        payload, score = sharded_align_walk_gather(
            mesh, qblob, tblob, dcblob, meta, **geo)
        return payload, score, fmt
    dev = torch.device(device)
    meta_t = upload(meta, np.int32, dev)
    payload, score = gather_sweep_walk(qblob[dev], tblob[dev], dcblob[dev],
                                       meta_t, **geo)
    return payload, score, fmt

"""Scored banded-NW sweep and RLE traceback walk: the consensus stage's
device core (port of the main path of racon_tpu/ops/nw_kernel.py).

Each function takes its tensors on one device. On a CUDA tensor it
launches the hand-written kernel (kernels/csrc/nw_sweep.cu,
kernels/csrc/rle_walk.cu) and counts the launch; on a CPU tensor it runs
the plain PyTorch version beside it, which is the readable specification
and what the CPU tests hold against the JAX package. Any other device
raises.

Layouts (see ops/batch.py for the packed inputs):
  moves (B, m_cap // 16, W) int32  2-bit moves DIAG=0 > UP=1 > LEFT=2,
                                   3 = outside; 16 rows per word, bit
                                   2*((i-1) % 16) for row i -- the words of
                                   nw_band_batch_t8, transposed from its
                                   (m_cap // 16, W, B)
  score (B,) int32                 H at the end lane
  payload (B, E + 1) uint8         RLE events then the escape flag,
                                   E = rle_events(m_cap, n_cap, W)
"""

from __future__ import annotations

import torch

from ..kernels import LAUNCHES
from .batch import to_device, unpack_bits, unpack_codes
from .geometry import (NEG, PAD_CODE, PACK, RLE_LEFT, RLE_SKIP, RLE_UP,
                       SCAN_FILL, band_dlo, rle_events, scan_span,
                       sweep_fits)


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
    kernels nw_band_batch_t8 / nw_band_batch_t8big."""
    if not sweep_fits(m_cap, n_cap, w_band):
        raise ValueError(f"sweep shape ({m_cap}, {n_cap}, {w_band}) "
                         "unsupported")
    if _device_kind(q4) == "cpu":
        return nw_sweep_plain(q4, t4, dcb, m_cap=m_cap, n_cap=n_cap,
                              w_band=w_band, match=match, mismatch=mismatch,
                              gap=gap)
    from ..kernels.build import kernels

    B = q4.shape[0]
    moves = torch.empty((B, m_cap // PACK, w_band), dtype=torch.int32,
                        device=q4.device)
    score = torch.empty((B,), dtype=torch.int32, device=q4.device)
    kernels().nw_sweep(q4, t4, dcb, moves, score, m_cap, n_cap, w_band,
                       match, mismatch, gap, scan_span(w_band))
    LAUNCHES["nw_sweep"] += 1
    return moves, score


def nw_sweep_plain(q4, t4, dcb, *, m_cap, n_cap, w_band, match, mismatch,
                   gap):
    """Plain PyTorch version of nw_sweep on CPU tensors: a row loop over
    (B, W) band tiles, the same recurrence as nw_band_batch_ref."""
    if q4.device.type != "cpu":
        raise ValueError("nw_sweep_plain takes CPU tensors")
    B = q4.shape[0]
    W = w_band
    dlo = band_dlo(m_cap, n_cap, W)
    q = unpack_codes(q4, m_cap)
    t = unpack_codes(t4, n_cap)
    dc = unpack_bits(dcb, n_cap) * gap
    # target and prefix costs padded by W on both sides so every row's
    # band window is a plain slice; gc[j] is frozen beyond n_cap
    tp = torch.nn.functional.pad(t, (W, W), value=PAD_CODE)
    gc = torch.cat([torch.zeros((B, 1), dtype=torch.int32),
                    torch.cumsum(dc, 1, dtype=torch.int32)], 1)
    gcp = torch.cat([torch.zeros((B, W), dtype=torch.int32), gc,
                     gc[:, -1:].expand(B, W)], 1)
    k = torch.arange(W, dtype=torch.int32)
    fill_lane = k <= scan_span(W) - 2
    j0 = dlo + k
    h = torch.where((j0 >= 0) & (j0 <= n_cap), gcp[:, W + dlo : 2 * W + dlo],
                    torch.tensor(NEG, dtype=torch.int32))
    neg_col = torch.full((B, 1), NEG, dtype=torch.int32)
    moves = torch.zeros((B, m_cap // PACK, W), dtype=torch.int64)
    for i in range(1, m_cap + 1):
        jrow = i + dlo + k
        valid = (jrow >= 1) & (jrow <= n_cap)
        inside = valid | (jrow == 0)
        start = i - 1 + W + dlo
        t_row = tp[:, start : start + W]
        gc_here = gcp[:, start + 1 : start + 1 + W]
        qi = q[:, i - 1 : i]
        sub = torch.where((t_row == PAD_CODE) ^ (qi == PAD_CODE), NEG,
                          torch.where(t_row == qi, match, mismatch))
        diag_c = h + sub
        up_c = torch.cat([h[:, 1:], neg_col], 1) + gap
        cand = torch.maximum(diag_c, up_c)
        cand = torch.where(jrow == 0, i * gap, cand)
        cand = torch.where(inside, cand, NEG)
        a = torch.cummax(cand - gc_here, dim=1).values
        a = torch.where(fill_lane, torch.clamp(a, min=SCAN_FILL), a)
        h = torch.where(inside, a + gc_here, NEG).to(torch.int32)
        mv = torch.where(h == diag_c, 0, torch.where(h == up_c, 1, 2))
        mv = torch.where(valid, mv, 3).to(torch.int64)
        moves[:, (i - 1) // PACK] |= mv << (2 * ((i - 1) % PACK))
    score = h[:, n_cap - m_cap - dlo].clone()
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


# ------------------------------------------------------------ fused call


def align_walk_padded(q4, t4, dcb, m, n, *, m_cap, n_cap, w_band, match,
                      mismatch, gap, device):
    """The consensus stage's fused dispatch: the packed numpy batch goes to
    `device`, through the sweep and the RLE walk, and comes back as
    (payload (B, rle_events + 1) uint8, score (B,) int32, "rle") on that
    device, in the reference's payload format (decode with
    bindings.opstream_rle_to_ops_batch). Unlike the reference there is no
    padding of the batch: a kernel launch takes any B."""
    batch = to_device(q4, t4, dcb, m, n, m_cap=m_cap, n_cap=n_cap,
                      device=device)
    moves, score = nw_sweep(batch.q4, batch.t4, batch.dcb, m_cap=m_cap,
                            n_cap=n_cap, w_band=w_band, match=match,
                            mismatch=mismatch, gap=gap)
    payload = rle_walk(moves, batch.m, batch.n, m_cap=m_cap, n_cap=n_cap,
                       w_band=w_band)
    return payload, score, "rle"

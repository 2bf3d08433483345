"""Myers bit-parallel banded edit-distance sweep and its word-wise walk:
the align stage's device core (port of racon_tpu/ops/myers_kernel.py).
Beside them, the plane-to-move transform myers_moves (J5): the planes
turned into the scored sweep's 2-bit moves, so the RLE walk
(nw_kernel.rle_walk) runs on Myers output and emits the compact "rle"
payload (align_walk_myers_padded(fmt="rle"), ~cap/4 bytes an item
against the rows payload's cap + 2).

On a CUDA tensor each function launches its hand-written kernel
(kernels/csrc/myers_sweep.cu, kernels/csrc/myers_walk.cu,
kernels/csrc/myers_moves.cu) and counts the launch; on a CPU tensor it
runs the plain PyTorch version beside it; any other device raises.

Layouts:
  planes  (B, m_cap, 2, W // 32) int32  per query row the DIAG (= Eq | ~D0)
                                        and UP (= HP) band words; the
                                        reference's myers_sweep_ref returns
                                        the same words as (m_cap, 2, nw, B)
  payload (B, m_cap + 2) uint8          the rows format of walk_rows_t:
                                        per-row records REC_DIAG/REC_UP |
                                        deletions << 2, the final-deletions
                                        byte, the escape flag
  moves   (B, m_cap // 16, W) int32     myers_moves' output, the scored
                                        sweep's layout (ops/nw_kernel.py)
"""

from __future__ import annotations

import torch

from ..kernels import LAUNCHES
from .batch import to_device, unpack_codes
from .geometry import (NW_CODES, PACK, REC_DIAG, REC_UP, band_dlo,
                       guard_bits, myers_fits, peq_words, rows_payload_width)
from .nw_kernel import _as_int32_bits, _device_kind, _mesh_for, rle_walk

_M32 = 0xFFFFFFFF


def myers_sweep(q4, t4, *, m_cap, n_cap, w_band):
    """q4 (B, m_cap//2), t4 (B, n_cap//2) uint8 -> planes
    (B, m_cap, 2, W//32) int32. Replaces the TPU kernel myers_sweep_t and
    its Peq build build_peq_win_T (folded into the kernel)."""
    if not myers_fits(m_cap, n_cap, w_band):
        raise ValueError(f"Myers shape ({m_cap}, {n_cap}, {w_band}) "
                         "unsupported")
    if _device_kind(q4) == "cpu":
        return myers_sweep_plain(q4, t4, m_cap=m_cap, n_cap=n_cap,
                                 w_band=w_band)
    from ..kernels.build import kernels

    planes = torch.empty((q4.shape[0], m_cap, 2, w_band // 32),
                         dtype=torch.int32, device=q4.device)
    kernels().myers_sweep(q4, t4, planes, m_cap, n_cap, w_band)
    LAUNCHES["myers_sweep"] += 1
    return planes


def myers_walk(planes, m, n, *, m_cap, n_cap, w_band):
    """planes from myers_sweep, m/n (B,) int32 -> rows payload
    (B, m_cap + 2) uint8, byte for byte that of myers_walk_t."""
    if _device_kind(planes) == "cpu":
        return myers_walk_plain(planes, m, n, m_cap=m_cap, n_cap=n_cap,
                                w_band=w_band)
    from ..kernels.build import kernels

    payload = torch.empty((planes.shape[0], rows_payload_width(m_cap)),
                          dtype=torch.uint8, device=planes.device)
    kernels().myers_walk(planes, m, n, payload, m_cap, n_cap, w_band)
    LAUNCHES["myers_walk"] += 1
    return payload


def myers_moves(planes, m, *, m_cap, n_cap, w_band):
    """planes from myers_sweep, m (B,) int32 -> moves (B, m_cap//16, W)
    int32 in the scored sweep's layout: per cell 0 where the DIAG bit is
    set, else 1 where UP is, else 2; 3 where jrow = i + dlo + k is < 1 or
    > n_cap and for rows i > m. Replaces myers_moves_from_planes, whose
    (m_cap//16, W, B) moves these are transposed."""
    if _device_kind(planes) == "cpu":
        return myers_moves_plain(planes, m, m_cap=m_cap, n_cap=n_cap,
                                 w_band=w_band)
    from ..kernels.build import kernels

    moves = torch.empty((planes.shape[0], m_cap // PACK, w_band),
                        dtype=torch.int32, device=planes.device)
    kernels().myers_moves(planes, m, moves, m_cap, n_cap, w_band)
    LAUNCHES["myers_moves"] += 1
    return moves


# ---------------------------------------------------------- plain versions
# 32-bit words are held in int64 tensors (values 0 .. 2^32 - 1), so
# shifts and complements are masked back to 32 bits.


def build_peq_plain(t4, n_cap: int, w_band: int) -> torch.Tensor:
    """(B, n_cap//2) nibble codes -> (B, NW_CODES, peq_words) int64 words:
    bit p of plane c = [t[p - guard] == c], zero guards on both sides
    (build_peq_T's mask)."""
    B = t4.shape[0]
    g = guard_bits(w_band)
    nwp = peq_words(n_cap, w_band)
    t = unpack_codes(t4, n_cap)
    tp = torch.nn.functional.pad(t, (g, 32 * nwp - n_cap - g), value=-1)
    codes = torch.arange(NW_CODES, dtype=torch.int32)
    bits = (tp[:, None, :] == codes[None, :, None]).to(torch.int64)
    weights = torch.ones(32, dtype=torch.int64) << torch.arange(32)
    return (bits.reshape(B, NW_CODES, nwp, 32) * weights).sum(-1)


def _shift_words_up(a, s=1):
    """Word w takes word w - s (toward higher word index), zeros below."""
    return torch.nn.functional.pad(a[:, : a.shape[1] - s], (s, 0))


def _shift_words_down(a):
    """Word w takes word w + 1, zero at the top."""
    return torch.nn.functional.pad(a[:, 1:], (0, 1))


def _mask_ge(pos, nw: int):
    """Bits >= pos (an int or (B, 1) tensor) over nw words."""
    sh = torch.clamp(pos - 32 * torch.arange(nw), 0, 32)
    return torch.where(sh >= 32, 0, (_M32 << torch.clamp(sh, max=31)) & _M32)


def _mask_le(pos, nw: int):
    """Bits <= pos per item ((B, 1) tensor) over nw words."""
    sh = torch.clamp(pos - 32 * torch.arange(nw) + 1, 0, 32)
    return torch.where(sh >= 32, _M32, (1 << torch.clamp(sh, max=31)) - 1)


def _onehot(pos, nw: int):
    rel = pos - 32 * torch.arange(nw)
    inw = (rel >= 0) & (rel < 32)
    return torch.where(inw, 1 << torch.clamp(rel, 0, 31), 0)


def _add_words(x, y):
    """Multi-word x + y with the carry rippling across words (the
    reference's _add_carry: a log-step carry-lookahead)."""
    s = x + y
    s0 = s & _M32
    gen = _shift_words_up(s >> 32)
    prop = _shift_words_up((s0 == _M32).to(torch.int64))
    step = 1
    while step < x.shape[1]:
        gen = gen | (prop & _shift_words_up(gen, step))
        prop = prop & _shift_words_up(prop, step)
        step *= 2
    return (s0 + gen) & _M32


def _shl1(x):
    return ((x << 1) & _M32) | (_shift_words_up(x) >> 31)


def _shr1(x, fill_bit: int):
    hi = (_shift_words_down(x) & 1) << 31
    hi[:, -1] = fill_bit << 31
    return (x >> 1) | hi


def myers_sweep_plain(q4, t4, *, m_cap, n_cap, w_band):
    """Plain PyTorch version of myers_sweep on CPU tensors: the row
    recurrence of myers_sweep_ref on (B, nw) word tiles."""
    if q4.device.type != "cpu":
        raise ValueError("myers_sweep_plain takes CPU tensors")
    B = q4.shape[0]
    W = w_band
    nw = W // 32
    dlo = band_dlo(m_cap, n_cap, W)
    g = guard_bits(W)
    q = unpack_codes(q4, m_cap).to(torch.int64)
    peq = build_peq_plain(t4, n_cap, W)
    rows = torch.arange(B)
    PV = _mask_ge(-dlo, nw).expand(B, nw).clone()
    MV = torch.zeros((B, nw), dtype=torch.int64)
    planes = torch.empty((B, m_cap, 2, nw), dtype=torch.int64)
    for i in range(1, m_cap + 1):
        kz = -(i + dlo)
        pos0 = i + dlo - 1 + g
        w0, r = pos0 >> 5, pos0 & 31
        qi = q[:, i - 1]
        lo = peq[rows, torch.clamp(qi, max=NW_CODES - 1), w0 : w0 + nw]
        if r:
            hi = peq[rows, torch.clamp(qi, max=NW_CODES - 1),
                     w0 + 1 : w0 + 1 + nw]
            lo = ((lo >> r) | (hi << (32 - r))) & _M32
        eq = torch.where((qi < NW_CODES)[:, None], lo, 0)
        keep = _mask_ge(kz + 1, nw)
        PV, MV, eq = PV & keep, MV & keep, eq & keep
        X = eq | MV
        S = _add_words(X & PV, PV)
        D0 = (S ^ PV) | X
        HN = PV & D0
        HP = MV | (~(PV | D0) & _M32)
        oh = _onehot(kz, nw)
        HP = HP | oh
        HN = HN & ~oh
        X2 = _shl1(HP)
        PVn = _shl1(HN) | (~(D0 | X2) & _M32)
        MVn = D0 & X2
        planes[:, i - 1, 0] = eq | (~D0 & _M32)
        planes[:, i - 1, 1] = HP
        PV = _shr1(PVn, 1)
        MV = _shr1(MVn, 0)
    return _as_int32_bits(planes)


def _hibit(x):
    """Highest set bit of 32-bit words in int64 (0 for x == 0)."""
    r = torch.zeros_like(x)
    for sh in (16, 8, 4, 2, 1):
        big = (x >> sh) != 0
        r = r + torch.where(big, sh, 0)
        x = torch.where(big, x >> sh, x)
    return r


def myers_walk_plain(planes, m, n, *, m_cap, n_cap, w_band):
    """Plain PyTorch version of myers_walk on CPU tensors: rows m_cap..1
    stepped in lockstep over the batch, as myers_walk_ref does."""
    if planes.device.type != "cpu":
        raise ValueError("myers_walk_plain takes CPU tensors")
    B = planes.shape[0]
    W = w_band
    nw = W // 32
    dlo = band_dlo(m_cap, n_cap, W)
    words = planes.to(torch.int64) & _M32
    m64 = m.to(torch.int64)
    kvec = (n.to(torch.int64) - m64 - dlo)[:, None]
    esc = torch.zeros((B, 1), dtype=torch.bool)
    w32 = 32 * torch.arange(nw)
    recs = torch.zeros((B, m_cap), dtype=torch.int64)
    for i in range(m_cap, 0, -1):
        oh = _onehot(-(i + dlo), nw)
        diag = words[:, i - 1, 0] & ~oh
        up = words[:, i - 1, 1] | oh
        masked = (diag | up) & _mask_le(kvec, nw)
        cand = torch.where(masked != 0, w32 + _hibit(masked), -1)
        k_exit = cand.max(dim=1, keepdim=True).values
        ohx = _onehot(k_exit, nw)
        diag_hit = ((diag & ohx) != 0).any(dim=1, keepdim=True)
        up_hit = ((up & ohx) != 0).any(dim=1, keepdim=True)
        nleft = kvec - k_exit
        inband = (kvec >= 0) & (kvec < W)
        active = (i <= m64)[:, None] & ~esc
        esc = esc | (active & (~inband | (k_exit < 0) | (nleft > 63)))
        act2 = active & ~esc
        op = torch.where(diag_hit, REC_DIAG, REC_UP)
        recs[:, i - 1] = torch.where(act2, op | (nleft << 2), 0)[:, 0]
        kvec = torch.where(act2, k_exit + (up_hit & ~diag_hit).long(), kvec)
    jfin = dlo + kvec
    esc = esc | (jfin < 0) | (jfin > 255)
    return torch.cat([recs, torch.clamp(jfin, 0, 255), esc.long()],
                     1).to(torch.uint8)


def myers_moves_plain(planes, m, *, m_cap, n_cap, w_band, rows=1024):
    """Plain PyTorch version of myers_moves on CPU tensors, `rows` query
    rows at a time (the unpacked lanes of a whole item would take GBs at
    the long-read tiers): per row the low code bit (DIAG clear, UP set)
    and the high one (both clear) as band words, unpacked to lanes, 3 past
    the band's columns and the item's rows, 16 rows packed a word."""
    if planes.device.type != "cpu":
        raise ValueError("myers_moves_plain takes CPU tensors")
    B = planes.shape[0]
    W = w_band
    dlo = band_dlo(m_cap, n_cap, W)
    bit = torch.arange(32, dtype=torch.int32)
    k = torch.arange(W)
    shifts = 2 * torch.arange(PACK, dtype=torch.int64)[:, None]
    m64 = m.to(torch.int64)[:, None, None]
    moves = torch.empty((B, m_cap // PACK, W), dtype=torch.int32)
    for r0 in range(0, m_cap, rows):
        r1 = min(m_cap, r0 + rows)
        d, u = planes[:, r0:r1, 0], planes[:, r0:r1, 1]   # int32 words
        lo, hi = ~d & u, ~(d | u)                          # codes 1 and 2
        code = (((lo[..., None] >> bit) & 1)
                | (((hi[..., None] >> bit) & 1) << 1))
        code = code.reshape(B, r1 - r0, W)
        i = torch.arange(r0 + 1, r1 + 1)[None, :, None]
        jrow = i + dlo + k
        valid = (jrow >= 1) & (jrow <= n_cap) & (i <= m64)
        code = torch.where(valid, code, 3).to(torch.int64)
        packed = (code.reshape(B, (r1 - r0) // PACK, PACK, W)
                  << shifts).sum(2)
        moves[:, r0 // PACK : r1 // PACK] = _as_int32_bits(packed)
    return moves


def align_walk_myers_padded(q4, t4, m, n, *, m_cap, n_cap, w_band, device,
                            fmt="rows"):
    """The align stage's fused dispatch: the packed numpy batch goes to
    `device`, through the Myers sweep and a walk, and comes back as
    (payload, score zeros (B,) int32, payload format) on that device. fmt
    "rows" (the stage's): the Myers walk's (B, m_cap + 2) rows payload
    (decode with bindings.opstream_rows_to_ops_batch). fmt "rle"
    (racon_tpu's align_walk_myers_rle_batch): the planes through
    myers_moves and the RLE walk at rle_events(m_cap, n_cap, W), the
    planes released before the walk; the (B, E + 1) "rle" payload that
    nw_kernel.payload_decoder decodes. As in the reference, the
    edit-distance stage produces no score. The batch is not padded: a
    kernel launch takes any B. On an active mesh of `device`'s type
    (nw_kernel.align_walk_padded) the batch is split over it and payload
    and score are lists of per-shard tensors; the payload is "rows"
    whatever fmt asks, as the reference's is on a mesh."""
    if fmt not in ("rows", "rle"):
        raise ValueError(f"unknown Myers payload format {fmt!r}")
    mesh = _mesh_for(device)
    if mesh is not None:
        from ..parallel.mesh import sharded_align_walk

        payload, score = sharded_align_walk(
            mesh, q4, t4, None, m, n, m_cap=m_cap, n_cap=n_cap,
            w_band=w_band, match=0, mismatch=-1, gap=-1, fmt="myers")
        return payload, score, "rows"
    batch = to_device(q4, t4, None, m, n, m_cap=m_cap, n_cap=n_cap,
                      device=device)
    geo = dict(m_cap=m_cap, n_cap=n_cap, w_band=w_band)
    planes = myers_sweep(batch.q4, batch.t4, **geo)
    score = torch.zeros_like(batch.m)
    if fmt == "rows":
        return myers_walk(planes, batch.m, batch.n, **geo), score, "rows"
    moves = myers_moves(planes, batch.m, **geo)
    del planes  # the moves are as large: free the planes before the walk
    return rle_walk(moves, batch.m, batch.n, **geo), score, "rle"

"""The Myers sweep kernel's design (kernels/csrc/myers_sweep.cu) on the
CPU: a numpy model of its per-lane row step -- WPL words a lane, Eq
loaded a row ahead from query codes held eight to a lane word, the
ballot carry across lanes, the band shift as one shuffle of D0, the edge
rows (i <= -dlo) apart from the rest -- held bit for bit against the
port's plain version myers_sweep_plain and the JAX package's jnp oracle
myers_sweep_ref; then the kernel's launch geometry (ops/geometry.py,
against the kernel's constants) and the align stage's Myers chunk."""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from racon_tpu.ops.myers_kernel import build_peq_T, myers_sweep_ref
from racon_tpu.ops.nw_kernel import encode, pack_codes4
from racon_tpu_torch.ops import align_stage, geometry
from racon_tpu_torch.ops import myers_kernel as port
from racon_tpu_torch.ops.consensus_stage import chunk_size, chunk_spans

torch.set_num_threads(2)
ACGT = np.frombuffer(b"ACGT", np.uint8)
M32 = np.uint64(0xFFFFFFFF)
U32 = np.uint32


def _items(seed, cap, w, B):
    """B pairs at cap: mutated reads (5 % each of substitutions,
    insertions, deletions) with every fourth item all PAD past a third of
    its query, item 1 all PAD, item 2 identical, and item 3's target
    running W/2 - 72 bases past its query (8 below W = 160): a drift to
    the band's margin."""
    rng = np.random.default_rng(seed)
    drift = max(w // 2 - 72, 8)
    pairs = []
    for b in range(B):
        tl = int(rng.integers(cap // 2, cap + 1))
        t = rng.choice(ACGT, tl)
        if b == 1:
            pairs.append((np.zeros(0, np.uint8), np.zeros(0, np.uint8)))
            continue
        if b == 2:
            pairs.append((t.copy(), t))
            continue
        if b == 3:
            t = rng.choice(ACGT, int(rng.integers((cap - drift) // 2,
                                                  cap - drift + 1)) + drift)
            q = t[: len(t) - drift].copy()
            sub = rng.random(len(q)) < 0.05
            q[sub] = rng.choice(ACGT, int(sub.sum()))
            pairs.append((q, t))
            continue
        q = t[rng.random(tl) > 0.05]
        ins = np.flatnonzero(rng.random(len(q)) < 0.05)
        q = np.insert(q, ins, rng.choice(ACGT, len(ins)))
        sub = rng.random(len(q)) < 0.05
        q[sub] = rng.choice(ACGT, int(sub.sum()))
        if b % 4 == 0:
            q = q[: len(q) // 3]
        pairs.append((q[:cap], t))
    q8 = np.full((B, cap), 5, np.int8)
    t8 = np.full((B, cap), 5, np.int8)
    for b, (qa, ta) in enumerate(pairs):
        q8[b, : len(qa)] = encode(qa)
        t8[b, : len(ta)] = encode(ta)
    return q8, t8


def _funnel(lo, hi, r):
    """(hi:lo >> r) & M32 on uint32 arrays (r 0..31): __funnelshift_r."""
    both = (hi.astype(np.uint64) << np.uint64(32)) | lo.astype(np.uint64)
    return ((both >> np.uint64(r)) & M32).astype(U32)


def _mask_ge(pos, w):
    sh = pos - 32 * w
    out = np.where(sh <= 0, 0xFFFFFFFF, 0).astype(np.uint64)
    mid = (sh > 0) & (sh < 32)
    out[mid] = (np.uint64(0xFFFFFFFF) << sh[mid].astype(np.uint64)) & M32
    return out.astype(U32)


def _onehot(pos, w):
    rel = pos - 32 * w
    inw = (rel >= 0) & (rel < 32)
    return np.where(inw, np.uint64(1) << np.clip(rel, 0, 31).astype(
        np.uint64), 0).astype(U32)


def sweep_model(q4, t4, *, m_cap, n_cap, w_band):
    """numpy model of myers_sweep.cu on (B, 32 lanes, WPL words) arrays,
    step for step as the kernel's warp computes it, garbage in the words
    at or above nw included. Returns planes (B, m_cap, 2, nw) uint32."""
    B = q4.shape[0]
    W = w_band
    nw = W // 32
    WPL = 1 if nw <= 32 else (2 if nw <= 64 else 4)
    guard = W // 2 + 32
    nwp = (n_cap + 2 * guard) // 32
    dlo = n_cap - m_cap - W // 2
    lane = np.arange(32)
    w = lane[:, None] * WPL + np.arange(WPL)[None, :]           # (32, WPL)
    wx = lane[:, None] * WPL + np.arange(WPL + 1)[None, :]      # window
    bidx = np.arange(B)[:, None, None]

    # the Peq planes the warp builds in shared memory
    t = np.stack([t4 & 15, t4 >> 4], -1).reshape(B, n_cap)
    pos = np.arange(32 * nwp) - guard
    inside = (pos >= 0) & (pos < n_cap)
    tp = np.where(inside[None], t[:, np.clip(pos, 0, n_cap - 1)], 255)
    weights = np.uint64(1) << np.arange(32, dtype=np.uint64)
    peq = np.stack([((tp == c).reshape(B, nwp, 32).astype(np.uint64)
                     * weights).sum(-1) for c in range(6)], 1).astype(U32)

    # query codes: one little-endian word of 8 codes a lane, 256 a chunk
    nchunks = -(-m_cap // 256) + 2
    qb = np.zeros((B, nchunks * 128), np.uint8)
    qb[:, : m_cap // 2] = q4
    qwords = qb.view("<u4").reshape(B, nchunks, 32)

    def code_at(qcur, r):  # one __shfl_sync of lane (r >> 3) & 31
        return ((qcur[:, (r >> 3) & 31] >> U32(4 * (r & 7))) & 15).astype(
            np.int64)

    def load_window(code, i):
        idx = ((i + dlo - 1 + guard) >> 5) + wx                 # (32, W+1)
        ok = (code < 6)[:, None, None] & (wx <= nw)[None]
        vals = peq[bidx, np.clip(code, 0, 5)[:, None, None],
                   np.clip(idx, 0, nwp - 1)[None]]
        return np.where(ok, vals, U32(0))

    PV = np.broadcast_to(np.where(w < nw, _mask_ge(-dlo, w), U32(0)),
                         (B, 32, WPL)).copy()
    MV = np.zeros((B, 32, WPL), U32)
    top = np.where(w == nw - 1, U32(1 << 31), U32(0))
    qcur, qnxt = qwords[:, 0], qwords[:, 1]
    raw = load_window(code_at(qcur, 0), 1)
    code1 = code_at(qcur, 1)
    planes = np.zeros((B, m_cap, 2, 32 * WPL), U32)
    lane_bits = np.uint64(1) << lane.astype(np.uint64)
    for i in range(1, m_cap + 1):
        edge = i <= -dlo
        r = (i + dlo - 1 + guard) & 31
        eq = np.where(w < nw, _funnel(raw[..., :WPL], raw[..., 1:], r),
                      U32(0))
        raw = load_window(code1, i + 1)
        if (i + 1) % 256 == 0:
            qcur, qnxt = qnxt, qwords[:, (i + 1) // 256 + 1]
        code1 = code_at(qcur, i + 1)
        kz = -(i + dlo)
        if edge:
            keep = _mask_ge(kz + 1, w)
            PV, MV, eq = PV & keep, MV & keep, eq & keep
            oh = _onehot(kz, w)
        X = eq | MV
        xp = X & PV
        S = xp + PV                                             # wraps
        gx, px = S < xp, S == U32(0xFFFFFFFF)
        G = np.zeros((B, 32), bool)
        P = np.ones((B, 32), bool)
        for x in range(WPL):
            G = gx[..., x] | (px[..., x] & G)
            P = P & px[..., x]
        Gm = (G * lane_bits).sum(1)                             # ballots
        Am = Gm | (P * lane_bits).sum(1)
        cin = ((Am + Gm) ^ Am ^ Gm) & M32
        c = ((cin[:, None] >> lane.astype(np.uint64)) & np.uint64(1)
             ).astype(bool)
        D0 = np.empty_like(S)
        for x in range(WPL):
            s = S[..., x] + c.astype(U32)
            c = gx[..., x] | (px[..., x] & c)
            D0[..., x] = (s ^ PV[..., x]) | X[..., x]
        HN = PV & D0
        HP = MV | ~(PV | D0)
        if edge:
            HP, HN = HP | oh, HN & ~oh
        # __shfl_down_sync(D0[0], 1): lane 31 reads its own word
        above = np.concatenate([D0[:, 1:, 0], D0[:, 31:, 0]], 1)
        nxt = np.concatenate([D0[..., 1:], above[..., None]], -1)
        D0s = _funnel(D0, nxt, 1)
        PV = (HN | ~(D0s | HP)) | top
        MV = D0s & HP & ~top
        planes[:, i - 1, 0] = (eq | ~D0).reshape(B, -1)
        planes[:, i - 1, 1] = HP.reshape(B, -1)
    return planes[..., :nw]


def _check(cap, w, B, seed):
    q8, t8 = _items(seed, cap, w, B)
    q4, t4 = pack_codes4(q8), pack_codes4(t8)
    model = sweep_model(q4, t4, m_cap=cap, n_cap=cap, w_band=w)
    plain = port.myers_sweep_plain(torch.from_numpy(q4), torch.from_numpy(t4),
                                   m_cap=cap, n_cap=cap, w_band=w)
    assert np.array_equal(model.view(np.int32), plain.numpy())
    if w % 64:
        return model  # the reference's Peq build takes W/2 in whole words
    want = myers_sweep_ref(jnp.asarray(q8.astype(np.int32).T),
                           build_peq_T(jnp.asarray(t8.astype(np.int32).T),
                                       cap, w),
                           m_cap=cap, n_cap=cap, w_band=w)
    assert np.array_equal(model.view(np.int32).transpose(1, 2, 3, 0),
                          np.asarray(want))
    return model


@pytest.mark.parametrize("cap,w,B", [
    (1024, 512, 6),    # WPL 1, lanes 16-31 idle; 256 edge rows, 4 chunks
    (1024, 1024, 5),   # WPL 1, every lane; 512 edge rows
    (640, 1120, 4),    # WPL 2 with an odd nw (35): an idle word in a lane
                       # (against the plain version alone: the reference
                       # builds Peq for W a multiple of 64)
    (1280, 2048, 4),   # WPL 2; 1024 edge rows, then 256
    (2560, 4096, 4),   # WPL 4; 2048 edge rows, then 512
    (128, 64, 9),      # W < m_cap, few lanes; m_cap below one chunk
])
def test_row_step_model_matches_plain_and_reference(cap, w, B):
    """The kernel's row step is the reference's, bit for bit, on every
    word of every row: rows past m (all PAD), an all-PAD item, a drift at
    the band's margin, and the rows where the j = 0 lane enters and
    leaves the band (i <= W/2, then below)."""
    _check(cap, w, B, cap + w)


def test_one_shuffle_band_shift_is_the_reference_shift():
    """The identity the kernel rests on: shifting HP and HN up one bit
    (_shl1), forming PVn and MVn, and shifting those down one (_shr1) is
    D0 shifted down one, PV' = HN | ~(D0s | HP), MV' = D0s & HP, with the
    band's top bit 1 in PV' and 0 in MV' -- on random 1024-bit vectors."""
    rng = np.random.default_rng(3)
    nw, B = 32, 64
    words = lambda: torch.from_numpy(
        rng.integers(0, 1 << 32, (B, nw), dtype=np.int64))
    D0, HP, HN = words(), words(), words()
    X2 = port._shl1(HP)
    PV = port._shr1(port._shl1(HN) | (~(D0 | X2) & 0xFFFFFFFF), 1)
    MV = port._shr1(D0 & X2, 0)
    D0s = port._shr1(D0, 0)
    topbit = torch.zeros(nw, dtype=torch.int64)
    topbit[-1] = 1 << 31
    assert torch.equal(PV, (HN | (~(D0s | HP) & 0xFFFFFFFF)) | topbit)
    assert torch.equal(MV, D0s & HP & ~topbit)


_CSRC = Path(geometry.__file__).parents[1] / "kernels" / "csrc"


def test_sweep_geometry_mirrors_the_kernel():
    """One warp and one item a block, the Peq planes its shared memory."""
    src = (_CSRC / "myers_sweep.cu").read_text()
    assert "__launch_bounds__(32)" in src
    assert re.search(r"<<<B, 32, smem, stream>>>", src)
    assert "6) * nwp * 4" in src


@pytest.mark.parametrize("cap,w", [(2560, 512), (10240, 1024),
                                   (40960, 1024), (10240, 4096),
                                   (40960, 4096)])
@pytest.mark.parametrize("B", [409, 1024])
def test_sweep_launch_covers_the_card(cap, w, B):
    """At the align tiers and both chunk sizes a launch has a block for
    every item (at least min(B, 132) blocks on the H100's 132 SMs), one
    warp a block, and its Peq planes within the 48 KB a block gets without
    raising the limit."""
    blocks, threads, smem = geometry.myers_sweep_launch(B, cap, w)
    assert blocks >= min(B, 132) and blocks == B
    assert threads == 32
    assert smem == 6 * 4 * geometry.peq_words(cap, w) <= 48 * 1024
    assert geometry.myers_fits(cap, cap, w)


@pytest.mark.parametrize("B", [1, 31, 133, 959, 1023])
def test_sweep_launch_ragged_batches(B):
    assert geometry.myers_sweep_launch(B, 10240, 1024)[0] == B


@pytest.mark.parametrize("cap,w,items", [(2560, 512, 1024),
                                         (10240, 1024, 1024),
                                         (40960, 1024, 409),
                                         (10240, 4096, 409),
                                         (40960, 4096, 102)])
def test_align_chunk_by_planes_budget(cap, w, items):
    """The Myers route's chunk is what 4 GiB of planes hold (cap x 2 x W/8
    bytes an item), at most 1024 items; the scored route keeps the
    consensus stage's 1 GiB move budget."""
    assert align_stage._chunk_size(cap, w, True) == items
    assert items * cap * 2 * (w // 8) <= 4 << 30
    assert align_stage._chunk_size(cap, w, False) == chunk_size(cap, w,
                                                                 1024)


@pytest.mark.parametrize("k,step,spans", [(11500, 1024, 12),
                                          (11500, 409, 29), (409, 409, 1),
                                          (1025, 1024, 2), (1, 1024, 1)])
def test_chunk_spans_cover_each_item_once(k, step, spans):
    """The 4.6 Mb set's 11500 overlaps: 12 near-equal chunks of <= 1024
    at the new chunk (29 at the old 409)."""
    out = chunk_spans(k, step)
    assert len(out) == spans
    cover = np.concatenate([np.arange(lo, hi) for lo, hi in out])
    assert np.array_equal(cover, np.arange(k))
    sizes = [hi - lo for lo, hi in out]
    assert max(sizes) <= step and max(sizes) - min(sizes) <= spans

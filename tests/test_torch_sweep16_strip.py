"""numpy models of two CUDA kernels of the PyTorch port, held byte for
byte against their plain versions (and the JAX package) on the CPU:

- the int16 strip sweep (kernels/csrc/nw_sweep16.cu,
  nw_sweep16_strip_kernel, W = 288 .. 1024 under RACON_TPU_DP16=1): s16x2
  pairs with H kept less gc and one-hot codes, as the int16 warp kernel,
  in warp strips that hand each other the carry and the first-lane H
  through rings of SWEEP_RING row-tagged slots, skewed so that lane 31's
  last lane takes its up candidate when the next row starts. Each warp
  runs as a generator that stops at each wait; a seeded scheduler resumes,
  at random, any warp whose slot holds the row it waits for. Against
  nw_sweep_plain with RACON_TPU_DP16=1 (which tests/test_torch_dp16.py
  holds against racon_tpu's int16 t8 kernels and the int32 sweep);
- the Myers plane-to-move transform (kernels/csrc/myers_moves.cu, J5): a
  lane a (item, 16-row group, 32-lane word) tile, its 32 plane words
  loaded (none for a tile without a valid cell), an in-register 32 x 32
  bit transpose, the codes and masks, and the warp's 32 tiles staged
  through shared memory for 16-byte coalesced stores. Against
  myers_moves_plain and racon_tpu's myers_moves_from_planes.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from racon_tpu.ops.myers_kernel import myers_moves_from_planes, sweep_rows_g
from racon_tpu_torch.ops import geometry
from racon_tpu_torch.ops import myers_kernel as mk
from racon_tpu_torch.ops import nw_kernel as port
from test_torch_myers_rle import _items, _ref_planes
from test_torch_nw_sweep import (_M16, _Ring, _dup16, _halves, _pair,
                                 _prmt, _s16, _slice16_onehot, _strip_case,
                                 _u32, _viaddmax2, _vmaxs2, _vminu2)

torch.set_num_threads(2)
_CSRC = Path(__file__).resolve().parents[1] / "racon_tpu_torch" / "kernels" \
    / "csrc"
_M32 = 0xFFFFFFFF

# ---------------------------------------------- the int16 strip sweep (K2-16)


def _strip16_warp(w, nw, qs, cs, rings, out, *, m_cap, n_cap, w_band, pairs,
                  match, mismatch, gap, broken=None):
    """Warp w of nw_sweep16_strip_kernel on every item at once (pair words
    (B, 32 threads, P)), instruction for instruction as the kernel computes
    them (see _sweep16_warp_model for the row inside a strip). Yields
    (ring, row) before each wait and writes its moves and score into
    `out`. `broken`="noup" never takes lane 31's deferred up candidate."""
    W, P = w_band, pairs
    L, S = 2 * P, 64 * P
    B = qs.shape[0]
    _, neg, fill_v = geometry.dp_consts(m_cap, n_cap, match, mismatch, gap)
    dlo = geometry.band_dlo(m_cap, n_cap, W)
    span = geometry.scan_span(W)
    k = w * S + np.arange(S)
    k0 = (w * S + L * np.arange(32))[None, :]            # (1, 32)
    lane = np.arange(32)[None, :]
    lane31 = lane == 31
    has_left, has_right = w > 0, w + 1 < nw
    live = (k0 < W)[0]
    no_up = (lane31 | (k0 + L == W))[:, :, None]
    dm = np.where(lane31 & has_right, 0xFFFF0000, 0)      # (1, 32)
    carry_out, first_out = rings[w]
    match2, mis2, gap2, neg2 = (_dup16(x) for x in (match, mismatch, gap,
                                                    neg))
    ngap2 = _dup16(-gap)

    def col_at(j):
        return np.where((j >= 0) & (j < n_cap),
                        cs[:, np.clip(j, 0, n_cap - 1)], 0xA0)

    def pairs_of(lanes):                                  # (B, S) -> pairs
        return _pair(lanes[..., 0::2], lanes[..., 1::2]).reshape(B, 32, P)

    jz = dlo + k
    hp = pairs_of(np.broadcast_to(
        np.where((k < W) & (jz >= 0) & (jz <= n_cap), 0, neg), (B, S)))
    col = pairs_of(col_at(jz - 1))
    fill = np.broadcast_to(_dup16(fill_v), (B, 32, P)).copy()
    fill[:, :, -1] = pairs_of(np.broadcast_to(
        np.where(k <= span - 2, fill_v, -32768), (B, S)))[:, :, -1]
    acc = np.zeros((B, 32, P), np.int64)
    lo8 = np.zeros_like(acc)
    last = {"d": np.zeros((B, 32), np.int64), "inv": np.zeros((B, 32),
                                                              np.int64)}
    first_out.put(0, _s16(hp[:, 0, 0] & _M16))

    def finish(r):
        p = (r - 1) % 16
        shift = 1 << (2 * (p % 8))
        if has_right:
            ring = rings[w + 1][1]
            yield ring, r - 1
            right = ring.take(r - 1)[:, None]
            if broken != "noup":
                pm = dm & ~last["inv"] & _M32
                up = (_u32((right + gap) << 16) & pm) | (0x80008000 & ~pm
                                                         & _M32)
                h = _vmaxs2(hp[:, :, -1], up)
                own = _vmaxs2(last["d"], up)
                mv = (_vminu2(h ^ last["d"], 0x00010001)
                      + _vminu2(h ^ own, 0x00010001)) \
                    | (last["inv"] & 0x00030003)
            else:
                h, mv = hp[:, :, -1], 2 * 0x00010001
            acc[:, :, -1] = _u32(acc[:, :, -1] + (mv & dm) * shift)
            hp[:, :, -1] = h
        if p == 7:
            lo8[:] = acc
            acc[:] = 0
        elif p == 15:
            words = np.stack([_prmt(lo8, acc, 0x5410),
                              _prmt(lo8, acc, 0x7632)], -1)   # (B,32,P,2)
            words = words.reshape(B, 32, L)[:, live].reshape(B, -1)
            out["moves"][:, (r - 1) // 16, k.reshape(32, L)[live].ravel()] \
                = words
            acc[:] = 0

    def row(i):
        nonlocal hp, col
        sh = qs[:, i - 1][:, None, None]
        other2 = np.where(sh == 2, neg2, mis2)
        jb = i + dlo + k0                                  # (1, 32)
        jw = i + dlo + w * S
        edge = not (jw >= 1 and jw + S - 1 <= n_cap)
        mine = _prmt(col[:, :, 0], hp[:, :, 0], 0x5410)
        nb = np.concatenate([mine[:, 1:], mine[:, -1:]], 1)  # shfl_down 1
        own_col = col_at(np.full(1, jb[0, -1] + L - 2))   # lane 31's read
        col_in = np.where(lane31, own_col, nb)
        above = np.empty_like(hp)
        above[:, :, :-1] = _prmt(hp[:, :, :-1], hp[:, :, 1:], 0x5432)
        above[:, :, -1] = _prmt(hp[:, :, -1],
                                np.where(no_up[:, :, 0], neg2, nb), 0x7632)
        col = np.concatenate([_prmt(col[:, :, :-1], col[:, :, 1:], 0x5432),
                              _prmt(col[:, :, -1:], col_in[:, :, None],
                                    0x5432)], 2)
        eq = _prmt(_u32(col << sh), 0, 0xAA88)
        pad = _prmt(col, 0, 0xAA88)
        sub = (eq & match2) | (~eq & ((pad & neg2) | (~pad & other2)))
        dele = _prmt(col, 0, 0xBB99) & ngap2
        diag = _vadd2(hp, _vadd2(_u32(sub), dele))
        own = _viaddmax2(above, gap2, diag)
        a = own.copy()
        out_m = zero = inv = np.zeros((1, 32, P), np.int64)
        if edge:
            j = (jb[:, :, None] + np.arange(L)).reshape(1, 32, P, 2)
            padl = (k0[:, :, None] + np.arange(L)).reshape(1, 32, P, 2) >= W
            half = lambda m: _pair(np.where(m[..., 0], _M16, 0),
                                   np.where(m[..., 1], _M16, 0))
            out_m = half(padl | (j < 0) | (j > n_cap))
            zero = half(~padl & (j == 0))
            inv = half(padl | (j < 1) | (j > n_cap))
            a = (a & ~zero) | (_dup16(i * gap) & zero)
            a = (a & ~out_m) | (neg2 & out_m)
        a[:, :, 0] = _vmaxs2(a[:, :, 0], _prmt(a[:, :, 0], 0, 0x1010))
        for v in range(1, P):
            a[:, :, v] = _vmaxs2(a[:, :, v], _prmt(a[:, :, v], 0, 0x1010),
                                 _prmt(a[:, :, v - 1], 0, 0x3232))
        tot = np.maximum.accumulate(_s16(a[:, :, -1] >> 16), axis=1)
        excl = np.concatenate([tot[:, :1], tot[:, :-1]], 1)  # shfl_up 1
        carry = np.full((B, 1), -32768)
        if has_left:
            ring = rings[w - 1][0]
            yield ring, i
            carry = ring.take(i)[:, None]
        if has_right:
            carry_out.put(i, np.maximum(carry[:, 0], tot[:, 31]))
        pre = _dup16(np.where(lane > 0, np.maximum(excl, carry), carry))
        h = _vmaxs2(a, pre[:, :, None], fill)
        h = (h & ~out_m) | (neg2 & out_m)
        mv = _vminu2(h ^ diag, 0x00010001) + _vminu2(h ^ own, 0x00010001)
        mv |= inv & 0x00030003
        mv[:, :, -1] &= ~dm & _M32
        acc[:] = _u32(acc + mv * (1 << (2 * ((i - 1) % 8))))
        hp = h
        last["d"] = diag[:, :, -1]
        last["inv"] = np.broadcast_to(inv[:, :, -1], (B, 32))
        if has_left:
            first_out.put(i, _s16(hp[:, 0, 0] & _M16))

    for i in range(1, m_cap + 1):
        if i > 1:
            yield from finish(i - 1)
        yield from row(i)
    yield from finish(m_cap)
    end = n_cap - m_cap - dlo
    if w * S <= end < (w + 1) * S:
        lanes = np.stack(_halves(hp), -1).reshape(B, S)
        gc_end = gap * ((cs >> 15) & 1).sum(1)
        out["score"] = _s16(lanes[:, end - w * S] + gc_end)


def _vadd2(a, b):
    return _pair(_halves(a)[0] + _halves(b)[0], _halves(a)[1] + _halves(b)[1])


def strip16_model(q4, t4, dcb, *, m_cap, n_cap, w_band, match, mismatch,
                  gap, seed, launch_items=None, ring=None, broken=None,
                  ring_cls=_Ring):
    """numpy model of nw_sweep16_strip_kernel at the pairs a thread that
    geometry.sweep16_pairs gives a launch of `launch_items` items (default:
    these) and a ring of `ring` rows (default geometry.SWEEP_RING), its
    warps interleaved by a scheduler seeded with `seed`. Returns (moves,
    score, overruns): overruns counts the reads that found a slot already
    holding a later row. `ring_cls` makes each ring (default _Ring)."""
    W = w_band
    B = q4.shape[0]
    P = geometry.sweep16_pairs(W, launch_items or B)
    nw = geometry.sweep16_warps(W, launch_items or B)
    qs, cs = _slice16_onehot(q4, t4, dcb)
    rings = [(ring_cls(ring or geometry.SWEEP_RING, B),
              ring_cls(ring or geometry.SWEEP_RING, B)) for _ in range(nw)]
    out = {"moves": np.zeros((B, m_cap // 16, W), np.int64)}
    geo = dict(m_cap=m_cap, n_cap=n_cap, w_band=W, pairs=P, match=match,
               mismatch=mismatch, gap=gap, broken=broken)
    warps = [_strip16_warp(w, nw, qs, cs, rings, out, **geo)
             for w in range(nw)]
    waiting = {}
    for w, g in enumerate(warps):
        try:
            waiting[w] = next(g)
        except StopIteration:  # one strip: no wait at all
            pass
    rng = np.random.default_rng(seed)
    while waiting:
        ready = [w for w, (r, row) in waiting.items() if r.ready(row)]
        w = ready[int(rng.integers(len(ready)))]
        try:
            waiting[w] = warps[w].send(None)
        except StopIteration:
            del waiting[w]
    moves = out["moves"]
    moves = np.where(moves >= 2 ** 31, moves - 2 ** 32, moves)
    return (moves.astype(np.int32), out["score"].astype(np.int32),
            sum(r.overruns for pair in rings for r in pair))


def _plain16(monkeypatch, b, geo):
    monkeypatch.setenv("RACON_TPU_DP16", "1")
    assert geometry.sweep_dp16(geo["m_cap"], geo["n_cap"], geo["w_band"],
                               geo["match"], geo["mismatch"], geo["gap"])
    return port.nw_sweep_plain(b.q4, b.t4, b.dcb, **geo)


_CASES = [(cap, w, scores, None)
          for cap, w in ((256, 288), (512, 512), (256, 1024))
          for scores in ((5, -4, -8), (0, -1, -1))] + [
    (512, 512, (0, -1, -1), 1024),     # the launch of 1024 items: 8 pairs
    (256, 1024, (0, -1, -1), 1024),
    (256, 288, (5, -4, -8), 1024)]


@pytest.mark.parametrize("cap,w,scores,launch_items", _CASES)
def test_strip16_model_matches_plain(monkeypatch, cap, w, scores,
                                     launch_items):
    """The int16 strip kernel's schedule (strips of 64 P lanes, the carry
    and first-lane H through rings of SWEEP_RING rows, lane 31's up
    candidate a row late) under two seeded interleavings of its warps,
    byte for byte against nw_sweep_plain under RACON_TPU_DP16=1, with
    make_batch's all-PAD and out-of-band items (the align scores with
    every deletion bit set); no read finds its slot reused. W = 288 cuts
    the last strip (or the only one) short; a launch of 12 items takes
    the rule's two pairs a thread (strips of 128 lanes), one of 1024 items
    eight (a warp an item at W = 288 and 512, two at 1024)."""
    b, geo = _strip_case(cap, w, scores, cap + w + 16)
    want_mv, want_sc = _plain16(monkeypatch, b, geo)
    for seed in (1, 2):
        got_mv, got_sc, overruns = strip16_model(
            b.q4.numpy(), b.t4.numpy(), b.dcb.numpy(), **geo, seed=seed,
            launch_items=launch_items)
        assert overruns == 0
        assert np.array_equal(got_mv, want_mv.numpy())
        assert np.array_equal(got_sc, want_sc.numpy())


@pytest.mark.parametrize("broken", ["ring", "noup"])
def test_strip16_model_broken_differs(monkeypatch, broken):
    """With one row less of ring a warp overwrites a slot its neighbour has
    not read yet; without lane 31's deferred up candidate a cell misses
    the up move across strips: either gives other bytes."""
    b, geo = _strip_case(512, 1024, (5, -4, -8), 3)
    want_mv, _ = _plain16(monkeypatch, b, geo)
    got_mv, _, overruns = strip16_model(
        b.q4.numpy(), b.t4.numpy(), b.dcb.numpy(), **geo, seed=1,
        ring=geometry.SWEEP_RING - 1 if broken == "ring" else None,
        broken=broken)
    assert geometry.sweep16_warps(1024, 12) > 1
    assert (overruns > 0) == (broken == "ring")
    assert not np.array_equal(got_mv, want_mv.numpy())


class _ProbeRing(_Ring):
    """A hand-off ring that keeps the least and the largest value put."""

    def __init__(self, depth, B):
        super().__init__(depth, B)
        self.lo, self.hi = 0, 0

    def put(self, row, v):
        super().put(row, v)
        self.lo, self.hi = min(self.lo, int(v.min())), max(self.hi,
                                                           int(v.max()))


@pytest.mark.parametrize("scores", [(0, -1, -1), (5, -4, -8)])
def test_strip16_gate_holds_in_the_hand_off(monkeypatch, scores):
    """Every value the strips hand each other (the carry and the first-lane
    H, in the scan's space H - gc) lies in [2 neg, (m_cap + n_cap) cmax]
    (a candidate is at worst a sentinel neg plus the PAD substitution neg;
    H - gc is at most m_cap match + n_cap |gap|), measured on the model at
    W = 1024; dp16_eligible keeps that interval inside int16 at every cap
    it takes, up to the largest at W = 1024 with the align scores (7456)
    and at W = 512 with the consensus scores (928)."""
    b, geo = _strip_case(256, 1024, scores, 41)
    want_mv, want_sc = _plain16(monkeypatch, b, geo)
    _, neg, _ = geometry.dp_consts(256, 256, *scores)
    cmax = max(map(abs, scores))
    probes = []

    def probe(depth, B):
        probes.append(_ProbeRing(depth, B))
        return probes[-1]

    got_mv, got_sc, _ = strip16_model(b.q4.numpy(), b.t4.numpy(),
                                      b.dcb.numpy(), **geo, seed=3,
                                      ring_cls=probe)
    assert np.array_equal(got_mv, want_mv.numpy())
    assert np.array_equal(got_sc, want_sc.numpy())
    lo = min(r.lo for r in probes)
    hi = max(r.hi for r in probes)
    assert 2 * neg <= lo < 0 < hi <= 2 * 256 * cmax
    for cap, w, sc in ((7456, 1024, (0, -1, -1)), (928, 512, (5, -4, -8))):
        assert geometry.sweep_dp16(cap, cap, w, *sc)
        assert not geometry.sweep_dp16(cap + 32, cap + 32, w, *sc)
        _, neg, _ = geometry.dp_consts(cap, cap, *sc)
        c = max(map(abs, sc))
        assert -32768 <= 2 * neg and 2 * cap * c <= 32767


def test_strip16_row_loop_has_no_block_barrier():
    """The int16 strip kernel has one __syncthreads, after the codes are
    staged; its row step, its finish step, its row loop (to the kernel's
    end) and the hand-off helpers it takes from common.cuh hold none; the
    ring depth and the rule are geometry's."""
    src = (_CSRC / "nw_sweep16.cu").read_text()
    start = src.index("nw_sweep16_strip_kernel(")
    body = src[start : src.index("\n}\n", start)]
    barrier = body.index("__syncthreads")
    assert "__syncthreads" not in body[barrier + 1 :]
    assert barrier < body.index("auto finish = [&]") \
        < body.index("auto row = [&]") \
        < body.index("for (int i = 1; i <= m_cap; ++i)")
    common = (_CSRC / "common.cuh").read_text()
    helpers = common[common.index("void publish(") :]
    assert "await_row" in helpers and "__syncthreads" not in helpers
    assert "void publish(" not in src and "await_row(" in src
    assert int(re.search(r"kSweepRing = (\d+);", common).group(1)) \
        == geometry.SWEEP_RING
    assert "nw_sweep16_block_kernel" not in src


@pytest.mark.parametrize("W,B", [(288, 1), (288, 1024), (512, 1024),
                                 (512, 528), (512, 131), (1024, 8),
                                 (1024, 264), (1024, 1024)])
def test_strip16_rule_mirrors_the_kernel(W, B):
    """geometry.sweep16_pairs is strip16_pairs of nw_sweep16.cu, its
    conditions evaluated from the source text (kStrip16Warps =
    SWEEP16_SM_WARPS), and sweep_launch's strip geometry follows."""
    src = (_CSRC / "nw_sweep16.cu").read_text()
    body = src[src.index("static int strip16_pairs(int W, int B) {"):]
    body = body[: body.index("\n}\n")]
    assert int(re.search(r"kStrip16Warps = (\d+);", src).group(1)) \
        == geometry.SWEEP16_SM_WARPS
    env = {"W": W, "B": B, "items_per_sm": -(-B // geometry.SWEEP_SMS),
           "kStrip16Warps": geometry.SWEEP16_SM_WARPS}
    want = None
    for cond, pairs in re.findall(r"if \((.*)\) return (\d+);", body):
        if eval(cond.replace("/", "//"), env):
            want = int(pairs)
            break
    if want is None:
        want = int(re.findall(r"\n  return (\d+);", body)[-1])
    assert geometry.sweep16_pairs(W, B) == want
    warps = -(-W // (64 * want))
    assert geometry.sweep_launch(B, 640, 640, W, dp16=True) == (
        B, 32 * warps, 16 * geometry.SWEEP_RING * warps + 3 * 640)


# ------------------------------------------ the plane-to-move transform (J5)

_TRANSPOSE_MASKS = ((16, 0x0000FFFF), (8, 0x00FF00FF), (4, 0x0F0F0F0F),
                    (2, 0x33333333), (1, 0x55555555))
_ROW_WORDS = 36   # kRowWords: a tile's staged words, padded


def _transpose32_regs(x):
    """In place over the last axis (32 words: row j, bit t = column t):
    the in-register block transpose of myers_moves.cu, word j of a pair
    (j, j + s) keeping its low part and taking the partner's shifted up,
    word j + s the reverse; afterwards word t is column t."""
    for s, mk_ in _TRANSPOSE_MASKS:
        for j in range(32):
            if j & s:
                continue
            a, b = x[..., j].copy(), x[..., j + s].copy()
            x[..., j] = (a & mk_) | ((b << s) & ~mk_ & _M32)
            x[..., j + s] = (b & ~mk_ & _M32) | ((a >> s) & mk_)
    return x


def j5_model(planes, m, *, m_cap, n_cap, w_band, warps=4):
    """numpy model of myers_moves.cu: tile T = (item b, group g, word w) of
    the B * G * nw tiles (T = (b G + g) nw + w) on lane T % 32 of warp
    T // 32; the lane loads the 32 plane words of rows 16g .. 16g + 15 at
    word w (none where the tile holds no valid cell: rows past m, or
    columns all outside 1 .. n_cap), transposes them in registers, turns
    them into codes, masks the cells outside (per column only for a tile
    at an edge), and stages its 32 words in shared memory at row
    lane * _ROW_WORDS (16 bytes at a time); the warp then reads 16 bytes a
    lane (tile 4q + lane // 8, words 4 (lane % 8) ..) and stores them to
    tile * 32 + 4 (lane % 8). Returns (moves, loaded tiles)."""
    B, _, _, nw = planes.shape
    G = m_cap // 16
    W = w_band
    dlo = geometry.band_dlo(m_cap, n_cap, W)
    tiles = B * G * nw
    words = (planes.astype(np.int64) & _M32).reshape(B * G, 32, nw)
    T = np.arange(-(-tiles // (32 * warps)) * 32 * warps)   # whole blocks
    inside = T < tiles
    bg = np.minimum(T, tiles - 1) // nw
    w = np.minimum(T, tiles - 1) % nw
    g, b = bg % G, bg // G
    rows_left = np.where(inside, np.asarray(m, np.int64)[b] - 16 * g, 0)
    J = 16 * g + 1 + dlo + 32 * w
    dead = ~inside | (rows_left <= 0) | (J > n_cap) | (J < -45)
    interior = (rows_left >= 16) & (J >= 1) & (J + 46 <= n_cap)
    x = np.where(dead[:, None], 0, words[bg, :, w])          # (T, 32 rows)
    x = _transpose32_regs(x)
    nd = ~x & 0x55555555
    up = (x >> 1) & 0x55555555
    x = (nd & up) | ((nd & ~up & _M32) << 1)
    j0 = J[:, None] + np.arange(32)                          # (T, 32 cols)
    rlo = np.maximum(0, 1 - j0)
    rhi = np.minimum(15, np.minimum(n_cap - j0, rows_left[:, None] - 1))

    def below(r):
        return np.where(r >= 16, _M32, (1 << (2 * np.clip(r, 0, 15))) - 1)

    valid = np.where(rlo > rhi, 0, below(rhi + 1) & ~below(rlo) & _M32)
    x = np.where(interior[:, None], x, x | (~valid & _M32))
    # shared memory: per warp 32 rows of _ROW_WORDS words
    nwarps = len(T) // 32
    stage = np.zeros((nwarps, 32 * _ROW_WORDS), np.int64)
    lane = np.arange(32)
    for q in range(8):                                       # STS.128
        for e in range(4):
            stage[:, lane * _ROW_WORDS + 4 * q + e] = \
                x[:, 4 * q + e].reshape(nwarps, 32)
    flat = np.zeros(tiles * 32, np.int64)
    for q in range(8):                                       # LDS + STG
        r = 4 * q + lane // 8
        for e in range(4):
            v = stage[:, r * _ROW_WORDS + 4 * (lane % 8) + e]
            tile = np.arange(nwarps)[:, None] * 32 + r
            ok = tile < tiles
            flat[(tile * 32 + 4 * (lane % 8) + e)[ok]] = v[ok]
    out = flat.reshape(B, G, W)
    out = np.where(out >= 2 ** 31, out - 2 ** 32, out).astype(np.int32)
    return out, int((~dead).sum())


@pytest.mark.parametrize("cap,w,B", [(256, 128, 13), (480, 512, 7),
                                     (224, 1024, 5)])
def test_j5_model_matches_plain_and_jax(cap, w, B):
    """The new tiling of J5 on myers_sweep_ref's planes, with m < m_cap
    items (an all-PAD one, one cut by more than half the band), a last
    warp and block that the tiles do not fill (B * G * nw not a multiple
    of 128), W = 512 (16 plane words a row) and W = 1024: byte for byte
    against myers_moves_plain and racon_tpu's myers_moves_from_planes;
    the tiles it skips hold no valid cell, and some are skipped."""
    q8, t8, m, n = _items(cap + w + 5, B, cap, w)
    planes = _ref_planes(q8, t8, cap, w)                     # (cap,2,nw,B)
    rg = sweep_rows_g(cap, w)
    want = np.asarray(myers_moves_from_planes(
        planes.reshape(cap // rg, rg * 2 * (w // 32), B), m, m_cap=cap,
        n_cap=cap, w_band=w)).transpose(2, 0, 1)
    port_planes = np.ascontiguousarray(planes.transpose(3, 0, 1, 2))
    geo = dict(m_cap=cap, n_cap=cap, w_band=w)
    plain = mk.myers_moves_plain(torch.from_numpy(port_planes),
                                 torch.from_numpy(m), **geo).numpy()
    assert np.array_equal(plain, want)
    got, loaded = j5_model(port_planes, m, **geo)
    assert np.array_equal(got, plain)
    assert 0 < loaded < B * (cap // 16) * (w // 32)
    assert (B * (cap // 16) * (w // 32)) % 128


@pytest.mark.parametrize("cap,n_cap,w,B", [(256, 256, 128, 13),
                                           (480, 480, 512, 7),
                                           (224, 224, 1024, 5),
                                           (320, 192, 256, 9)])
def test_moves_live_tiles_counts_the_tiles_with_a_valid_cell(cap, n_cap, w,
                                                             B):
    """geometry.moves_live_tiles (what J5's bound counts) is the number of
    tiles whose moves are not all ones in myers_moves_plain's output, with
    m = 0, m < m_cap (rows past m) and n_cap < m_cap (columns past n_cap),
    and at most the tiles the kernel's model loads."""
    rng = np.random.default_rng(cap + w)
    m = rng.integers(1, cap + 1, B).astype(np.int32)
    m[0], m[-1] = 0, cap
    planes = rng.integers(-2 ** 31, 2 ** 31, (B, cap, 2, w // 32),
                          dtype=np.int64).astype(np.int32)
    geo = dict(m_cap=cap, n_cap=n_cap, w_band=w)
    plain = mk.myers_moves_plain(torch.from_numpy(planes),
                                 torch.from_numpy(m), **geo).numpy()
    live = (plain.reshape(B, cap // 16, w // 32, 32) != -1).any(axis=3)
    n_live = geometry.moves_live_tiles(m, **geo)
    assert n_live == int(live.sum())
    assert 0 < n_live < live.size
    got, loaded = j5_model(planes, m, **geo)
    assert np.array_equal(got, plain)
    assert n_live <= loaded


def test_j5_transpose_in_registers_is_the_shuffle_transpose():
    """The in-register rounds give what common.cuh's transpose32 gives
    with lane j holding row j (the kernel before), on random words: the
    exchange of each round's off-diagonal blocks within a word pair is
    the exchange between lanes j and j ^ s."""
    rng = np.random.default_rng(5)
    x = rng.integers(0, 2 ** 32, (64, 32), dtype=np.int64)
    lane = np.arange(32)
    y = x.copy()
    for s, mk_ in _TRANSPOSE_MASKS:
        z = y[:, lane ^ s]
        hi = (lane & s) != 0
        y = np.where(hi, (y & ~mk_ & _M32) | ((z >> s) & mk_),
                     (y & mk_) | (((z & mk_) << s) & _M32))
    bits = (x[:, :, None] >> np.arange(32)) & 1              # [row, col]
    want = (bits.transpose(0, 2, 1) << np.arange(32)).sum(2)
    assert np.array_equal(y, want)
    assert np.array_equal(_transpose32_regs(x.copy()), want)


def test_j5_source_has_no_64_bit_division():
    """myers_moves.cu's kernel takes its tile indices in 32-bit unsigned
    arithmetic (no long long % or /), and its staging constants are the
    model's."""
    src = (_CSRC / "myers_moves.cu").read_text()
    body = src[src.index("myers_moves_kernel("):]
    body = body[: body.index("\n}\n")]
    assert "long long" not in body
    assert int(re.search(r"kRowWords = (\d+);", src).group(1)) == _ROW_WORDS

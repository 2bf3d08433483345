"""Scored banded-NW sweep of the PyTorch port (its plain version, on the
CPU) against the JAX package: the jnp oracle nw_band_batch_ref and the
Pallas kernel nw_band_batch_t8 in interpret mode. Integer DP, so moves and
scores must be equal exactly (tolerance 0).

The CUDA warp sweep (kernels/csrc/nw_sweep.cu, W <= 256) is modelled in
numpy here, its shared-memory byte layout and bit tricks included, and
held against nw_sweep_plain; the launch geometry (ops/geometry.py) is
checked against the kernel's constants."""

import functools
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from racon_tpu.ops.nw_kernel import (_prep_panels_t8, encode,
                                     nw_band_batch_ref, nw_band_batch_t8,
                                     pack_codes4, pack_delbits)
from racon_tpu_torch.ops import geometry
from racon_tpu_torch.ops import nw_kernel as port
from racon_tpu_torch.ops.batch import to_device

torch.set_num_threads(2)
ACGT = np.frombuffer(b"ACGT", np.uint8)
PAD = 5


def _mutate(rng, t, n_mut):
    q = t.copy()
    for _ in range(n_mut):
        kind = rng.integers(0, 3)
        pos = int(rng.integers(0, max(1, len(q))))
        if kind == 0 and len(q):
            q[pos] = rng.choice(ACGT)
        elif kind == 1 and len(q) > 2:
            q = np.delete(q, pos)
        else:
            q = np.insert(q, pos, rng.choice(ACGT))
    return q


def make_batch(rng, B, cap, gap):
    """Code panels, per-column deletion costs (gap or 0: 30% free columns)
    and lengths. Every 7th item is all PAD; every 9th drifts out of the
    band."""
    q8 = np.full((B, cap), PAD, np.int8)
    t8 = np.full((B, cap), PAD, np.int8)
    dc8 = np.full((B, cap), gap, np.int8)
    m = np.zeros(B, np.int32)
    n = np.zeros(B, np.int32)
    for b in range(B):
        if b % 7 == 6:
            continue
        tlen = int(rng.integers(8, cap))
        t = rng.choice(ACGT, tlen)
        q = _mutate(rng, t, int(rng.integers(0, tlen // 4 + 1)))
        if b % 9 == 4:
            q = q[: max(1, len(q) // 2)]
        q = q[:cap]
        q8[b, : len(q)] = encode(q)
        t8[b, :tlen] = encode(t)
        m[b], n[b] = len(q), tlen
        dc8[b, :tlen][rng.random(tlen) < 0.3] = 0
    return q8, t8, dc8, m, n


def _port_sweep(q8, t8, dc8, m, n, cap, w, scores):
    match, mismatch, gap = scores
    b = to_device(pack_codes4(q8), pack_codes4(t8), pack_delbits(dc8), m, n,
                  m_cap=cap, n_cap=cap, device="cpu")
    moves, score = port.nw_sweep(b.q4, b.t4, b.dcb, m_cap=cap, n_cap=cap,
                                 w_band=w, match=match, mismatch=mismatch,
                                 gap=gap)
    return moves.numpy(), score.numpy()


@pytest.mark.parametrize("cap,w", [(256, 128), (512, 256)])
@pytest.mark.parametrize("scores", [(5, -4, -8), (3, -5, -4), (0, -1, -1)])
def test_sweep_matches_jnp_oracle(cap, w, scores):
    rng = np.random.default_rng(cap + w - scores[2])
    B = 40
    q8, t8, dc8, m, n = make_batch(rng, B, cap, scores[2])
    moves, score = _port_sweep(q8, t8, dc8, m, n, cap, w, scores)
    gc = np.zeros((B, cap + 1), np.int32)
    gc[:, 1:] = np.cumsum(dc8.astype(np.int32), axis=1)
    want_mv, want_sc = nw_band_batch_ref(
        q8.astype(np.int32), t8.astype(np.int32), gc, m_cap=cap, n_cap=cap,
        w_band=w, match=scores[0], mismatch=scores[1], gap=scores[2])
    assert moves.shape == (B, cap // 16, w)
    assert np.array_equal(moves, np.asarray(want_mv)[:B])
    assert np.array_equal(score, np.asarray(want_sc)[:B, 0])


def test_sweep_matches_t8_pallas_interpret():
    """The TPU kernel itself (interpret mode, one 128-lane batch tile):
    its (m_cap/16, W, B) words transposed are the port's moves."""
    rng = np.random.default_rng(101)
    cap, w, B = 128, 64, 128
    q8, t8, dc8, m, n = make_batch(rng, B, cap, -8)
    moves, score = _port_sweep(q8, t8, dc8, m, n, cap, w, (5, -4, -8))
    qT, tpT, dcpT = _prep_panels_t8(
        jnp.asarray(pack_codes4(q8)), jnp.asarray(pack_codes4(t8)),
        jnp.asarray(pack_delbits(dc8)), m_cap=cap, n_cap=cap, w_band=w,
        gap=-8)
    want_mv, want_sc = nw_band_batch_t8(qT, tpT, dcpT, m_cap=cap, n_cap=cap,
                                        w_band=w, match=5, mismatch=-4,
                                        gap=-8, interpret=True)
    assert np.array_equal(moves, np.asarray(want_mv).transpose(2, 0, 1))
    assert np.array_equal(score, np.asarray(want_sc)[0])


def test_sweep_refuses_band_wider_than_kernel():
    """The sweep takes W up to 4096 (four band lanes per thread) in the
    dlo <= 0 regime; W = 8192, or a band that starts right of the
    diagonal (dlo > 0), is refused on every device."""
    q4 = torch.zeros((1, 5120), dtype=torch.uint8)
    dcb = torch.zeros((1, 1280), dtype=torch.uint8)
    with pytest.raises(ValueError, match="unsupported"):
        port.nw_sweep(q4, q4, dcb, m_cap=10240, n_cap=10240, w_band=8192,
                      match=5, mismatch=-4, gap=-8)
    q_short = torch.zeros((1, 64), dtype=torch.uint8)
    t_long = torch.zeros((1, 256), dtype=torch.uint8)
    dcb_long = torch.zeros((1, 64), dtype=torch.uint8)
    with pytest.raises(ValueError, match="unsupported"):
        # dlo = 512 - 128 - 64 > 0
        port.nw_sweep(q_short, t_long, dcb_long, m_cap=128, n_cap=512,
                      w_band=128, match=5, mismatch=-4, gap=-8)


def test_plain_versions_take_cpu_tensors_only():
    """A tensor on another device never reaches a plain version: the
    wrappers raise for devices they do not serve."""
    meta = torch.empty((2, 128), dtype=torch.uint8, device="meta")
    dcb = torch.empty((2, 32), dtype=torch.uint8, device="meta")
    with pytest.raises(ValueError, match="device"):
        port.nw_sweep(meta, meta, dcb, m_cap=256, n_cap=256, w_band=128,
                      match=5, mismatch=-4, gap=-8)
    with pytest.raises(ValueError, match="CPU"):
        port.nw_sweep_plain(meta, meta, dcb, m_cap=256, n_cap=256,
                            w_band=128, match=5, mismatch=-4, gap=-8)


# ----------------------------------------- the warp sweep (W <= 256)

_CSRC = Path(geometry.__file__).parents[1] / "kernels" / "csrc"
_NEG = geometry.NEG


def _byte_perm(x, y, sel):
    """CUDA __byte_perm on uint32 arrays: byte k of the result is byte
    (sel >> 4k) & 7 of the eight bytes y:x."""
    src = [(x >> (8 * k)) & 255 for k in range(4)] + \
          [(y >> (8 * k)) & 255 for k in range(4)]
    return sum(src[(sel >> (4 * k)) & 7] << (8 * k) for k in range(4))


def _unpack8(v):
    lo, hi = v & 0x0F0F0F0F, (v >> 4) & 0x0F0F0F0F
    return _byte_perm(lo, hi, 0x5140), _byte_perm(lo, hi, 0x7362)


def _spread4(x):
    return ((x & 1) | ((x & 2) << 7) | ((x & 4) << 14) | ((x & 8) << 21)) \
        << 4


def _warp_slice(q4, t4, dcb):
    """The codes as each warp unpacks them into shared memory: the query
    codes one a byte, and each target column's code | deletion bit << 4,
    from little-endian 32-bit words of the packed rows."""
    words = lambda a: a.astype(np.uint8).view("<u4").astype(np.int64)
    qw, tw, dw = words(q4), words(t4), words(dcb)
    B = q4.shape[0]
    qs = np.stack(_unpack8(qw), -1)            # (B, m_cap/8, 2) words
    lo, hi = _unpack8(tw)                      # (B, n_cap/8) each
    bits = np.repeat(dw, 4, axis=1) >> (8 * (np.arange(tw.shape[1]) % 4))
    cs = np.stack([lo | _spread4(bits & 15), hi | _spread4((bits >> 4) & 15)],
                  -1)
    as_bytes = lambda w: w.astype("<u4").view(np.uint8).reshape(B, -1)
    return as_bytes(qs), as_bytes(cs)


def _warp_sweep_model(q4, t4, dcb, *, m_cap, n_cap, w_band, match,
                      mismatch, gap):
    """numpy model of nw_sweep_warp_kernel: thread t owns lanes
    LPT*t .. LPT*t + LPT - 1; the column values slide one lane down a row
    (the top lane reads the next column); gc is integrated from bit 4 of
    the column value; the scan is a serial max over each thread's lanes,
    an inclusive max over the 32 thread totals and the exclusive prefix."""
    W = w_band
    lpt = W // 32
    B = q4.shape[0]
    dlo = geometry.band_dlo(m_cap, n_cap, W)
    qs, cs = _warp_slice(q4, t4, dcb)
    cs = cs.astype(np.int64)
    k = np.arange(W)

    def col(j):  # col_at: PAD, no deletion bit, outside the target
        return np.where((j >= 0) & (j < n_cap),
                        cs[:, np.clip(j, 0, n_cap - 1)], geometry.PAD_CODE)

    # row 0: gc_at, gap times the deletion bits of columns 0 .. j - 1
    gcp = np.concatenate([np.zeros((B, 1), np.int64),
                          np.cumsum((cs >> 4) * gap, 1)], 1)
    jz = dlo + k
    gcj = np.where(jz > 0, gcp[:, np.clip(jz, 0, n_cap)], 0)
    hp = np.where((jz >= 0) & (jz <= n_cap), gcj, _NEG)
    c = col(jz)
    moves = np.zeros((B, m_cap // 16, W), np.int64)
    fill = k <= geometry.scan_span(W) - 2
    for i in range(1, m_cap + 1):
        if i > 1:
            c = np.concatenate([c[:, 1:], col(np.full(1, i + dlo + W - 2))],
                               1)
        qc = qs[:, i - 1 : i].astype(np.int64)
        j = i + dlo + k
        gcj = gcj + np.where(c >> 4, gap, 0)
        tc = c & 15
        sub = np.where((tc == geometry.PAD_CODE) != (qc == geometry.PAD_CODE),
                       _NEG, np.where(tc == qc, match, mismatch))
        diag = hp + sub
        up = np.concatenate([hp[:, 1:], np.full((B, 1), _NEG)], 1) + gap
        cand = np.maximum(diag, up)
        cand = np.where(j == 0, i * gap, cand)
        cand = np.where((j < 0) | (j > n_cap), _NEG, cand)
        a = (cand - gcj).reshape(B, 32, lpt)
        a = np.maximum.accumulate(a, axis=2)
        incl = np.maximum.accumulate(a[:, :, -1], axis=1)
        excl = np.concatenate([np.full((B, 1), np.iinfo(np.int64).min),
                               incl[:, :-1]], 1)
        a = np.maximum(a, excl[:, :, None]).reshape(B, W)
        a = np.where(fill, np.maximum(a, geometry.SCAN_FILL), a)
        h = np.where((j < 0) | (j > n_cap), _NEG, a + gcj)
        mv = np.where(h == diag, 0, np.where(h == up, 1, 2))
        mv = np.where((j < 1) | (j > n_cap), 3, mv)
        moves[:, (i - 1) // 16] |= mv << (2 * ((i - 1) % 16))
        hp = h
    moves = np.where(moves >= 2 ** 31, moves - 2 ** 32, moves)
    return moves.astype(np.int32), hp[:, n_cap - m_cap - dlo].astype(np.int32)


@pytest.mark.parametrize("cap,w", [(256, 128), (640, 128), (512, 256),
                                   (256, 64), (192, 96)])
def test_warp_sweep_model_matches_plain(cap, w):
    """The warp kernel's layout and row step, at LPT = 4 (K1's (256,128)
    and (640,128) tiers), 8 (W = 256), 2 and 3 (a thread's lanes that are
    no vector), with all-PAD and out-of-band items (make_batch)."""
    rng = np.random.default_rng(cap + 3 * w)
    q8, t8, dc8, m, n = make_batch(rng, 24, cap, -8)
    q4, t4, dcb = pack_codes4(q8), pack_codes4(t8), pack_delbits(dc8)
    b = to_device(q4, t4, dcb, m, n, m_cap=cap, n_cap=cap, device="cpu")
    geo = dict(m_cap=cap, n_cap=cap, w_band=w, match=5, mismatch=-4, gap=-8)
    want_mv, want_sc = port.nw_sweep_plain(b.q4, b.t4, b.dcb, **geo)
    got_mv, got_sc = _warp_sweep_model(b.q4.numpy(), b.t4.numpy(),
                                       b.dcb.numpy(), **geo)
    assert np.array_equal(got_mv, want_mv.numpy())
    assert np.array_equal(got_sc, want_sc.numpy())


def test_warp_slice_bytes():
    """The shared-memory bytes of one warp: query codes as they are, and
    target code | deletion bit << 4 per column."""
    rng = np.random.default_rng(5)
    q8 = rng.integers(0, 6, (3, 64)).astype(np.int8)
    t8 = rng.integers(0, 6, (3, 128)).astype(np.int8)
    dc8 = np.where(rng.random((3, 128)) < 0.5, -8, 0).astype(np.int8)
    qs, cs = _warp_slice(pack_codes4(q8), pack_codes4(t8),
                         pack_delbits(dc8))
    assert np.array_equal(qs, q8)
    assert np.array_equal(cs, t8 | ((dc8 != 0) << 4))


def test_sweep_geometry_mirrors_the_kernel():
    src = (_CSRC / "nw_sweep.cu").read_text()
    assert int(re.search(r"kSweepWarps = (\d+);", src).group(1)) \
        == geometry.SWEEP_WARPS
    body = src.index("nw_sweep_warp_kernel(")
    assert "__syncthreads" not in src[body : src.index("\n}\n", body)]


@pytest.mark.parametrize("w,kernel", [
    (32, "nw_sweep"), (64, "nw_sweep"), (128, "nw_sweep"), (256, "nw_sweep"),
    (384, "nw_sweep_block"), (1024, "nw_sweep_block"),
    (2048, "nw_sweep_wide"), (4096, "nw_sweep_wide")])
def test_sweep_kernel_by_band_width(w, kernel):
    """W <= 256 (K1's tiers (256,128), (640,128), (1280,256)) always
    takes the warp kernel; wider bands the strip kernel, counted as
    "nw_sweep_block" up to W = 1024 (K2's tiers and the scored align
    route) and "nw_sweep_wide" at W = 2048 and 4096 (K5); the walk there
    is packed2. One item an SM: four band lanes a thread (W = 1024 takes
    8 warps), eight at W = 4096 (16 warps)."""
    assert geometry.sweep_kernel(w) == kernel
    if w > geometry.SWEEP_WARP_MAX_W:
        lanes = 8 if w == 4096 else 4
        assert geometry.sweep_lanes(w, 4) == lanes
        assert geometry.sweep_warps(w, 4) == -(-w // (32 * lanes))
    assert (port.walk_fmt(w) == "packed2") == (kernel == "nw_sweep_wide")


@pytest.mark.parametrize("cap,w,smem", [(256, 128, 2048), (640, 128, 5120),
                                        (1280, 256, 10240)])
def test_warp_sweep_threads_and_shared_bytes(cap, w, smem):
    """Four warps (items) a block; each warp holds m_cap + n_cap code
    bytes: about 1.3 KB per item at (640, 128)."""
    _, threads, per_block = geometry.sweep_launch(1, cap, cap, w)
    assert threads == 32 * geometry.SWEEP_WARPS == 128
    assert per_block == smem == geometry.SWEEP_WARPS * 2 * cap


@pytest.mark.parametrize("B,blocks", [(1, 1), (31, 8), (4097, 1025),
                                      (8192, 2048)])
def test_warp_sweep_blocks_for_ragged_batches(B, blocks):
    """A ragged batch rounds up to whole blocks; the strip kernel keeps
    one block per item, with two 8-byte rings of SWEEP_RING slots a warp
    beside the query codes (a byte each) and the target columns (4 bytes
    each): at W = 1024 8 warps (four lanes a thread) up to 396 items, 4
    above, where four or more items share an SM; at W = 4096 16."""
    assert geometry.sweep_launch(B, 640, 640, 128)[0] == blocks
    warps = 8 if B <= 3 * geometry.SWEEP_SMS else 4
    assert geometry.sweep_launch(B, 5120, 5120, 1024) == (
        B, 32 * warps, warps * 2 * 8 * geometry.SWEEP_RING + 5 * 5120)
    assert geometry.sweep_launch(B, 40960, 40960, 4096) == (
        B, 512, 16 * 2 * 8 * geometry.SWEEP_RING + 5 * 40960)


# ------------------------------ the strip sweep (W = 288 .. 4096: K2, K5)
#
# kernels/csrc/nw_sweep.cu's nw_sweep_strip_kernel: one block per item,
# warp w owns a strip of S = 32 LPT band lanes, and the warps hand each
# other two integers a row through rings of SWEEP_RING slots in shared
# memory. The model below runs each warp as a generator that stops at
# each of the kernel's waits; a seeded scheduler resumes, at random, any
# warp whose slot holds the row it waits for, so the warps interleave in
# any order the waits allow. A slot is (row, value); a reader takes it once
# its row is the one wanted or later, as await_row does.

_INT_MIN = np.iinfo(np.int64).min


class _Ring:
    """One warp's hand-off ring: `depth` slots of (row, value per item)."""

    def __init__(self, depth, B):
        self.depth = depth
        self.row = [0] * depth
        self.val = [np.zeros(B, np.int64) for _ in range(depth)]
        self.overruns = 0  # reads that found a later row than wanted

    def ready(self, row):
        return self.row[row % self.depth] >= row

    def take(self, row):
        s = row % self.depth
        self.overruns += self.row[s] > row
        return self.val[s].copy()

    def put(self, row, v):
        s = row % self.depth
        self.row[s], self.val[s] = row, v.copy()


def _strip_warp(w, nw, cs, qs, gcp, rings, out, *, m_cap, n_cap, w_band,
                lpt, match, mismatch, gap):
    """Warp w of nw_sweep_strip_kernel on every item at once (arrays
    (B, 32 threads, LPT lanes)), as the kernel computes it: H less gc
    (hg), the column values code | deletion cost << 8, gc carried for each
    thread's first lane and summed over its lanes in edge rows, and inside
    the matrix each move from the scan value and which of diag and up won.
    Yields (ring, row) before each wait and writes its moves and score
    into `out`."""
    W, S = w_band, 32 * lpt
    B = cs.shape[0]
    dlo = geometry.band_dlo(m_cap, n_cap, W)
    k = w * S + np.arange(S).reshape(32, lpt)
    k0 = k[:, 0]
    band_end = k0 + lpt == W
    live = k0 < W
    fill_last = np.where(k0 + lpt - 1 <= geometry.scan_span(W) - 2,
                         geometry.SCAN_FILL, _INT_MIN)
    carry_out, first_out = rings[w]
    has_left, has_right = w > 0, w + 1 < nw

    def col(j):  # col32_at: PAD, no deletion cost, outside the target
        return np.where((j >= 0) & (j < n_cap),
                        cs[:, np.clip(j, 0, n_cap - 1)], geometry.PAD_CODE)

    def gc_at(j):
        return gcp[:, np.clip(j, 0, n_cap)]

    def inside(j):
        return (j >= 0) & (j <= n_cap)

    def valid(j):
        return (j >= 1) & (j <= n_cap)

    def gc_lanes():  # gc at the thread's lanes of the current row
        return gc0[:, :, None] + np.concatenate(
            [np.zeros((B, 32, 1), np.int64), np.cumsum(c[:, :, 1:] >> 8, 2)],
            2)

    jz = dlo + k
    gc0 = gc_at(jz[:, 0])
    hp = np.where(inside(jz), 0, _NEG - gc_at(jz))
    c = col(jz)
    pack = np.zeros((B, 32, lpt), np.int64)
    first_out.put(0, hp[:, 0, 0])
    a_last = d_last = r_last = edge_last = None

    def finish_last(r, right, edge):
        up = right + gap
        h = np.maximum(a_last, up)
        if edge:
            j = r + dlo + k0 + lpt - 1
            h = np.where(valid(j), h, a_last)
            h = np.where(inside(j), h, _NEG - gc_lanes()[:, :, -1])
        mv = np.where(h == d_last, 0, np.where(h == up, 1, 2))
        if edge:
            mv = np.where(valid(j), mv, 3)
        p = (r - 1) % 16
        pack[:, :, -1] |= mv << (2 * p)
        hp[:, :, -1] = h
        if p == 15:
            out["moves"][:, (r - 1) // 16, k[live].ravel()] = \
                pack[:, live].reshape(B, -1)
            pack[:] = 0

    def right_of(r):
        hr = _NEG
        if has_right:
            ring = rings[w + 1][1]
            yield ring, r
            hr = ring.take(r)[:, None]
        lane31 = (np.arange(32) == 31)[None, :]
        return np.where(band_end, _NEG, np.where(lane31, hr, r_last))

    for i in range(1, m_cap + 1):
        if i > 1:
            finish_last(i - 1, (yield from right_of(i - 2)), edge_last)
        jw = i + dlo + w * S
        edge = not (jw >= 1 and jw + S - 1 <= n_cap)
        qc = qs[:, i - 1, None, None].astype(np.int64)
        if i > 1:  # lanes slide, each thread's last reads its new column
            c = np.concatenate([c[:, :, 1:], col(i + dlo + k0 + lpt - 2)
                                [:, :, None]], 2)
        gc0 = gc0 + (c[:, :, 0] >> 8)
        above_last = np.concatenate([hp[:, 1:, 0], hp[:, 31:, 0]], 1)
        j = i + dlo + k
        tc = c & 15
        sub = np.where((tc == geometry.PAD_CODE) != (qc == geometry.PAD_CODE),
                       _NEG, np.where(tc == qc, match, mismatch))
        diag = hp + sub - (c >> 8)
        up = hp[:, :, 1:] + gap
        up_won = diag[:, :, :-1] < up
        cand = diag.copy()
        cand[:, :, :-1] = np.maximum(diag[:, :, :-1], up)
        if edge:
            g = gc_lanes()
            cand = np.where(j == 0, i * gap, cand)
            cand = np.where(inside(j), cand, _NEG - g)
        own = cand
        a = np.maximum.accumulate(cand.reshape(B, S), 1).reshape(B, 32, lpt)
        carry = np.full((B, 1, 1), _INT_MIN)
        if has_left:
            ring = rings[w - 1][0]
            yield ring, i
            carry = ring.take(i)[:, None, None]
        if has_right:
            carry_out.put(i, np.maximum(carry[:, 0, 0], a[:, 31, -1]))
        h = np.maximum(np.maximum(a, carry), geometry.SCAN_FILL)[:, :, :-1]
        if edge:
            h = np.where(inside(j[:, :-1]), h, _NEG - g[:, :, :-1])
            mv = np.where(h == diag[:, :, :-1], 0, np.where(h == up, 1, 2))
            mv = np.where(valid(j[:, :-1]), mv, 3)
        else:
            mv = np.where(h != own[:, :, :-1], 2, up_won)
        pack[:, :, :-1] |= mv << (2 * ((i - 1) % 16))
        hp[:, :, :-1] = h
        a_last = np.maximum(np.maximum(a[:, :, -1], carry[:, :, 0]),
                            fill_last)
        d_last, r_last, edge_last = diag[:, :, -1], above_last, edge
        if has_left:
            first_out.put(i, hp[:, 0, 0])
    finish_last(m_cap, (yield from right_of(m_cap - 1)), True)
    end = n_cap - m_cap - dlo
    if w * S <= end < (w + 1) * S:
        out["score"] = hp.reshape(B, S)[:, end - w * S] + gcp[:, n_cap]


def _strip_sweep_model(q4, t4, dcb, *, m_cap, n_cap, w_band, match,
                       mismatch, gap, ring, seed, launch_items=None):
    """numpy model of nw_sweep_strip_kernel at the LPT geometry.sweep_lanes
    gives a launch of `launch_items` items (default: these) and a ring of
    `ring` rows, its warps interleaved by a scheduler seeded with `seed`.
    Returns (moves, score, overruns): overruns counts the reads that found
    a slot already holding a later row."""
    W = w_band
    B = q4.shape[0]
    lpt = geometry.sweep_lanes(W, launch_items or B)
    nw = geometry.sweep_warps(W, launch_items or B)
    qs, cs = _warp_slice(q4, t4, dcb)
    cs = cs.astype(np.int64)
    dc = (cs >> 4) * gap
    gcp = np.concatenate([np.zeros((B, 1), np.int64), np.cumsum(dc, 1)], 1)
    cs = (cs & 15) | (dc << 8)  # the strip kernel's column values
    rings = [(_Ring(ring, B), _Ring(ring, B)) for _ in range(nw)]
    out = {"moves": np.zeros((B, m_cap // 16, W), np.int64)}
    geo = dict(m_cap=m_cap, n_cap=n_cap, w_band=W, lpt=lpt, match=match,
               mismatch=mismatch, gap=gap)
    warps = [_strip_warp(w, nw, cs, qs, gcp, rings, out, **geo)
             for w in range(nw)]
    waiting = {w: next(g) for w, g in enumerate(warps)}
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


def _strip_case(cap, w, scores, seed, B=12):
    """make_batch's items (all-PAD and out-of-band ones among them),
    packed as the device gets them; the align scores with every column's
    deletion bit set, as the align stage sends them."""
    match, mismatch, gap = scores
    rng = np.random.default_rng(seed)
    q8, t8, dc8, m, n = make_batch(rng, B, cap, gap)
    if scores == (0, -1, -1):
        dc8[:] = gap
    b = to_device(pack_codes4(q8), pack_codes4(t8), pack_delbits(dc8), m, n,
                  m_cap=cap, n_cap=cap, device="cpu")
    geo = dict(m_cap=cap, n_cap=cap, w_band=w, match=match,
               mismatch=mismatch, gap=gap)
    return b, geo


_STRIP_CASES = [(cap, w, scores, None)
                for cap, w in ((256, 288), (512, 384), (512, 512),
                               (512, 1024), (256, 2048), (256, 4096))
                for scores in ((5, -4, -8), (0, -1, -1))] + [
    (cap, w, (5, -4, -8), 1024)
    for cap, w in ((512, 512), (512, 1024), (256, 2048))]


@pytest.mark.parametrize("cap,w,scores,launch_items", _STRIP_CASES)
def test_strip_sweep_model_matches_plain(cap, w, scores, launch_items):
    """The strip kernel's schedule (strips, the per-row hand-off pair, the
    ring at geometry.SWEEP_RING) under two seeded interleavings of its
    warps, byte for byte against nw_sweep_plain; no read ever finds its
    slot already reused. W = 288 cuts the last strip short. With the
    launch of 12 items the rule takes four lanes a thread (eight at W =
    4096); as part of a launch of 1024 items, eight at W = 512 to 2048."""
    b, geo = _strip_case(cap, w, scores, cap + w)
    want_mv, want_sc = port.nw_sweep_plain(b.q4, b.t4, b.dcb, **geo)
    for seed in (1, 2):
        got_mv, got_sc, overruns = _strip_sweep_model(
            b.q4.numpy(), b.t4.numpy(), b.dcb.numpy(), **geo,
            ring=geometry.SWEEP_RING, seed=seed, launch_items=launch_items)
        assert overruns == 0
        assert np.array_equal(got_mv, want_mv.numpy())
        assert np.array_equal(got_sc, want_sc.numpy())


def test_strip_ring_one_row_too_shallow_differs():
    """With one row less of ring a warp overwrites a slot its neighbour
    has not read yet: the same schedule gives other bytes."""
    b, geo = _strip_case(512, 1024, (5, -4, -8), 3)
    want_mv, _ = port.nw_sweep_plain(b.q4, b.t4, b.dcb, **geo)
    got_mv, _, overruns = _strip_sweep_model(
        b.q4.numpy(), b.t4.numpy(), b.dcb.numpy(), **geo,
        ring=geometry.SWEEP_RING - 1, seed=1)
    assert overruns > 0
    assert not np.array_equal(got_mv, want_mv.numpy())


def test_strip_row_loop_has_no_block_barrier():
    """The strip kernel has one __syncthreads, after the codes are staged;
    its row step, its row loop (to the kernel's end) and the hand-off
    helpers it takes from common.cuh hold none; the ring depth is
    geometry's."""
    src = (_CSRC / "nw_sweep.cu").read_text()
    start = src.index("nw_sweep_strip_kernel(")
    body = src[start : src.index("\n}\n", start)]
    barrier = body.index("__syncthreads")
    assert "__syncthreads" not in body[barrier + 1 :]
    assert barrier < body.index("auto row = [&]") \
        < body.index("for (int i = 1; i <= m_cap; ++i)")
    common = (_CSRC / "common.cuh").read_text()
    helpers = common[common.index("void publish(") :]
    assert "await_row" in helpers and "__syncthreads" not in helpers
    assert "void publish(" not in src and "await_row(" in src
    assert int(re.search(r"kSweepRing = (\d+);", common).group(1)) \
        == geometry.SWEEP_RING


# ------------------------------------- the int16 sweeps (RACON_TPU_DP16=1)
#
# kernels/csrc/nw_sweep16.cu keeps two band lanes in one 32-bit word (an
# s16x2 pair). The model below runs that layout in numpy, instruction for
# instruction: the prmt selectors (sign replication included), the 16x2
# adds, minima and maxima, the substitution from one-hot codes, the
# warp-uniform edge branch, the scan over the thread's halves and the
# thread totals, and the moves gathered 8 rows to a pair word. The strip
# kernel (W > 256) is modelled in tests/test_torch_sweep16_strip.py.

_M16 = 0xFFFF


def _u32(x):
    return np.asarray(x, np.int64) & 0xFFFFFFFF


def _prmt(a, b, sel):
    """PTX prmt.b32 (generic mode) on uint32 arrays: byte n of the result
    is byte (nibble n & 7) of b:a, or that byte's sign replicated where
    nibble n has bit 3 set."""
    a, b = _u32(a), _u32(b)
    out = np.zeros(np.broadcast(a, b).shape, np.int64)
    for n in range(4):
        nib = (sel >> (4 * n)) & 15
        src = a if (nib & 7) < 4 else b
        byte = (src >> (8 * (nib & 3))) & 255
        if nib & 8:
            byte = np.where(byte & 0x80, 255, 0)
        out |= byte << (8 * n)
    return out


def _halves(x):
    x = _u32(x)
    return x & _M16, x >> 16


def _pair(lo, hi):
    return (np.asarray(lo, np.int64) & _M16) | ((np.asarray(hi, np.int64)
                                                  & _M16) << 16)


def _s16(h):
    return ((h & _M16) ^ 0x8000) - 0x8000


def _lanewise(fn, *xs):
    """fn applied to the low halves and to the high halves of pair words."""
    lo = fn(*(_halves(x)[0] for x in xs))
    hi = fn(*(_halves(x)[1] for x in xs))
    return _pair(lo, hi)


def _vadd2(a, b):
    return _lanewise(lambda x, y: x + y, a, b)


def _vmaxs2(*xs):
    return _lanewise(lambda *h: functools.reduce(np.maximum, map(_s16, h)),
                     *xs)


def _vminu2(*xs):
    return _lanewise(lambda *h: functools.reduce(np.minimum, h), *xs)


def _dup16(v):
    return _pair(v, v)


_ONEHOT = (0x08040201, 0x8040A010)   # one-hot bytes of codes 0-3, 4-7
_SHIFT = (0x04050607, 0x00010203)    # 7 - code
_PAD_SHIFT = 2


def _prmt_table(a, b, sel):
    """prmt.b32 with a scalar table b:a and an array selector whose
    nibbles are below 8 (codes): byte n of the result is table byte
    (nibble n of sel)."""
    table = [(a >> (8 * x)) & 255 for x in range(4)] + \
            [(b >> (8 * x)) & 255 for x in range(4)]
    table = np.array(table, np.int64)
    sel = _u32(sel)
    out = np.zeros(sel.shape, np.int64)
    for n in range(4):
        nib = (sel >> (4 * n)) & 15
        assert (nib < 8).all()
        out |= table[nib] << (8 * n)
    return out


def _slice16_onehot(q4, t4, dcb):
    """What load_item16_onehot writes to each item's shared memory: per
    query row the shift byte 7 - code, by prmt of the shift table with the
    packed nibble word as its selector; per target column the half
    one-hot code | deletion bit << 15 (PAD: 0xA0)."""
    words = lambda a: a.astype(np.uint8).view("<u4").astype(np.int64)
    qw, tw, dw = words(q4), words(t4), words(dcb)
    B = q4.shape[0]
    qs = np.stack([_prmt_table(*_SHIFT, qw), _prmt_table(*_SHIFT, qw >> 16)],
                  -1)
    qs = _u32(qs).astype("<u4").view(np.uint8).reshape(B, -1).astype(
        np.int64)
    del2 = lambda d: ((d & 1) << 15) | ((d & 2) << 30)
    lo, hi = _prmt_table(*_ONEHOT, tw), _prmt_table(*_ONEHOT, tw >> 16)
    bits = np.repeat(dw, 4, axis=1) >> (8 * (np.arange(tw.shape[1]) % 4))
    cs = np.stack([_prmt(lo, 0, 0x4140) | del2(bits),
                   _prmt(lo, 0, 0x4342) | del2(bits >> 2),
                   _prmt(hi, 0, 0x4140) | del2(bits >> 4),
                   _prmt(hi, 0, 0x4342) | del2(bits >> 6)], -1)
    cs = _u32(cs).reshape(B, -1)
    return qs, np.stack(_halves(cs), -1).reshape(B, -1)


def _viaddmax2(a, b, c):
    return _lanewise(lambda x, y, z: np.maximum(_s16(x + y), _s16(z)),
                     a, b, c)


def _sweep16_warp_model(q4, t4, dcb, *, m_cap, n_cap, w_band, match,
                        mismatch, gap, tpi, pairs, broken=None):
    """numpy model of nw_sweep16_warp_kernel: tpi threads per item, `pairs`
    s16x2 words per thread, lanes from W to 2 pairs tpi pad lanes; H kept
    less gc (hg), NEG-free codes: equal codes from the column's one-hot
    bit shifted to bit 7 by the query row's shift, PAD from bit 7, the
    deletion cost from bit 15; own = max(above + gap, diag); the scan over
    the thread's halves and the thread totals; the fill on the thread's
    last pair by lane, on the others uniform; the move [h != diag] +
    [h != own]; the score hg + gc[n_cap] in int16. `broken` drops a
    piece, for the mutation cases: "del" the column's deletion cost,
    "pad" the PAD test (a PAD column against a base a mismatch)."""
    import torch

    W, T, P = w_band, tpi, pairs
    L, WP = 2 * P, 2 * P * tpi
    B = q4.shape[0]
    dt, neg, fill_v = geometry.dp_consts(m_cap, n_cap, match, mismatch, gap)
    assert dt == torch.int16
    dlo = geometry.band_dlo(m_cap, n_cap, W)
    qs, cs = _slice16_onehot(q4, t4, dcb)
    span = geometry.scan_span(W)
    k = np.arange(WP)
    k0 = L * np.arange(T)[None, :]               # (1, T)
    pad_thread = k0 + L > W

    def col_at(j):
        return np.where((j >= 0) & (j < n_cap),
                        cs[:, np.clip(j, 0, n_cap - 1)], 0xA0)

    def pairs_of(lanes):                          # (B, WP) -> (B, T, P)
        return _pair(lanes[..., 0::2], lanes[..., 1::2]).reshape(B, T, P)

    jz = dlo + k
    hp = pairs_of(np.broadcast_to(
        np.where((k < W) & (jz >= 0) & (jz <= n_cap), 0, neg), (B, WP)))
    col = pairs_of(col_at(jz - 1))
    fill_lanes = np.where(k <= span - 2, fill_v, -32768)
    fill = np.broadcast_to(_dup16(fill_v), (B, T, P)).copy()
    fill[:, :, -1] = pairs_of(np.broadcast_to(fill_lanes, (B, WP)))[:, :, -1]
    acc = np.zeros((B, T, P), np.int64)
    lo8 = np.zeros_like(acc)
    match2, mis2, gap2, neg2 = (_dup16(x) for x in (match, mismatch, gap,
                                                    neg))
    ngap2 = _dup16(-gap)
    moves = np.zeros((B, m_cap // 16, WP), np.int64)
    for i in range(1, m_cap + 1):
        sh = qs[:, i - 1][:, None, None]
        other2 = np.where(sh == _PAD_SHIFT, neg2, mis2)
        jb = i + dlo + k0                          # (1, T)
        edge = (pad_thread | (jb < 1) | (jb + L - 1 > n_cap))[:, :, None]
        mine = _prmt(col[:, :, 0], hp[:, :, 0], 0x5410)
        nb = np.concatenate([mine[:, 1:], mine[:, -1:]], 1)  # shfl_down 1
        top = np.arange(T) == T - 1
        col_in = np.where(top, col_at(np.full(1, i + dlo + WP - 2))[:, :1],
                          nb)
        above = np.empty_like(hp)
        above[:, :, :-1] = _prmt(hp[:, :, :-1], hp[:, :, 1:], 0x5432)
        above[:, :, -1] = _prmt(hp[:, :, -1], np.where(top, neg2, nb),
                                0x7632)
        col = np.concatenate([_prmt(col[:, :, :-1], col[:, :, 1:], 0x5432),
                              _prmt(col[:, :, -1:], col_in[:, :, None],
                                    0x5432)], 2)
        eq = _prmt(_u32(col << sh), 0, 0xAA88)
        pad = _prmt(col, 0, 0xAA88)
        if broken == "pad":
            pad = np.zeros_like(pad)
        sub = (eq & match2) | (~eq & ((pad & neg2) | (~pad & other2)))
        dele = _prmt(col, 0, 0xBB99) & ngap2
        if broken == "del":
            dele = np.zeros_like(dele)
        diag = _vadd2(hp, _vadd2(_u32(sub), dele))
        own = _viaddmax2(above, gap2, diag)
        a = own.copy()
        j = (jb[:, :, None] + np.arange(L)).reshape(1, T, P, 2)
        padl = (k0[:, :, None] + np.arange(L)).reshape(1, T, P, 2) >= W
        half = lambda m: _pair(np.where(m[..., 0], _M16, 0),
                               np.where(m[..., 1], _M16, 0))
        out = np.where(edge, half(padl | (j < 0) | (j > n_cap)), 0)
        zero = np.where(edge, half(~padl & (j == 0)), 0)
        inv = np.where(edge, half(padl | (j < 1) | (j > n_cap)), 0)
        a = (a & ~zero) | (_dup16(i * gap) & zero)
        a = (a & ~out) | (neg2 & out)
        a[:, :, 0] = _vmaxs2(a[:, :, 0], _prmt(a[:, :, 0], 0, 0x1010))
        for v in range(1, P):
            a[:, :, v] = _vmaxs2(a[:, :, v], _prmt(a[:, :, v], 0, 0x1010),
                                 _prmt(a[:, :, v - 1], 0, 0x3232))
        tot = np.maximum.accumulate(_s16(a[:, :, -1] >> 16), axis=1)
        pre = np.concatenate([np.full((B, 1), 0x80008000),
                              _dup16(tot[:, :-1])], 1)
        h = _vmaxs2(a, pre[:, :, None], fill)
        h = (h & ~out) | (neg2 & out)
        mv = _vminu2(h ^ diag, 0x00010001) + _vminu2(h ^ own, 0x00010001)
        mv |= inv & 0x00030003
        p = (i - 1) % 16
        acc = _u32(acc + mv * (1 << (2 * (p % 8))))
        hp = h
        if p == 7:
            lo8, acc = acc, np.zeros_like(acc)
        elif p == 15:
            w = np.stack([_prmt(lo8, acc, 0x5410), _prmt(lo8, acc, 0x7632)],
                         -1)
            moves[:, (i - 1) // 16] = w.reshape(B, WP)
            acc = np.zeros_like(acc)
    lanes = np.stack(_halves(hp), -1).reshape(B, WP)
    gc_end = gap * ((cs >> 15) & 1).sum(1)
    moves = moves[:, :, :W]
    moves = np.where(moves >= 2 ** 31, moves - 2 ** 32, moves)
    score = _s16(lanes[:, n_cap - m_cap - dlo] + gc_end)
    return moves.astype(np.int32), score.astype(np.int32)


@pytest.mark.parametrize("cap,w,tpi,pairs,scores", [
    (256, 128, 8, 8, (5, -4, -8)),     # K1's (256,128), four items a warp
    (640, 128, 8, 8, (5, -4, -8)),     # K1's (640,128)
    (384, 192, 32, 3, (5, -4, -8)),    # one warp an item, three pairs
    (512, 256, 32, 4, (3, -5, -4)),    # W = 256 (eligible at cmax 5)
    (256, 96, 32, 2, (5, -4, -8)),     # pad lanes: whole threads
    (320, 160, 32, 3, (5, -4, -8)),    # pad lanes inside a thread
    (256, 32, 32, 1, (5, -4, -8)),
    (1024, 512, 128, 2, (0, -1, -1)),  # the strip kernel at K2's W = 512
    (768, 288, 96, 2, (5, -4, -8)),    # the strip kernel, its last strip cut
])
def test_sweep16_model_matches_plain(monkeypatch, cap, w, tpi, pairs,
                                     scores):
    """The int16 kernels' packed layout against nw_sweep_plain under
    RACON_TPU_DP16=1 (int16 H), at the warp kernel's shapes (8 threads
    an item at W = 128, 32 elsewhere: _sweep16_warp_model, H less gc and
    one-hot codes) and the strip kernel's (tpi = 32 threads a strip,
    `pairs` a thread, as geometry gives a launch of these 12 items:
    test_torch_sweep16_strip.strip16_model, its warps interleaved by a
    seeded scheduler), with make_batch's all-PAD and out-of-band items and
    30% free deletion columns."""
    monkeypatch.setenv("RACON_TPU_DP16", "1")
    assert geometry.sweep_dp16(cap, cap, w, *scores)
    if w <= 256:
        assert (tpi, pairs) == (geometry.sweep16_threads(w),
                                -(-w // (2 * tpi)))
    else:
        assert (tpi, pairs) == (geometry.sweep16_threads(w, 12),
                                geometry.sweep16_pairs(w, 12))
    rng = np.random.default_rng(cap + 7 * w + tpi)
    q8, t8, dc8, m, n = make_batch(rng, 12, cap, scores[2])
    q4, t4, dcb = pack_codes4(q8), pack_codes4(t8), pack_delbits(dc8)
    b = to_device(q4, t4, dcb, m, n, m_cap=cap, n_cap=cap, device="cpu")
    geo = dict(m_cap=cap, n_cap=cap, w_band=w, match=scores[0],
               mismatch=scores[1], gap=scores[2])
    want_mv, want_sc = port.nw_sweep_plain(b.q4, b.t4, b.dcb, **geo)
    if w <= 256:
        got_mv, got_sc = _sweep16_warp_model(
            b.q4.numpy(), b.t4.numpy(), b.dcb.numpy(), **geo, tpi=tpi,
            pairs=pairs)
    else:
        from test_torch_sweep16_strip import strip16_model

        got_mv, got_sc, _ = strip16_model(b.q4.numpy(), b.t4.numpy(),
                                          b.dcb.numpy(), **geo, seed=cap)
    assert np.array_equal(got_mv, want_mv.numpy())
    assert np.array_equal(got_sc, want_sc.numpy())


@pytest.mark.parametrize("cap,w,B", [(640, 128, 13), (256, 128, 4097),
                                     (320, 160, 6), (256, 96, 5)])
def test_sweep16_warp_model_half_empty_and_edges(monkeypatch, cap, w, B):
    """The int16 warp model at both W = 128 tiers with a part-empty last
    warp (B = 13 and the stage's 4097: four items a warp, the last warp's
    dummy slots running the last item again, as the kernel's do, and
    compared nowhere), and with pad lanes (W = 160: a pad pair in the top
    threads; W = 96: whole pad threads); every item's moves and score
    against nw_sweep_plain under RACON_TPU_DP16=1, with all-PAD,
    out-of-band and free-deletion items."""
    monkeypatch.setenv("RACON_TPU_DP16", "1")
    tpi = geometry.sweep16_threads(w)
    pairs = -(-w // (2 * tpi))
    rng = np.random.default_rng(B + cap)
    q8, t8, dc8, m, n = make_batch(rng, B, cap, -8)
    ipw = 32 // tpi
    take = np.minimum(np.arange(-(-B // ipw) * ipw), B - 1)
    q4, t4, dcb = pack_codes4(q8), pack_codes4(t8), pack_delbits(dc8)
    b = to_device(q4, t4, dcb, m, n, m_cap=cap, n_cap=cap, device="cpu")
    geo = dict(m_cap=cap, n_cap=cap, w_band=w, match=5, mismatch=-4, gap=-8)
    want_mv, want_sc = port.nw_sweep_plain(b.q4, b.t4, b.dcb, **geo)
    got_mv, got_sc = _sweep16_warp_model(q4[take], t4[take], dcb[take],
                                         **geo, tpi=tpi, pairs=pairs)
    assert len(take) > B or B % ipw == 0
    assert np.array_equal(got_mv[:B], want_mv.numpy())
    assert np.array_equal(got_sc[:B], want_sc.numpy())


@pytest.mark.parametrize("broken", ["del", "pad"])
def test_sweep16_warp_model_broken_differs(monkeypatch, broken):
    """The int16 warp model without the column's deletion cost in diag, or
    without the PAD test, no longer matches nw_sweep_plain: the model
    tests see those pieces."""
    monkeypatch.setenv("RACON_TPU_DP16", "1")
    rng = np.random.default_rng(21)
    q8, t8, dc8, m, n = make_batch(rng, 12, 256, -8)
    b = to_device(pack_codes4(q8), pack_codes4(t8), pack_delbits(dc8), m, n,
                  m_cap=256, n_cap=256, device="cpu")
    geo = dict(m_cap=256, n_cap=256, w_band=128, match=5, mismatch=-4,
               gap=-8)
    want_mv, _ = port.nw_sweep_plain(b.q4, b.t4, b.dcb, **geo)
    got_mv, _ = _sweep16_warp_model(b.q4.numpy(), b.t4.numpy(),
                                    b.dcb.numpy(), **geo, tpi=8, pairs=8,
                                    broken=broken)
    assert not np.array_equal(got_mv, want_mv.numpy())


def test_slice16_onehot_bytes():
    """Shared memory of one int16 warp-kernel item: per query row the
    shift 7 - code, and per column the one-hot half (A..N bits 0-4, PAD
    0xA0) | deletion bit << 15; the kernel's tables and PAD shift are
    these."""
    rng = np.random.default_rng(8)
    q8 = rng.integers(0, 6, (3, 64)).astype(np.int8)
    t8 = rng.integers(0, 6, (3, 128)).astype(np.int8)
    dc8 = np.where(rng.random((3, 128)) < 0.5, -8, 0).astype(np.int8)
    qs, cs = _slice16_onehot(pack_codes4(q8), pack_codes4(t8),
                             pack_delbits(dc8))
    q8, t8 = q8.astype(np.int64), t8.astype(np.int64)
    assert np.array_equal(qs, 7 - q8)
    onehot = np.where(t8 == PAD, 0xA0, 1 << t8)
    assert np.array_equal(cs, onehot | ((dc8 != 0) << 15))
    src = (_CSRC / "nw_sweep16.cu").read_text()
    for name, value in (("kOneHotLo", _ONEHOT[0]), ("kOneHotHi", _ONEHOT[1]),
                        ("kShiftLo", _SHIFT[0]), ("kShiftHi", _SHIFT[1])):
        assert f"{name} = 0x{value:08X}u;" in src
    assert f"kPadShift = {_PAD_SHIFT};" in src
    assert "case 128: RTT_WARP16(8, 8, 128)" in src


def test_slice16_bytes():
    """Shared memory of one int16 item as the strip kernel (K2-16) stages
    it, one block an item whose threads stride over rows of the strip
    tiers' length (n_cap 2560, m_cap 1280): per query row the shift
    7 - code, per column the one-hot half | deletion bit << 15, PAD 0xA0;
    both int16 kernels stage through load_item16_onehot, and the block
    kernel's layout (code bytes, PAD 0x80: load_item16) is gone."""
    rng = np.random.default_rng(6)
    q8 = rng.integers(0, 6, (2, 1280)).astype(np.int8)
    t8 = rng.integers(0, 6, (2, 2560)).astype(np.int8)
    dc8 = np.where(rng.random((2, 2560)) < 0.5, -8, 0).astype(np.int8)
    qs, cs = _slice16_onehot(pack_codes4(q8), pack_codes4(t8),
                             pack_delbits(dc8))
    q8, t8 = q8.astype(np.int64), t8.astype(np.int64)
    assert np.array_equal(qs, 7 - q8)
    assert np.array_equal(cs, np.where(t8 == PAD, 0xA0, 1 << t8)
                          | ((dc8 != 0) << 15))
    src = (_CSRC / "nw_sweep16.cu").read_text()
    strip = src[src.index("nw_sweep16_strip_kernel("):]
    assert "load_item16_onehot(" in strip[: strip.index("\n}\n")]
    assert "load_item16(" not in src

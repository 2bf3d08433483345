"""Scored banded-NW sweep of the PyTorch port (its plain version, on the
CPU) against the JAX package: the jnp oracle nw_band_batch_ref and the
Pallas kernel nw_band_batch_t8 in interpret mode. Integer DP, so moves and
scores must be equal exactly (tolerance 0).

The CUDA warp sweep (kernels/csrc/nw_sweep.cu, W <= 256) is modelled in
numpy here, its shared-memory byte layout and bit tricks included, and
held against nw_sweep_plain; the launch geometry (ops/geometry.py) is
checked against the kernel's constants."""

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
    takes the warp kernel; K2's tiers and the scored align route up to
    W = 1024 the block kernel; W = 2048 and 4096 the wide instantiations."""
    assert geometry.sweep_kernel(w) == kernel


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
    """A ragged batch rounds up to whole blocks; the block kernel keeps
    one block per item."""
    assert geometry.sweep_launch(B, 640, 640, 128)[0] == blocks
    assert geometry.sweep_launch(B, 5120, 5120, 1024)[:2] == (B, 1024)

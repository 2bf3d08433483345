"""Myers sweep and walk of the PyTorch port (plain versions, on the CPU)
against the JAX package's jnp oracles myers_sweep_ref / myers_walk_ref:
the DIAG/UP planes (after the port's (B, m_cap, 2, nw) layout is
transposed to the oracle's (m_cap, 2, nw, B)) and the rows payload bytes
must be equal exactly. Cases follow tests/test_myers_kernel.py.

Each case also runs a numpy model of the CUDA walk's row step
(kernels/csrc/myers_walk.cu: the word of lane kvec masked to lanes <=
kvec and clz, else the out-of-line step over the next two words) against
myers_walk_plain, and the walk's launch geometry (ops/geometry.py) is
checked against the kernel's constants."""

import re
from pathlib import Path


import jax.numpy as jnp
import numpy as np
import pytest
import torch

from racon_tpu.ops.myers_kernel import (build_peq_T, myers_sweep_ref,
                                        myers_walk_ref)
from racon_tpu.ops.nw_kernel import encode, pack_codes4
from racon_tpu_torch.ops import geometry
from racon_tpu_torch.ops import myers_kernel as port
from racon_tpu_torch.ops.batch import to_device

torch.set_num_threads(2)
ACGT = np.frombuffer(b"ACGT", np.uint8)


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


def _check(pairs, cap, w):
    B = len(pairs)
    q8 = np.full((B, cap), 5, np.int8)
    t8 = np.full((B, cap), 5, np.int8)
    m = np.zeros(B, np.int32)
    n = np.zeros(B, np.int32)
    for b, (qa, ta) in enumerate(pairs):
        q8[b, : len(qa)] = encode(qa)
        t8[b, : len(ta)] = encode(ta)
        m[b], n[b] = len(qa), len(ta)
    bt = to_device(pack_codes4(q8), pack_codes4(t8), None, m, n, m_cap=cap,
                   n_cap=cap, device="cpu")
    planes = port.myers_sweep(bt.q4, bt.t4, m_cap=cap, n_cap=cap, w_band=w)
    payload = port.myers_walk(planes, bt.m, bt.n, m_cap=cap, n_cap=cap,
                              w_band=w).numpy()

    tT = jnp.asarray(t8.astype(np.int32).T)
    want_planes = myers_sweep_ref(jnp.asarray(q8.astype(np.int32).T),
                                  build_peq_T(tT, cap, w), m_cap=cap,
                                  n_cap=cap, w_band=w)
    want_payload, want_esc = myers_walk_ref(
        want_planes, jnp.asarray(m), jnp.asarray(n), m_cap=cap, n_cap=cap,
        w_band=w)
    assert planes.shape == (B, cap, 2, w // 32)
    assert np.array_equal(planes.numpy().transpose(1, 2, 3, 0),
                          np.asarray(want_planes))
    assert payload.shape == (B, cap + 2)
    assert np.array_equal(payload, np.asarray(want_payload))
    assert np.array_equal(payload[:, -1] != 0, np.asarray(want_esc))
    assert np.array_equal(
        _warp_walk_model(planes.numpy(), m, n, m_cap=cap, n_cap=cap,
                         w_band=w), payload)
    return payload


_M32 = 0xFFFFFFFF


def _warp_walk_model(planes, m, n, *, m_cap, n_cap, w_band):
    """numpy model of myers_walk.cu's row step, as every lane of the warp
    computes it from the shared-memory ring: the word of lane kvec (kvec
    clamped into the band's words) masked to lanes <= kvec, its highest
    set bit (31 - clz) and that bit's DIAG/UP; when the word has none or
    kvec is out of the band, step_far: the next two words down, masked to
    lanes >= kvec - 63, else escape. Records go out per group of 32 rows;
    rows above m and from an escape down stay 0."""
    W = w_band
    nw = W // 32
    dlo = geometry.band_dlo(m_cap, n_cap, W)
    B = planes.shape[0]
    words = planes.astype(np.int64) & _M32
    out = np.zeros((B, m_cap + 2), np.uint8)

    def onehot(kz, w):
        rel = kz - 32 * w
        return 1 << rel if 0 <= rel < 32 else 0

    def mask_ge(pos, w):  # bits >= pos of word w (common.cuh mask_ge)
        sh = pos - 32 * w
        return _M32 if sh <= 0 else (0 if sh >= 32 else (_M32 << sh) & _M32)

    def step_far(d_row, u_row, kvec, kz):
        if not 0 <= kvec < W:
            return None
        wk = kvec >> 5
        for w in range(wk - 1, max(wk - 3, -1), -1):
            d, u, oh = int(d_row[w]), int(u_row[w]), onehot(kz, w)
            nl = (d | u | oh) & mask_ge(kvec - 63, w)
            if nl:
                pos = nl.bit_length() - 1
                return 32 * w + pos, (d & ~oh) >> pos & 1, (u | oh) >> pos & 1
        return None

    for b in range(B):
        mb = int(m[b])
        kvec = int(n[b]) - mb - dlo
        esc = False
        for i in range(mb, 0, -1):
            d_row, u_row = words[b, i - 1, 0], words[b, i - 1, 1]
            kz = -(i + dlo)
            w = min((kvec & _M32) >> 5, nw - 1)  # unsigned shift, clamped
            d, u, oh = int(d_row[w]), int(u_row[w]), onehot(kz, w)
            nl = (d | u | oh) & (_M32 >> (31 - (kvec & 31)))
            if nl and 0 <= kvec < W:
                pos = nl.bit_length() - 1
                k_exit, dh, uh = 32 * w + pos, (d & ~oh) >> pos & 1, \
                    (u | oh) >> pos & 1
            else:
                far = step_far(d_row, u_row, kvec, kz)
                if far is None:
                    esc = True
                    break
                k_exit, dh, uh = far
            out[b, i - 1] = ((geometry.REC_DIAG if dh else geometry.REC_UP)
                             | ((kvec - k_exit) << 2))
            kvec = k_exit + (1 if uh and not dh else 0)
        jfin = dlo + kvec
        out[b, m_cap] = min(max(jfin, 0), 255)
        out[b, m_cap + 1] = esc or jfin < 0 or jfin > 255
    return out


@pytest.mark.parametrize("w", [64, 128])
def test_random_mutations(w):
    rng = np.random.default_rng(51)
    pairs = []
    for _ in range(48):
        tlen = int(rng.integers(8, 128))
        t = rng.choice(ACGT, tlen)
        pairs.append((_mutate(rng, t, int(rng.integers(0, tlen // 3 + 1)))
                      [:128], t))
    _check(pairs, 128, w)


def test_heavy_drift_near_band_margin():
    """Length mismatch close to the band edge: paths hug the band, and
    the soft-edge fills must not change any in-band bit."""
    rng = np.random.default_rng(53)
    pairs = []
    for _ in range(32):
        tlen = int(rng.integers(80, 128))
        t = rng.choice(ACGT, tlen)
        drop = int(rng.integers(0, 28))
        q = np.delete(t, rng.choice(tlen, min(drop, tlen - 2),
                                    replace=False)) if drop else t.copy()
        pairs.append((q, t))
    _check(pairs, 128, 64)


def test_long_inserts_and_escapes():
    """Long insertions, a >63-deletion tail (the rows format's 6-bit
    limit) and band exits must escape exactly as the oracle does."""
    rng = np.random.default_rng(57)
    pairs = []
    for _ in range(20):
        tlen = int(rng.integers(70, 120))
        t = rng.choice(ACGT, tlen)
        pos = int(rng.integers(0, tlen))
        ins = rng.choice(ACGT, int(rng.integers(0, 30)))
        pairs.append((np.insert(t, pos, ins)[:128], t))
    t = rng.choice(ACGT, 120)
    pairs.append((t[:20].copy(), t))
    payload = _check(pairs, 128, 64)
    assert payload[-1, -1] == 1


def test_deletion_runs_across_two_words():
    """Targets with extra blocks that match nothing (A/C queries, G/T
    blocks): an early block of 0, 6 or 12 bases and a later one of
    33..70, each one row's deletion run. The later run starts 128 + early
    + run lanes up and exits at 128 + early, up to two words below kvec's
    (the walk's out-of-line step); runs of 64 or more escape."""
    rng = np.random.default_rng(67)
    pairs = []
    for run in (33, 47, 52, 58, 63, 64, 70):
        for early in (0, 6, 12):
            q = rng.choice(ACGT[:2], int(rng.integers(120, 160)))
            pos = int(rng.integers(40, len(q) - 10))
            t = np.insert(q, pos, rng.choice(ACGT[2:], run))
            t = np.insert(t, 20, rng.choice(ACGT[2:], early))
            pairs.append((q, t[:256]))
    payload = _check(pairs, 256, 256)
    dlo = geometry.band_dlo(256, 256, 256)
    words_down = []
    for b, (q, t) in enumerate(pairs):
        kvec = len(t) - len(q) - dlo
        for i in range(len(q), 0, -1):
            rec = int(payload[b, i - 1])
            if not rec:
                break
            left = rec >> 2
            words_down.append((kvec >> 5) - ((kvec - left) >> 5))
            kvec -= left - ((rec & 3) == geometry.REC_UP)
    assert max(words_down) == 2
    assert payload[-6:, -1].all()


def test_mixed_identical_and_empty():
    rng = np.random.default_rng(59)
    t = rng.choice(ACGT, 100)
    pairs = [(t.copy(), t), (t[:60].copy(), t[:60]),
             (rng.choice(ACGT, 1), rng.choice(ACGT, 1)),
             (np.zeros(0, np.uint8), np.zeros(0, np.uint8))]
    _check(pairs, 128, 64)


def test_multi_word_carry_at_align_width():
    """W = 512 (16 words, the align stage's first tier width) over 512
    rows: carries and one-bit shifts cross many word boundaries."""
    rng = np.random.default_rng(61)
    pairs = []
    for _ in range(8):
        tlen = int(rng.integers(300, 512))
        t = rng.choice(ACGT, tlen)
        pairs.append((_mutate(rng, t, int(tlen * 0.12))[:512], t))
    _check(pairs, 512, 512)


_CSRC = Path(geometry.__file__).parents[1] / "kernels" / "csrc"


def test_walk_geometry_mirrors_the_kernel():
    """ops/geometry.py's walk constants are the kernel's own."""
    src = (_CSRC / "myers_walk.cu").read_text()
    assert int(re.search(r"kWalkWarps = (\d+);", src).group(1)) \
        == geometry.MYERS_WALK_WARPS
    assert int(re.search(r"kWalkRows = (\d+);", src).group(1)) \
        == geometry.MYERS_WALK_ROWS
    assert "launch_walk<64>" in src and "launch_walk<32>" in src
    assert (geometry.myers_walk_ring(1024), geometry.myers_walk_ring(2048)) \
        == (64, 32)


@pytest.mark.parametrize("w,smem", [(512, 8192), (1024, 16384),
                                    (2048, 16384), (4096, 32768)])
def test_walk_threads_and_shared_bytes(w, smem):
    """One warp per item, two items a block; each warp's ring holds 64
    rows of both planes (2 W/32 words a row) up to W = 1024 and 32 above:
    past the 48 KB default only at W = 4096, where the launcher raises the
    limit (H100: 227 KB a block)."""
    _, threads, per_block = geometry.myers_walk_launch(1, w)
    assert threads == 32 * geometry.MYERS_WALK_WARPS == 64
    assert per_block == geometry.MYERS_WALK_WARPS * smem <= 227 * 1024
    assert geometry.myers_walk_ring(w) % geometry.MYERS_WALK_ROWS == 0


@pytest.mark.parametrize("B,blocks", [(1, 1), (31, 16), (409, 205),
                                      (4097, 2049), (8192, 4096)])
def test_walk_blocks_for_ragged_batches(B, blocks):
    """A ragged batch rounds up to whole blocks (the last one runs a
    single warp); the align stage's chunk at (10240, 1024), 409 items,
    spreads over 205 blocks, more than the 132 SMs."""
    assert geometry.myers_walk_launch(B, 1024)[0] == blocks

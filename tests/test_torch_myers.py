"""Myers sweep and walk of the PyTorch port (plain versions, on the CPU)
against the JAX package's jnp oracles myers_sweep_ref / myers_walk_ref:
the DIAG/UP planes (after the port's (B, m_cap, 2, nw) layout is
transposed to the oracle's (m_cap, 2, nw, B)) and the rows payload bytes
must be equal exactly. Cases follow tests/test_myers_kernel.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from racon_tpu.ops.myers_kernel import (build_peq_T, myers_sweep_ref,
                                        myers_walk_ref)
from racon_tpu.ops.nw_kernel import encode, pack_codes4
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
    return payload


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

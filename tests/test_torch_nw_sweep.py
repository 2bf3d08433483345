"""Scored banded-NW sweep of the PyTorch port (its plain version, on the
CPU) against the JAX package: the jnp oracle nw_band_batch_ref and the
Pallas kernel nw_band_batch_t8 in interpret mode. Integer DP, so moves and
scores must be equal exactly (tolerance 0)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from racon_tpu.ops.nw_kernel import (_prep_panels_t8, encode,
                                     nw_band_batch_ref, nw_band_batch_t8,
                                     pack_codes4, pack_delbits)
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
    """W > 1024 (the reference's lane-major tier) is host work in the
    port: the sweep refuses it on every device."""
    q4 = torch.zeros((1, 5120), dtype=torch.uint8)
    dcb = torch.zeros((1, 1280), dtype=torch.uint8)
    with pytest.raises(ValueError, match="unsupported"):
        port.nw_sweep(q4, q4, dcb, m_cap=10240, n_cap=10240, w_band=2048,
                      match=5, mismatch=-4, gap=-8)


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

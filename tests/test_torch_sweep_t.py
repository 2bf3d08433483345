"""The int32 panel sweep of the PyTorch port, nw_sweep_t (the TPU kernel
nw_band_batch_t), by its plain version on the CPU: against the Pallas
kernel in interpret mode, with the band left of the diagonal (dlo <= 0)
and right of it (dlo > 0), and against the port's packed sweep nw_sweep
on the same items. Integer DP, so moves and scores must be equal exactly
(tolerance 0)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from racon_tpu.ops.nw_kernel import band_dlo, encode, nw_band_batch_t
from racon_tpu_torch.ops import nw_kernel as port
from racon_tpu_torch.ops.batch import to_device
from tests.test_torch_nw_sweep import ACGT, PAD, _mutate, make_batch

torch.set_num_threads(2)
SCORES = dict(match=5, mismatch=-4, gap=-8)


def make_offset_batch(rng, B, m_cap, n_cap, gap):
    """Items for a band right of the diagonal: each query a mutated suffix
    of its target about n_cap - m_cap bases shorter, every 7th item all
    PAD, every 9th shorter still (its path leaves the band), 30% free
    deletion columns."""
    q8 = np.full((B, m_cap), PAD, np.int8)
    t8 = np.full((B, n_cap), PAD, np.int8)
    dc8 = np.full((B, n_cap), gap, np.int8)
    for b in range(B):
        if b % 7 == 6:
            continue
        tlen = int(rng.integers(n_cap - m_cap + 16, n_cap))
        t = rng.choice(ACGT, tlen)
        qlen = tlen - (n_cap - m_cap) + int(rng.integers(-8, 9))
        q = _mutate(rng, t[tlen - qlen:], int(rng.integers(0, qlen // 8)))
        if b % 9 == 4:
            q = q[: max(1, len(q) // 2)]
        q = q[:m_cap]
        q8[b, : len(q)] = encode(q)
        t8[b, :tlen] = encode(t)
        dc8[b, :tlen][rng.random(tlen) < 0.3] = 0
    return q8, t8, dc8


def panels(q8, t8, dc8, w):
    return port.sweep_t_panels(torch.from_numpy(q8), torch.from_numpy(t8),
                               torch.from_numpy(dc8.astype(np.int32)),
                               w_band=w)


@pytest.mark.parametrize("m_cap,n_cap,w", [(128, 128, 64), (128, 256, 64)])
def test_sweep_t_matches_pallas_interpret(m_cap, n_cap, w):
    """The TPU kernel itself at one 128-lane batch tile, its
    (m_cap/16, W, B) moves transposed; (128, 256, 64) has dlo = 96."""
    rng = np.random.default_rng(m_cap + n_cap + w)
    B = 128
    if n_cap == m_cap:
        q8, t8, dc8, _, _ = make_batch(rng, B, m_cap, SCORES["gap"])
    else:
        q8, t8, dc8 = make_offset_batch(rng, B, m_cap, n_cap, SCORES["gap"])
    geo = dict(m_cap=m_cap, n_cap=n_cap, w_band=w)
    assert (band_dlo(m_cap, n_cap, w) > 0) == (n_cap > m_cap)
    q, tp, gcp = panels(q8, t8, dc8, w)
    assert tp.shape == (B, n_cap + 2 * w)
    assert gcp.shape == (B, n_cap + 1 + 2 * w)
    moves, score = port.nw_sweep_t(q, tp, gcp, **geo, **SCORES)
    want_mv, want_sc = nw_band_batch_t(
        jnp.asarray(q.numpy().T), jnp.asarray(tp.numpy().T),
        jnp.asarray(gcp.numpy().T), **geo, **SCORES, interpret=True)
    assert moves.shape == (B, m_cap // 16, w)
    assert np.array_equal(moves.numpy(),
                          np.asarray(want_mv).transpose(2, 0, 1))
    assert np.array_equal(score.numpy(), np.asarray(want_sc)[0])


@pytest.mark.parametrize("cap,w,scores", [(640, 128, (5, -4, -8)),
                                          (256, 128, (0, -1, -1)),
                                          (384, 256, (3, -5, -4))])
def test_sweep_t_equals_packed_sweep(cap, w, scores):
    """K7 on the panels equals K1 (nw_sweep) on the same items packed, as
    the TPU kernels are bit-identical modulo layout."""
    rng = np.random.default_rng(cap + w)
    sc = dict(zip(("match", "mismatch", "gap"), scores))
    q8, t8, dc8, m, n = make_batch(rng, 48, cap, sc["gap"])
    geo = dict(m_cap=cap, n_cap=cap, w_band=w)
    moves, score = port.nw_sweep_t(*panels(q8, t8, dc8, w), **geo, **sc)
    x = q8.astype(np.uint8), t8.astype(np.uint8)
    q4, t4 = (a[:, 0::2] | (a[:, 1::2] << 4) for a in x)
    b = to_device(q4, t4, np.packbits(dc8 != 0, axis=1, bitorder="little"),
                  m, n, m_cap=cap, n_cap=cap, device="cpu")
    pm, ps = port.nw_sweep_plain(b.q4, b.t4, b.dcb, **geo, **sc)
    assert torch.equal(moves, pm) and torch.equal(score, ps)


def test_sweep_t_refuses_shapes_outside_its_domain():
    """m_cap not a multiple of 128, W not a multiple of 32 or above 1024,
    or n_cap < m_cap - W/2 (the first row's window would leave the padded
    panels) is refused on every device; a non-CPU tensor never reaches the
    plain version."""
    for m_cap, n_cap, w in ((192, 192, 64), (128, 128, 48),
                            (2048, 2048, 2048), (256, 190, 128)):
        q = torch.zeros((1, m_cap), dtype=torch.int32)
        tp = torch.zeros((1, n_cap + 2 * w), dtype=torch.int32)
        gcp = torch.zeros((1, n_cap + 1 + 2 * w), dtype=torch.int32)
        for dev in ("cpu", "meta"):
            with pytest.raises(ValueError, match="unsupported"):
                port.nw_sweep_t(q.to(dev), tp.to(dev), gcp.to(dev),
                                m_cap=m_cap, n_cap=n_cap, w_band=w, **SCORES)
    # the edge of the domain: n_cap = m_cap - W/2 (dlo = -W) is taken
    q8, t8, dc8 = (np.full((2, c), PAD, np.int8) for c in (256, 192, 192))
    moves, score = port.nw_sweep_t(*panels(q8, t8, dc8, 128), m_cap=256,
                                   n_cap=192, w_band=128, **SCORES)
    assert moves.shape == (2, 16, 128) and score.shape == (2,)
    meta = torch.empty((2, 256), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="device"):
        port.nw_sweep_t(meta, meta, meta, m_cap=128, n_cap=128, w_band=64,
                        **SCORES)
    with pytest.raises(ValueError, match="CPU"):
        port.nw_sweep_t_plain(meta, meta, meta, m_cap=128, n_cap=128,
                              w_band=64, **SCORES)

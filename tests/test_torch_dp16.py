"""The int16 DP of the port's scored sweep (RACON_TPU_DP16=1) against the
JAX package on the CPU, exactly (tolerance 0: integer DP):

- geometry.dp16_eligible and dp_consts against racon_tpu's dp16_eligible
  and _dp_dtype, with the switch set to 1, to 0 and unset;
- the int16 plain sweep against nw_band_batch_t8 run in int16
  (interpret mode), as tests/test_dp16.py builds its inputs; the big-tier
  twin t8big is in tests/test_torch_dp16_big.py;
- the int16 plain sweep against the int32 plain sweep;
- the CLI FASTA with RACON_TPU_DP16=1 against the one without it and
  against racon_tpu's with it.
"""

import numpy as np
import pytest
import torch

from racon_tpu.ops import nw_kernel as jnk
from racon_tpu_torch.ops import geometry
from racon_tpu_torch.ops import nw_kernel as port
from racon_tpu_torch.ops.batch import to_device
from tests.test_torch_e2e import _polish, _synthetic_case
from tests.test_torch_nw_sweep import make_batch

torch.set_num_threads(2)

# (m_cap, n_cap) of every tier of both stages and a few beside them, and
# score sets of the consensus stage (5/-4/-8 and others) and the align
# stage (0/-1/-1)
_CAPS = [(256, 256), (640, 640), (1024, 1024), (1280, 1280), (2560, 2560),
         (5120, 5120), (7424, 7424), (7488, 7488), (10240, 10240),
         (640, 1280)]
_SCORES = [(5, -4, -8), (0, -1, -1), (3, -5, -4), (1, -1, -1), (2, -3, -9),
           (-1, -2, 0)]


@pytest.mark.parametrize("env", ["1", "0", None])
def test_dp16_gate_matches_reference(monkeypatch, env):
    if env is None:
        monkeypatch.delenv("RACON_TPU_DP16", raising=False)
    else:
        monkeypatch.setenv("RACON_TPU_DP16", env)
    held = 0
    for m_cap, n_cap in _CAPS:
        for scores in _SCORES:
            want = jnk.dp16_eligible(m_cap, n_cap, *scores)
            assert geometry.dp16_eligible(m_cap, n_cap, *scores) == want
            dt, neg, fill = geometry.dp_consts(m_cap, n_cap, *scores)
            jdt, jneg, jfill = jnk._dp_dtype(m_cap, n_cap, *scores)
            assert str(dt).split(".")[-1] == np.dtype(jdt).name
            assert (neg, fill) == (jneg, jfill)
            held += want
    # only "1" turns it on; then the grid holds both answers
    if env == "1":
        assert 0 < held < len(_CAPS) * len(_SCORES)
    else:
        assert held == 0


def _packed(rng, B, cap, gap):
    """tests/test_dp16.py's items (substitutions at 15 %, lengths in
    [cap/2, cap], deletion bits at 30 %), packed."""
    t8 = rng.integers(0, 4, (B, cap)).astype(np.int8)
    q8 = t8.copy()
    sub = rng.random((B, cap)) < 0.15
    q8[sub] = rng.integers(0, 4, int(sub.sum()))
    m = rng.integers(cap // 2, cap + 1, B).astype(np.int32)
    n = rng.integers(cap // 2, cap + 1, B).astype(np.int32)
    for b in range(B):
        q8[b, m[b]:] = jnk.PAD_CODE
        t8[b, n[b]:] = jnk.PAD_CODE
    dc8 = np.full((B, cap), gap, np.int8)
    dc8[rng.random((B, cap)) < 0.3] = 0
    return jnk.pack_codes4(q8), jnk.pack_codes4(t8), jnk.pack_delbits(dc8), \
        m, n


def reference_pair(monkeypatch, fn, cap, w, scores, seed, B=128):
    """(port plain, JAX kernel fn in interpret mode), both under
    RACON_TPU_DP16=1 at an eligible shape: moves (B, cap/16, W) and score
    (B,) as numpy."""
    import jax.numpy as jnp

    monkeypatch.setenv("RACON_TPU_DP16", "1")
    assert geometry.sweep_dp16(cap, cap, w, *scores)
    q4, t4, dcb, m, n = _packed(np.random.default_rng(seed), B, cap,
                                scores[2])
    b = to_device(q4, t4, dcb, m, n, m_cap=cap, n_cap=cap, device="cpu")
    kw = dict(m_cap=cap, n_cap=cap, w_band=w,
              **dict(zip(("match", "mismatch", "gap"), scores)))
    got_mv, got_sc = port.nw_sweep(b.q4, b.t4, b.dcb, **kw)
    qT, tpT, dcpT = jnk._prep_panels_t8(jnp.asarray(q4), jnp.asarray(t4),
                                        jnp.asarray(dcb), m_cap=cap,
                                        n_cap=cap, w_band=w, gap=scores[2])
    want_mv, want_sc = fn(qT, tpT, dcpT, **kw, interpret=True)
    return ((got_mv.numpy(), got_sc.numpy()),
            (np.asarray(want_mv).transpose(2, 0, 1), np.asarray(want_sc)[0]))


def test_plain16_matches_t8_interpret(monkeypatch):
    """(256,128) B = 128 at 5/-4/-8: the port's int16 plain sweep against
    nw_band_batch_t8 running in int16."""
    (gm, gs), (wm, ws) = reference_pair(monkeypatch, jnk.nw_band_batch_t8,
                                        256, 128, (5, -4, -8), 5)
    assert np.array_equal(gm, wm)
    assert np.array_equal(gs, ws)


@pytest.mark.parametrize("cap,w,scores", [
    (256, 128, (5, -4, -8)), (640, 128, (5, -4, -8)), (256, 96, (5, -4, -8)),
    (512, 256, (3, -5, -4)), (768, 288, (5, -4, -8)),
    (2560, 512, (0, -1, -1)), (1024, 1024, (0, -1, -1))])
def test_plain16_matches_plain32(monkeypatch, cap, w, scores):
    """H in int16 (the switch on) gives the int32 sweep's moves and score,
    with make_batch's all-PAD and out-of-band items, at K1's tiers, K2's
    (1280,512)-like and align (2560,512) tiers, and bands with pad lanes in
    the int16 kernels (W = 96, 288)."""
    rng = np.random.default_rng(cap + w)
    B = 8 if cap >= 2560 else 16
    q8, t8, dc8, m, n = make_batch(rng, B, cap, scores[2])
    b = to_device(jnk.pack_codes4(q8), jnk.pack_codes4(t8),
                  jnk.pack_delbits(dc8), m, n, m_cap=cap, n_cap=cap,
                  device="cpu")
    kw = dict(m_cap=cap, n_cap=cap, w_band=w,
              **dict(zip(("match", "mismatch", "gap"), scores)))
    monkeypatch.delenv("RACON_TPU_DP16", raising=False)
    m32, s32 = port.nw_sweep(b.q4, b.t4, b.dcb, **kw)
    monkeypatch.setenv("RACON_TPU_DP16", "1")
    assert geometry.sweep_dp16(cap, cap, w, *scores)
    m16, s16 = port.nw_sweep(b.q4, b.t4, b.dcb, **kw)
    assert s16.dtype == torch.int32 and m16.dtype == torch.int32
    assert torch.equal(m16, m32) and torch.equal(s16, s32)


@pytest.mark.parametrize("w,dp16,name", [
    (128, True, "nw_sweep16"), (256, True, "nw_sweep16"),
    (512, True, "nw_sweep_block16"), (1024, True, "nw_sweep_block16"),
    (2048, True, "nw_sweep_wide"), (128, False, "nw_sweep"),
    (512, False, "nw_sweep_block")])
def test_sweep16_kernel_names(w, dp16, name):
    """The int16 forms of the warp and block kernels; K5 (W > 1024) has
    none, as the reference's lane-major kernel has none."""
    assert geometry.sweep_kernel(w, dp16) == name


def test_sweep_dp16_only_up_to_1024(monkeypatch):
    monkeypatch.setenv("RACON_TPU_DP16", "1")
    assert geometry.sweep_dp16(2560, 2560, 512, 0, -1, -1)
    assert geometry.sweep_dp16(640, 640, 128, 5, -4, -8)
    assert not geometry.sweep_dp16(1280, 1280, 256, 5, -4, -8)
    assert geometry.dp16_eligible(2560, 2560, 0, -1, -1)
    assert not geometry.sweep_dp16(2560, 2560, 2048, 0, -1, -1)
    monkeypatch.setenv("RACON_TPU_DP16", "0")
    assert not geometry.sweep_dp16(640, 640, 128, 5, -4, -8)


@pytest.mark.parametrize("cap,w,B,blocks,threads,smem", [
    (640, 128, 4096, 256, 128, 16 * (640 + 1280)),
    (256, 128, 4097, 257, 128, 16 * (256 + 512)),
    (512, 256, 4097, 1025, 128, 4 * (512 + 1024)),
    (384, 96, 5, 2, 128, 4 * (384 + 768)),
    (2560, 512, 1024, 1024, 256, (2 * 256 + 32) * 4 + 2560 + 5120),
    (768, 288, 3, 3, 160, (2 * 160 + 32) * 4 + 768 + 1536)])
def test_sweep16_launch(cap, w, B, blocks, threads, smem):
    """Four warps a block in the int16 warp kernel, four items a warp at
    W = 128 (16 a block) and one elsewhere, each item its query bytes and
    16-bit column halves; the block kernel one pair of lanes a thread,
    rounded up to whole warps."""
    assert geometry.sweep_launch(B, cap, cap, w, dp16=True) == (
        blocks, threads, smem)


def test_cli_fasta_with_dp16(tmp_path, monkeypatch):
    """The synthetic case polished by the port (plain versions) with
    RACON_TPU_DP16=1 equals the same without it, and racon_tpu's with it
    (its interpreted int16 stages at the real tier shapes)."""
    from racon_tpu.models.polish_model import PolisherConfig as JaxConfig
    from racon_tpu.polisher import create_polisher as jax_create
    from racon_tpu_torch.models.polish_model import PolisherConfig
    from racon_tpu_torch.polisher import create_polisher

    paths = _synthetic_case(tmp_path)
    cfg = PolisherConfig(backend="cuda", num_threads=2, trim=False)
    monkeypatch.delenv("RACON_TPU_DP16", raising=False)
    off = _polish(create_polisher, paths, cfg, device="cpu")
    monkeypatch.setenv("RACON_TPU_DP16", "1")
    on = _polish(create_polisher, paths, cfg, device="cpu")
    assert on == off
    monkeypatch.setenv("RACON_TPU_INTERPRET_FULLCAP", "1")
    monkeypatch.setenv("RACON_TPU_CONSENSUS_ROUTE", "device")
    want = _polish(jax_create, paths,
                   JaxConfig(backend="tpu", num_threads=2, trim=False))
    assert on == want

"""The port's ablation harness, racon_tpu_torch.benchmarks.profile_ablate:
each variant's plain version (the TPU kernel run_variant, K8) against the
JAX harness's make_kernel run through pl.pallas_call in interpret mode
with run_variant's specs (benchmarks/profile_ablate.py, which has no
package and no interpret switch, loaded from its file and left as it is),
and the harness's own lines on the CPU against the JAX package. Integer
DP: tolerance 0. "nomoves" leaves its moves unwritten, so only its score
is compared."""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from racon_tpu.ops.nw_kernel import (_GROUP, _PACK, B_LANE, rle_events,
                                     walk_moves_rle_t)
from racon_tpu_torch.benchmarks import profile_ablate as pa
from racon_tpu_torch.ops import nw_kernel as port
from tests.test_torch_nw_sweep import make_batch

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CAP, W, B = 128, 64, 128
GEO = dict(m_cap=CAP, n_cap=CAP, w_band=W)


def _jax_harness():
    spec = importlib.util.spec_from_file_location(
        "jax_profile_ablate", os.path.join(REPO, "benchmarks",
                                           "profile_ablate.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _interpret_variant(mod, qT, tpT, gcpT, variant):
    """run_variant's pallas_call (profile_ablate.py:121-157), in interpret
    mode."""
    kw = dict(closure=variant != "noclosure", moves=variant != "nomoves",
              dynload=variant != "noload", empty=variant == "empty")
    kernel = mod.make_kernel(CAP, CAP, W, 5, -4, -8, **kw)
    slots = _GROUP // _PACK
    return pl.pallas_call(
        kernel,
        grid=(B // B_LANE, CAP // _GROUP),
        out_shape=(jax.ShapeDtypeStruct((CAP // _PACK, W, B), jnp.int32),
                   jax.ShapeDtypeStruct((1, B), jnp.int32)),
        in_specs=[
            pl.BlockSpec((CAP, B_LANE), lambda i, g: (0, i),
                         memory_space=pltpu.VMEM),
            pl.BlockSpec((tpT.shape[0], B_LANE), lambda i, g: (0, i),
                         memory_space=pltpu.VMEM),
            pl.BlockSpec((gcpT.shape[0], B_LANE), lambda i, g: (0, i),
                         memory_space=pltpu.VMEM)],
        out_specs=(
            pl.BlockSpec((slots, W, B_LANE), lambda i, g: (g, 0, i),
                         memory_space=pltpu.VMEM),
            pl.BlockSpec((1, B_LANE), lambda i, g: (0, i),
                         memory_space=pltpu.VMEM)),
        scratch_shapes=[pltpu.VMEM((W, B_LANE), jnp.int32)],
        interpret=True)(qT, tpT, gcpT)


@pytest.fixture(scope="module")
def variants():
    """The panels of make_batch-style items at (128, 128, 64), B = 128
    (all-PAD items, band drift, free deletion columns), and each
    variant's interpreted TPU output (moves (B, slots, W), score (B,))."""
    rng = np.random.default_rng(8)
    q8, t8, dc8, _, _ = make_batch(rng, B, CAP, -8)
    panels = port.sweep_t_panels(torch.from_numpy(q8), torch.from_numpy(t8),
                                 torch.from_numpy(dc8.astype(np.int32)),
                                 w_band=W)
    mod = _jax_harness()
    T = [jnp.asarray(p.numpy().T) for p in panels]
    want = {}
    for v in pa.VARIANTS:
        mv, sc = _interpret_variant(mod, *T, v)
        want[v] = (np.asarray(mv).transpose(2, 0, 1), np.asarray(sc)[0])
    return panels, want


@pytest.mark.parametrize("variant", ["full", "noclosure", "nomoves",
                                     "noload", "empty"])
def test_variant_matches_make_kernel(variants, variant):
    panels, want = variants
    moves, score = pa.run_variant(*panels, **GEO, variant=variant)
    assert np.array_equal(score.numpy(), want[variant][1])
    if variant != "nomoves":
        assert np.array_equal(moves.numpy(), want[variant][0])


def test_full_variant_is_the_panel_sweep(variants):
    panels, _ = variants
    moves, score = pa.run_variant(*panels, **GEO, variant="full")
    pm, ps = port.nw_sweep_t(*panels, **GEO, **pa.SCORES)
    assert torch.equal(moves, pm) and torch.equal(score, ps)


def test_harness_lines_on_the_cpu():
    """The harness at (B 128, cap 128, W 64) with --device cpu: every line
    printed; nwonly is the panel sweep on make_inputs' panels, walkonly the
    JAX RLE walk (walk_moves_rle_t) on nwonly's moves."""
    inp = pa.make_inputs(B, CAP, W)
    assert inp["m"].min() >= 28 and inp["n"].max() <= CAP
    printed = []
    lines = pa.run_lines(inp, "cpu", reps=1, out=printed.append)
    names = [*pa.VARIANTS, "nwonly", "walkonly", "fused+h2d"]
    assert [p.split(":")[0].strip() for p in printed] == names
    assert all(lines[k][0] >= 0 for k in names)
    moves, score = lines["nwonly"][1]
    q, tp, gcp = (torch.from_numpy(inp[k]) for k in ("q", "tp", "gcp"))
    pm, ps = port.nw_sweep_t_plain(q, tp, gcp, **GEO, **pa.SCORES)
    assert torch.equal(moves, pm) and torch.equal(score, ps)
    events, esc = walk_moves_rle_t(
        jnp.asarray(moves.numpy().transpose(1, 2, 0)), jnp.asarray(inp["m"]),
        jnp.asarray(inp["n"]), **GEO, max_events=rle_events(CAP, CAP, W))
    want = np.concatenate([np.asarray(events),
                           np.asarray(esc)[:, None].astype(np.uint8)], 1)
    assert np.array_equal(lines["walkonly"][1].numpy(), want)
    payload, fused_score, fmt = lines["fused+h2d"][1]
    assert fmt == "rle" and torch.equal(fused_score, score)
    assert torch.equal(payload, lines["walkonly"][1])


def test_harness_refuses_to_run_without_a_gpu(monkeypatch, capsys):
    """No fallback: without a CUDA device the harness exits 2 and prints
    no line, unless --device cpu asks for the plain versions."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert pa.main(["128", "128", "64"]) == 2
    assert "no CUDA device" in capsys.readouterr().err
    assert pa.main(["128", "128", "64", "--device", "cpu"]) == 0
    assert "walkonly" in capsys.readouterr().out


def test_run_variant_refuses_what_it_does_not_take():
    q = torch.zeros((1, CAP), dtype=torch.int32)
    tp = torch.zeros((1, CAP + 2 * W), dtype=torch.int32)
    gcp = torch.zeros((1, CAP + 1 + 2 * W), dtype=torch.int32)
    with pytest.raises(ValueError, match="variant"):
        pa.run_variant(q, tp, gcp, **GEO, variant="nowalk")
    with pytest.raises(ValueError, match="unsupported"):
        pa.run_variant(q, tp, gcp, m_cap=CAP, n_cap=CAP, w_band=40,
                       variant="full")
    meta = [x.to("meta") for x in (q, tp, gcp)]
    with pytest.raises(ValueError, match="device"):
        pa.run_variant(*meta, **GEO, variant="empty")
    with pytest.raises(ValueError, match="CPU"):
        pa.run_variant_plain(*meta, **GEO, variant="empty")

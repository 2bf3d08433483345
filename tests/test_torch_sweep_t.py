"""The int32 panel sweep of the PyTorch port, nw_sweep_t (the TPU kernel
nw_band_batch_t), by its plain version on the CPU: against the Pallas
kernel in interpret mode, with the band left of the diagonal (dlo <= 0)
and right of it (dlo > 0), and against the port's packed sweep nw_sweep
on the same items. Integer DP, so moves and scores must be equal exactly
(tolerance 0).

The CUDA kernel's warp design (kernels/csrc/nw_sweep_t.cu, W <= 256) is
modelled in numpy here, every ablation variant's outputs included, and
held against the plain versions (run_variant_plain), with a broken copy
of the model that must differ; the launch geometry and the row loop's
lack of block barriers are checked against the kernel's source."""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from racon_tpu.ops.nw_kernel import band_dlo, encode, nw_band_batch_t
from racon_tpu_torch.benchmarks import profile_ablate as pa
from racon_tpu_torch.ops import geometry
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


# ------------------------------- the warp panel sweep (W <= 256: K7, K8)

_CSRC = Path(geometry.__file__).parents[1] / "kernels" / "csrc"
_NEG = geometry.NEG


def _lanes(w_band):
    """Band lanes a thread of the warp kernel (W <= 256): 1, 2, 4 or 8,
    the fewest with 32 of them covering W (the rest pad lanes); 0 above,
    where the block kernel runs a thread a lane."""
    if w_band > 256:
        return 0
    return next(lpt for lpt in (1, 2, 4, 8) if 32 * lpt >= w_band)


def _window(panel, off, W, lpt):
    """Each item's band window panel[b, off + k] as the warp kernel's
    threads load it: lane k's word, a pad lane's (k >= W) lane W - 1's;
    an index past the panel raises."""
    return panel[:, off + np.minimum(np.arange(32 * lpt), W - 1)]


def _warp_panel_model(q, tp, gcp, *, m_cap, n_cap, w_band, variant,
                      broken=None):
    """numpy model of nw_sweep_t_warp_kernel at the harness's scores:
    thread t of an item's warp owns lanes LPT*t .. LPT*t + LPT - 1 (LPT =
    _lanes), lanes from W to 32 LPT are pad lanes (outside
    in every row, reading the panels at lane W - 1, stored nowhere); each
    row reads the thread's panel words at off = i - 1 + W + dlo (noload:
    W + dlo and query row 0) as _window loads them; the up neighbour of a thread's last lane is
    the next thread's first (the top thread's NEG); the scan is a serial
    max over the thread's lanes, the inclusive max of the 32 thread totals
    and the exclusive prefix. `broken` drops one piece, for the mutation
    case: "prefix" the exclusive prefix, "above" the shuffle (a thread's
    last lane takes NEG as its up neighbour)."""
    match, mismatch, gap = pa.SCORES.values()
    W = w_band
    lpt = _lanes(W)
    WP = 32 * lpt
    B = q.shape[0]
    dlo = geometry.band_dlo(m_cap, n_cap, W)
    k = np.arange(WP)
    jmax = np.where(k < W, n_cap, -1)     # pad lanes: outside every row
    span = geometry.scan_span(W)
    q, tp, gcp = (np.asarray(x, np.int64) for x in (q, tp, gcp))
    words = m_cap // 16
    if variant == "empty":
        g0 = _window(gcp, 0, W, lpt)
        moves = g0[:, None, :] + (np.arange(words) % 8)[None, :, None]
        return moves[:, :, :W].astype(np.int32), (g0[:, 0] + 8).astype(
            np.int32)
    closure = variant != "noclosure"
    dynload = variant != "noload"
    j0 = dlo + k
    hp = np.where((j0 >= 0) & (j0 <= jmax), _window(gcp, W + dlo, W, lpt),
                  _NEG)
    moves = np.zeros((B, words, WP), np.int64)
    last = (k % lpt) == lpt - 1
    for i in range(1, m_cap + 1):
        off = (i - 1 if dynload else 0) + W + dlo
        tc = _window(tp, off, W, lpt)
        qc = q[:, i - 1 if dynload else 0][:, None]
        j = i + dlo + k
        inside = (j >= 0) & (j <= jmax)
        valid = (j >= 1) & (j <= jmax)
        sub = np.where((tc == geometry.PAD_CODE) != (qc == geometry.PAD_CODE),
                       _NEG, np.where(tc == qc, match, mismatch))
        diag = hp + sub
        above = np.concatenate([hp[:, 1:], np.full((B, 1), _NEG)], 1)
        if broken == "above":
            above = np.where(last, _NEG, above)
        up = above + gap
        cand = np.maximum(diag, up)
        cand = np.where(j == 0, i * gap, cand)
        cand = np.where(inside, cand, _NEG)
        if closure:
            gc = _window(gcp, off + 1, W, lpt)
            a = (cand - gc).reshape(B, 32, lpt)
            a = np.maximum.accumulate(a, axis=2)
            incl = np.maximum.accumulate(a[:, :, -1], axis=1)
            excl = np.concatenate([np.full((B, 1), np.iinfo(np.int64).min),
                                   incl[:, :-1]], 1)
            if broken != "prefix":
                a = np.maximum(a, excl[:, :, None])
            a = a.reshape(B, WP)
            a = np.where(k <= span - 2, np.maximum(a, geometry.SCAN_FILL), a)
            h = a + gc
        else:
            h = cand
        h = np.where(inside, h, _NEG)
        mv = np.where(h == diag, 0, np.where(h == up, 1, 2))
        mv = np.where(valid, mv, 3)
        moves[:, (i - 1) // 16] |= mv << (2 * ((i - 1) % 16))
        hp = h
    if dynload:  # the kernel's read a row ahead past the last row
        _window(tp, m_cap + W + dlo, W, lpt)
        _window(gcp, m_cap + W + dlo + 1, W, lpt)
    moves = moves[:, :, :W]
    moves = np.where(moves >= 2 ** 31, moves - 2 ** 32, moves)
    return moves.astype(np.int32), hp[:, n_cap - m_cap - dlo].astype(np.int32)


def _model_case(m_cap, n_cap, w, seed, B=24):
    rng = np.random.default_rng(seed)
    if n_cap == m_cap:
        q8, t8, dc8, _, _ = make_batch(rng, B, m_cap, pa.SCORES["gap"])
    else:
        q8, t8, dc8 = make_offset_batch(rng, B, m_cap, n_cap,
                                        pa.SCORES["gap"])
    return panels(q8, t8, dc8, w)


_MODEL_SHAPES = [(128, 128, 32), (256, 256, 128), (640, 640, 128),
                 (256, 256, 256), (128, 256, 64), (256, 384, 128),
                 (256, 256, 96), (128, 128, 160)]


@pytest.mark.parametrize("variant", pa.VARIANTS)
@pytest.mark.parametrize("m_cap,n_cap,w", _MODEL_SHAPES)
def test_warp_panel_model_matches_plain(m_cap, n_cap, w, variant):
    """The warp panel sweep's layout and row step against
    run_variant_plain, for every variant: at LPT = 1 (W = 32), 4 (the
    harness's W = 128, at (256,128) and (640,128)) and 8 (W = 256), with
    the band right of the diagonal ((128,256,64): dlo = 96; (256,384,128):
    dlo = 64), and with pad lanes (W = 96: a whole pad thread; W = 160:
    LPT = 8, 96 pad lanes); make_batch's all-PAD and out-of-band items.
    nomoves: the score only (its moves are never written)."""
    geo = dict(m_cap=m_cap, n_cap=n_cap, w_band=w)
    q, tp, gcp = _model_case(m_cap, n_cap, w, m_cap + 3 * n_cap + w)
    want_mv, want_sc = pa.run_variant_plain(q, tp, gcp, **geo,
                                            variant=variant)
    got_mv, got_sc = _warp_panel_model(q.numpy(), tp.numpy(), gcp.numpy(),
                                       **geo, variant=variant)
    assert np.array_equal(got_sc, want_sc.numpy())
    if variant != "nomoves":
        assert np.array_equal(got_mv, want_mv.numpy())


@pytest.mark.parametrize("broken", ["prefix", "above"])
def test_warp_panel_model_broken_differs(broken):
    """The model with one piece dropped (the scan's exclusive prefix over
    the thread totals; the next thread's first lane as a thread's last
    lane's up neighbour) no longer matches the plain version: the model
    tests see those pieces."""
    geo = dict(m_cap=256, n_cap=256, w_band=128)
    q, tp, gcp = _model_case(256, 256, 128, 11)
    want_mv, _ = pa.run_variant_plain(q, tp, gcp, **geo, variant="full")
    got_mv, _ = _warp_panel_model(q.numpy(), tp.numpy(), gcp.numpy(),
                                  **geo, variant="full", broken=broken)
    assert not np.array_equal(got_mv, want_mv.numpy())


@pytest.mark.parametrize("w,lanes", [(32, 1), (64, 2), (96, 4), (128, 4),
                                     (160, 8), (256, 8), (288, 0),
                                     (1024, 0)])
def test_panel_sweep_lanes_and_row_loop(w, lanes):
    """The model's lane rule is the kernel's dispatch: band lanes a thread
    of the warp kernel (pad lanes up to 32 of them), the block kernel
    above 256; and the warp kernel's row loop has no block barrier and
    no shared memory."""
    assert _lanes(w) == lanes
    src = (_CSRC / "nw_sweep_t.cu").read_text()
    for lpt, bound in ((1, 32), (2, 64), (4, 128), (8, 256)):
        assert f"W <= {bound}) {{\n    RTT_SWEEP_T_WARP({lpt})" in src
    body = src.index("nw_sweep_t_warp_kernel(const")
    loop = src[body : src.index("\n}\n", body)]
    assert "__syncthreads" not in loop and "__shared__" not in loop

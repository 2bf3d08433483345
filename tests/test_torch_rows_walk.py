"""Rows traceback walk of the PyTorch port (its plain version, on the CPU)
against the JAX package: the Pallas kernel walk_rows_t in interpret mode
and its jnp oracle walk_rows_ref, on move words from the port's plain
sweep (the same words as the reference's, tests/test_torch_nw_sweep.py).
Integer walk, so payload bytes and escape flags must be equal exactly
(tolerance 0), escapes included; the walk_fmt switch RACON_TPU_WALK; and
the consensus stage under RACON_TPU_WALK=rows against the JAX stage's
rows route."""

import contextlib
import io

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench
from racon_tpu.models.polish_model import PolisherConfig
from racon_tpu.ops import nw_kernel as jax_nw_kernel
from racon_tpu.ops.consensus_stage_tpu import TpuConsensusStage
from racon_tpu.ops.nw_kernel import (encode, nw_band_batch_ref, pack_codes4,
                                     pack_delbits, unpack_codes4,
                                     unpack_delbits, walk_rows_ref,
                                     walk_rows_t)
from racon_tpu.parallel import mesh as jax_mesh
from racon_tpu.utils.logger import Logger
from racon_tpu_torch.native import bindings
from racon_tpu_torch.ops import consensus_stage as port_stage
from racon_tpu_torch.ops import nw_kernel as port
from racon_tpu_torch.ops.batch import to_device
from racon_tpu_torch.ops.geometry import rle_events, rows_payload_width

torch.set_num_threads(2)
ACGT = np.frombuffer(b"ACGT", np.uint8)
PAD = 5
CONSENSUS = (5, -4, -8)
ALIGN = (0, -1, -1)


def _mutated_batch(rng, B, cap, gap, free_cols):
    """B mutated pairs (3 % each of substitutions, insertions and
    deletions, then a drift of 0 to 40 bases), every 7th item all PAD,
    every 9th cut to half its length (out of the band); with free_cols,
    30 % of the target columns cost no deletion."""
    q8 = np.full((B, cap), PAD, np.int8)
    t8 = np.full((B, cap), PAD, np.int8)
    dc8 = np.full((B, cap), gap, np.int8)
    m = np.zeros(B, np.int32)
    n = np.zeros(B, np.int32)
    for b in range(B):
        if b % 7 == 6:
            continue
        tl = int(rng.integers(cap // 4, cap))
        t = rng.choice(ACGT, tl)
        q = t[rng.random(tl) >= 0.03]
        ins = np.flatnonzero(rng.random(len(q)) < 0.03)
        q = np.insert(q, ins, rng.choice(ACGT, len(ins)))
        sub = rng.random(len(q)) < 0.03
        q[sub] = rng.choice(ACGT, int(sub.sum()))
        drift = int(rng.integers(0, 41))
        q = np.delete(q, rng.choice(len(q), min(drift, len(q) - 1),
                                    replace=False))
        if b % 9 == 4:
            q = q[: len(q) // 2]
        q = q[:cap]
        q8[b, : len(q)] = encode(q)
        t8[b, :tl] = encode(t)
        m[b], n[b] = len(q), tl
        if free_cols:
            dc8[b, :tl][rng.random(tl) < 0.3] = 0
    return q8, t8, dc8, m, n


def _port_moves(q8, t8, dc8, m, n, cap, w, scores):
    """The port's plain sweep on the packed uplink: CPU tensors."""
    b = to_device(pack_codes4(q8), pack_codes4(t8), pack_delbits(dc8), m, n,
                  m_cap=cap, n_cap=cap, device="cpu")
    match, mismatch, gap = scores
    moves, _ = port.nw_sweep(b.q4, b.t4, b.dcb, m_cap=cap, n_cap=cap,
                             w_band=w, match=match, mismatch=mismatch,
                             gap=gap)
    return moves, b.m, b.n


def _port_rows(moves, m, n, cap, w):
    got = port.rows_walk(moves, m, n, m_cap=cap, n_cap=cap,
                         w_band=w).numpy()
    assert got.shape == (len(m), rows_payload_width(cap))
    return got


def _ref_rows(moves, m, n, cap, w):
    """walk_rows_ref on the port's moves, transposed back to the
    reference's (m_cap / 16, W, B) layout."""
    payload, esc = walk_rows_ref(
        jnp.asarray(moves.numpy().transpose(1, 2, 0)), jnp.asarray(m.numpy()),
        jnp.asarray(n.numpy()), m_cap=cap, n_cap=cap, w_band=w)
    payload = np.asarray(payload)
    assert np.array_equal(payload[:, -1] != 0, np.asarray(esc))
    return payload


def test_rows_walk_matches_pallas_interpret_and_oracle():
    """(128, 64), one 128-item tile of the TPU kernel itself."""
    rng = np.random.default_rng(41)
    cap, w, B = 128, 64, 128
    batch = _mutated_batch(rng, B, cap, CONSENSUS[2], free_cols=True)
    moves, m, n = _port_moves(*batch, cap, w, CONSENSUS)
    got = _port_rows(moves, m, n, cap, w)
    want, want_esc = walk_rows_t(
        jnp.asarray(moves.numpy().transpose(1, 2, 0)), jnp.asarray(m.numpy()),
        jnp.asarray(n.numpy()), m_cap=cap, n_cap=cap, w_band=w,
        interpret=True)
    assert np.array_equal(got, np.asarray(want))
    assert np.array_equal(got[:, -1] != 0, np.asarray(want_esc))
    assert np.array_equal(got, _ref_rows(moves, m, n, cap, w))
    assert 0 < int(got[:, -1].sum()) < B  # some escape, most do not


@pytest.mark.parametrize("cap,w,B,scores", [
    (640, 128, 48, CONSENSUS), (640, 128, 48, ALIGN),
    (5120, 1024, 6, CONSENSUS)])
def test_rows_walk_matches_jnp_oracle(cap, w, B, scores):
    """The consensus stage's tier shapes: (640, 128), the bench tier, and
    (5120, 1024), a big tier with W = 1024."""
    rng = np.random.default_rng(cap + w + scores[2])
    batch = _mutated_batch(rng, B, cap, scores[2],
                           free_cols=scores == CONSENSUS)
    moves, m, n = _port_moves(*batch, cap, w, scores)
    got = _port_rows(moves, m, n, cap, w)
    assert np.array_equal(got, _ref_rows(moves, m, n, cap, w))
    assert int(got[:, -1].sum()) < B // 2


def test_rows_walk_escapes():
    """Each escape of the rows format at (512, 768): a run of 70
    deletions in one row (more than 63), 300 final deletions (more than
    255: the byte saturates), a query 412 bases short (outside the band
    from its first row), beside an all-PAD item, an ordinary item and one
    whose query starts with 20 inserted bases (the walk climbs column
    j = 0, whose lane counts as UP). The deleted run is 70 A's in a
    target whose query holds no A, so no tied diagonal splits it."""
    rng = np.random.default_rng(9)
    cap, w = 512, 768
    t = rng.choice(ACGT, 500)
    ordinary = t.copy()
    ordinary[rng.choice(500, 20, replace=False)] = rng.choice(ACGT, 20)
    cgt = rng.choice(np.frombuffer(b"CGT", np.uint8), 400)
    poly_a = np.concatenate([cgt[:200], np.full(70, ord("A"), np.uint8),
                             cgt[200:]])
    pairs = [
        (ordinary, t),
        (cgt, poly_a),                               # 70-deletion run
        (t[300:].copy(), t),                         # 300 final deletions
        (t[:88].copy(), t),                          # n - m = 412 > W / 2
        (np.zeros(0, np.uint8), np.zeros(0, np.uint8)),
        (np.concatenate([rng.choice(ACGT, 20), t[:480]]), t[:480].copy()),
    ]
    B = len(pairs)
    q8 = np.full((B, cap), PAD, np.int8)
    t8 = np.full((B, cap), PAD, np.int8)
    m = np.zeros(B, np.int32)
    n = np.zeros(B, np.int32)
    for b, (qa, ta) in enumerate(pairs):
        q8[b, : len(qa)] = encode(qa)
        t8[b, : len(ta)] = encode(ta)
        m[b], n[b] = len(qa), len(ta)
    dc8 = np.full((B, cap), -1, np.int8)
    moves, tm, tn = _port_moves(q8, t8, dc8, m, n, cap, w, ALIGN)
    got = _port_rows(moves, tm, tn, cap, w)
    assert np.array_equal(got, _ref_rows(moves, tm, tn, cap, w))
    assert got[:, -1].tolist() == [0, 1, 1, 1, 0, 0]
    assert got[2, cap] == 255
    assert not got[4].any()
    # the climb: an UP record in each of rows 1..20
    assert (got[5, :20] & 3).tolist() == [2] * 20


def test_rows_and_rle_decode_to_the_same_ops():
    """Rows and RLE payloads of the same moves decode (the port's native
    decoders) to identical op lists for every item that neither walk
    flags escaped."""
    rng = np.random.default_rng(77)
    cap, w, B = 640, 128, 64
    batch = _mutated_batch(rng, B, cap, CONSENSUS[2], free_cols=True)
    moves, m, n = _port_moves(*batch, cap, w, CONSENSUS)
    rows = _port_rows(moves, m, n, cap, w)
    rle = port.rle_walk(moves, m, n, m_cap=cap, n_cap=cap, w_band=w).numpy()
    kept = (rows[:, -1] == 0) & (rle[:, -1] == 0)
    assert kept.sum() >= B // 2
    mk, nk = m.numpy()[kept], n.numpy()[kept]
    r_ops, r_off, r_cnt = bindings.opstream_rows_to_ops_batch(
        np.ascontiguousarray(rows[kept]), rows_payload_width(cap), mk, nk, 2)
    e_ops, e_off, e_cnt = bindings.opstream_rle_to_ops_batch(
        np.ascontiguousarray(rle[kept, :-1]), rle_events(cap, cap, w), mk,
        nk, 2)
    assert np.array_equal(r_cnt, e_cnt)
    assert (r_cnt[mk > 0] > 0).all()
    for ro, eo, c in zip(r_off, e_off, r_cnt):
        assert np.array_equal(r_ops[ro : ro + c], e_ops[eo : eo + c])


CONSENSUS_TIERS = ((256, 128), (640, 128), (1280, 256), (1280, 512),
                   (2560, 384), (2560, 768), (5120, 512), (5120, 1024),
                   (10240, 768), (10240, 2048))
ALIGN_TIERS = ((2560, 512), (10240, 1024), (40960, 1024), (10240, 4096),
               (40960, 4096))


@pytest.mark.parametrize("value", [None, "rows", "rle", "auto", "packed2"])
def test_walk_fmt_follows_racon_tpu_walk(monkeypatch, value):
    """At every canonical tier, walk_fmt gives what the reference's gives
    on a real chip (a 128-aligned batch): "rows" or "rle" where its
    transposed sweeps run (W <= 1024) as RACON_TPU_WALK says, "rle" for
    "auto" or any other value, and "packed2" at W = 2048 and 4096."""
    if value is None:
        monkeypatch.delenv("RACON_TPU_WALK", raising=False)
    else:
        monkeypatch.setenv("RACON_TPU_WALK", value)
    for cap, w in CONSENSUS_TIERS + ALIGN_TIERS:
        want = "rows" if value == "rows" and w <= 1024 else (
            "rle" if w <= 1024 else "packed2")
        assert port.walk_fmt(w) == want, (cap, w)
        assert jax_nw_kernel.walk_fmt(cap, cap, w, False, 128) == want


def _rows_route_oracle(q4, t4, dcb, m, n, *, m_cap, n_cap, w_band, match,
                       mismatch, gap):
    """align_walk_rows_batch on the reference's jnp oracles (its Pallas
    kernels do not run on a CPU outside interpret mode): the sweep
    nw_band_batch_ref, which racon_tpu's tests hold bit-identical to the
    transposed kernels, then walk_rows_ref, walk_rows_t's twin."""
    B = q4.shape[0]
    q = unpack_codes4(jnp.asarray(q4), m_cap).astype(jnp.int32)
    t = unpack_codes4(jnp.asarray(t4), n_cap).astype(jnp.int32)
    dc = unpack_delbits(jnp.asarray(dcb), n_cap, gap)
    gc = jnp.pad(jnp.cumsum(dc, axis=1), ((0, 0), (1, 0)))
    moves, score = nw_band_batch_ref(q, t, gc, m_cap=m_cap, n_cap=n_cap,
                                     w_band=w_band, match=match,
                                     mismatch=mismatch, gap=gap)
    payload, _ = walk_rows_ref(jnp.transpose(moves[:B], (1, 2, 0)),
                               jnp.asarray(m), jnp.asarray(n), m_cap=m_cap,
                               n_cap=n_cap, w_band=w_band)
    return payload, score[:B]


def test_consensus_stage_rows_route_matches_jax_stage(monkeypatch):
    """The slice's consensus path: under RACON_TPU_WALK=rows the port's
    stage walks every tier with the rows walk and decodes the rows
    payload; the consensus equals the JAX stage's rows route byte for
    byte. That stage runs in interpret mode at the real tier shapes on one
    device (the rows route has no sharded interpret form), with walk_fmt
    answering as on a real chip and the rows dispatch on its jnp
    oracles."""
    monkeypatch.setenv("RACON_TPU_INTERPRET_FULLCAP", "1")
    monkeypatch.setenv("RACON_TPU_CONSENSUS_ROUTE", "device")
    monkeypatch.setenv("RACON_TPU_WALK", "rows")
    real_fmt = jax_nw_kernel.walk_fmt
    monkeypatch.setattr(
        jax_nw_kernel, "walk_fmt",
        lambda m_cap, n_cap, w_band, interpret, bp:
        real_fmt(m_cap, n_cap, w_band, False, 128))
    monkeypatch.setattr(jax_nw_kernel, "align_walk_rows_batch",
                        _rows_route_oracle)
    monkeypatch.setattr(jax_mesh, "active_mesh", lambda: None)
    calls = {"rows_walk_plain": 0, "rle_decode": 0}

    def count(name, fn):
        def wrapped(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return wrapped

    monkeypatch.setattr(port, "rows_walk_plain",
                        count("rows_walk_plain", port.rows_walk_plain))
    monkeypatch.setattr(
        port_stage.bindings, "opstream_rle_to_ops_batch",
        count("rle_decode", port_stage.bindings.opstream_rle_to_ops_batch))
    windows, _ = bench.build_workload(n_windows=8)
    cfg = PolisherConfig(num_threads=2, match=5, mismatch=-4, gap=-8)
    with contextlib.redirect_stderr(io.StringIO()):
        stage = port_stage.TorchConsensusStage(cfg, "cpu")
        got, got_pol = stage.consensus_windows(windows, cfg, Logger())
        want, want_pol = TpuConsensusStage(cfg, interpret=True) \
            .consensus_windows(windows, cfg, Logger())
    assert got == want
    assert got_pol == want_pol
    assert calls["rows_walk_plain"] > 0
    assert calls["rle_decode"] == 0
    assert stage.prof["device_items"] > 0

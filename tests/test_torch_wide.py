"""The wide consensus tier of the port (the W = 2048 sweep and the packed2
walk; their plain versions, on the CPU) against the JAX package: the
lane-major Pallas kernel nw_band_batch in interpret mode, its jnp oracle
nw_band_batch_ref with walk_moves_device, and the consensus stage as a
whole on a long-window case. Integer DP, so tolerance 0: moves, scores,
payload bytes, op lists and consensus bytes must be equal exactly."""

import contextlib
import io

import jax.numpy as jnp
import numpy as np
import torch

from racon_tpu.core.store import SequenceStore
from racon_tpu.core.windows import WINDOW_TYPE_TGS, WindowSet
from racon_tpu.native import bindings as jax_bindings
from racon_tpu.ops import nw_kernel as jax_nw_kernel
from racon_tpu.ops.consensus_stage_tpu import TpuConsensusStage
from racon_tpu.ops.nw_kernel import (align_walk_core, encode, nw_band_batch,
                                     nw_band_batch_ref, pack_codes4,
                                     pack_delbits, walk_moves_device,
                                     walk_steps)
from racon_tpu.utils.logger import Logger
from racon_tpu_torch.models.polish_model import PolisherConfig
from racon_tpu_torch.native import bindings
from racon_tpu_torch.ops import nw_kernel as port
from racon_tpu_torch.ops.batch import to_device
from racon_tpu_torch.ops.consensus_stage import TorchConsensusStage

torch.set_num_threads(2)
ACGT = np.frombuffer(b"ACGT", np.uint8)
PAD = 5
SCORES = dict(match=5, mismatch=-4, gap=-8)


def _items(rng, B, cap, drifts):
    """Code panels, per-column deletion costs (gap or 0: 30 % free
    columns) and lengths of B items: item b's query is its target with 2 %
    each of substitutions, insertions and deletions, then drifts[b] more
    deletions, so n - m is about drifts[b]; a drift of None is an all-PAD
    item."""
    q8 = np.full((B, cap), PAD, np.int8)
    t8 = np.full((B, cap), PAD, np.int8)
    dc8 = np.full((B, cap), SCORES["gap"], np.int8)
    m = np.zeros(B, np.int32)
    n = np.zeros(B, np.int32)
    for b, drift in enumerate(drifts):
        if drift is None:
            continue
        tl = int(rng.integers(cap * 7 // 8, cap))
        t = rng.choice(ACGT, tl)
        q = t[rng.random(tl) >= 0.02]
        ins = np.flatnonzero(rng.random(len(q)) < 0.02)
        q = np.insert(q, ins, rng.choice(ACGT, len(ins)))
        sub = rng.random(len(q)) < 0.02
        q[sub] = rng.choice(ACGT, int(sub.sum()))
        q = np.delete(q, rng.choice(len(q), drift, replace=False))[:cap]
        q8[b, : len(q)] = encode(q)
        t8[b, :tl] = encode(t)
        m[b], n[b] = len(q), tl
        dc8[b, :tl][rng.random(tl) < 0.3] = 0
    return q8, t8, dc8, m, n


def _port(q8, t8, dc8, m, n, cap, w):
    """The port's plain sweep and packed walk on the packed uplink."""
    b = to_device(pack_codes4(q8), pack_codes4(t8), pack_delbits(dc8), m, n,
                  m_cap=cap, n_cap=cap, device="cpu")
    geo = dict(m_cap=cap, n_cap=cap, w_band=w)
    moves, score = port.nw_sweep(b.q4, b.t4, b.dcb, **geo, **SCORES)
    payload = port.packed_walk(moves, b.m, b.n, **geo)
    return moves.numpy(), score.numpy(), payload.numpy()


def test_sweep_and_walk_match_lane_major_pallas_interpret():
    """K5 itself (interpret mode, one 16-item tile) at (256, 128), and J4
    on its moves."""
    rng = np.random.default_rng(3)
    cap, w, B = 256, 128, 16
    drifts = [int(d) for d in rng.integers(0, 40, B)]
    drifts[6] = None
    q8, t8, dc8, m, n = _items(rng, B, cap, drifts)
    moves, score, payload = _port(q8, t8, dc8, m, n, cap, w)
    gc = np.zeros((B, cap + 1), np.int32)
    gc[:, 1:] = np.cumsum(dc8.astype(np.int32), axis=1)
    want_mv, want_sc = nw_band_batch(
        jnp.asarray(q8, jnp.int32), jnp.asarray(t8, jnp.int32),
        jnp.asarray(gc), m_cap=cap, n_cap=cap, w_band=w, interpret=True,
        **SCORES)
    assert np.array_equal(moves, np.asarray(want_mv))
    assert np.array_equal(score, np.asarray(want_sc)[:, 0])
    S = walk_steps(cap, cap, w)
    codes, esc = walk_moves_device(want_mv, jnp.asarray(m), jnp.asarray(n),
                                   m_cap=cap, n_cap=cap, w_band=w,
                                   max_steps=S, packed=True)
    assert payload.shape == (B, S // 4 + 1)
    assert np.array_equal(payload[:, :-1], np.asarray(codes))
    assert np.array_equal(payload[:, -1], np.asarray(esc).astype(np.uint8))


def test_wide_tier_matches_jnp_oracle():
    """(10240, 2048), the tier K5 serves: drifts of 400-900, one item out
    of the band at its corner (escaped) and one all-PAD item. Payload
    bytes equal align_walk_core's with the jnp oracle, and the decoded op
    lists of the kept items equal the reference decoder's."""
    rng = np.random.default_rng(11)
    cap, w = 10240, 2048
    drifts = [400, 650, 900, 1200, None, 520]
    B = len(drifts)
    q8, t8, dc8, m, n = _items(rng, B, cap, drifts)
    _, score, payload = _port(q8, t8, dc8, m, n, cap, w)
    want, want_sc = align_walk_core(
        jnp.asarray(q8), jnp.asarray(t8), jnp.asarray(dc8), jnp.asarray(m),
        jnp.asarray(n), m_cap=cap, n_cap=cap, w_band=w,
        nw_fn=nw_band_batch_ref, **SCORES)
    want = np.asarray(want)
    assert np.array_equal(payload, want)
    assert np.array_equal(score, np.asarray(want_sc)[:, 0])
    assert payload[:, -1].tolist() == [0, 0, 0, 1, 0, 0]
    S = walk_steps(cap, cap, w)
    kept = payload[:, -1] == 0
    codes = np.ascontiguousarray(payload[kept, :-1])
    got_ops, got_off, got_cnt = bindings.opstream_packed_to_ops_batch(
        codes, S, m[kept], n[kept], 2)
    want_ops, want_off, want_cnt = jax_bindings.opstream_packed_to_ops_batch(
        np.ascontiguousarray(want[kept, :-1]), S, m[kept], n[kept], 2)
    assert np.array_equal(got_cnt, want_cnt)
    assert np.array_equal(got_off, want_off)
    assert (got_cnt[m[kept] > 0] > 0).all()  # the PAD item has no runs
    for o, c in zip(got_off, got_cnt):  # each item's runs (op, length)
        assert np.array_equal(got_ops[o : o + c], want_ops[o : o + c])


def _long_windows(seed=5, n_windows=1, window_len=10000, depth=8):
    """n_windows windows of window_len bp, each with `depth` layers: reads
    spanning the whole draft, 12 % error split (0.2, 0.5, 0.3) between
    insertions, deletions and substitutions (deletion-biased, as in
    nanopore reads), so a layer is ~3.6 % shorter than its window and many
    items need the W = 2048 band. Layers are assigned through the native
    aligner's breaking points, as bench.build_workload does."""
    rng = np.random.default_rng(seed)
    glen = n_windows * window_len
    true = rng.choice(ACGT, glen)
    draft = true.copy()
    subs = rng.choice(glen, glen // 100, replace=False)
    draft[subs] = rng.choice(ACGT, len(subs))
    reads = []
    for _ in range(depth):
        r = rng.random(glen)
        keep = r >= 0.06                                  # deletions
        sub = (r >= 0.06) & (r < 0.096)                   # substitutions
        ins = keep & (rng.random(glen) < 0.024)           # insertions
        base = true.copy()
        base[sub] = rng.choice(ACGT, int(sub.sum()))
        off = np.zeros(glen + 1, np.int64)
        np.cumsum(keep.astype(np.int64) + ins, out=off[1:])
        read = np.empty(int(off[-1]), np.uint8)
        read[off[:-1][keep]] = base[keep]
        read[off[:-1][ins] + 1] = rng.choice(ACGT, int(ins.sum()))
        reads.append(read)
    parts = [draft, *reads]
    data_off = np.zeros(len(parts) + 1, np.int64)
    np.cumsum([len(p) for p in parts], out=data_off[1:])
    store = SequenceStore([b"ctg"] + [b"r%d" % r for r in range(depth)],
                          np.concatenate(parts), data_off,
                          np.zeros(0, np.uint8),
                          np.zeros(len(parts) + 1, np.int64))
    windows = WindowSet(store, 1, window_len, WINDOW_TYPE_TGS)
    qoff = np.zeros(depth + 1, np.int64)
    np.cumsum([len(r) for r in reads], out=qoff[1:])
    toff = np.arange(depth + 1, dtype=np.int64) * glen
    qlen = np.diff(qoff)
    quads, quad_off, counts = jax_bindings.breaking_points_batch(
        np.concatenate(reads), qoff, np.tile(draft, depth), toff,
        np.zeros(depth, np.uint8), np.zeros(depth, np.int64), qlen, qlen,
        np.zeros(depth, np.int64), np.full(depth, glen, np.int64),
        window_len, 2)
    for r in range(depth):
        o = int(quad_off[r])
        windows.assign_overlap(quads[o : o + int(counts[r])], r + 1, 0,
                               False, 10.0)
    windows.freeze()
    return windows


def test_long_window_stage_matches_jax_stage(monkeypatch):
    """The slice as a whole: a -w 10000 window whose items land in the
    (10240, 2048) tier goes through the wide sweep and the packed walk; the
    consensus equals the JAX package's device stage (packed2 at every tier
    in interpret mode) byte for byte. There K5 runs as its jnp oracle
    nw_band_batch_ref, which racon_tpu's own tests hold bit-identical to
    the Pallas kernel (test_wide_tier_matches_jnp_oracle above does too):
    the interpreted Pallas kernel takes minutes at this shape on a CPU."""
    monkeypatch.setenv("RACON_TPU_INTERPRET_FULLCAP", "1")
    monkeypatch.setenv("RACON_TPU_CONSENSUS_ROUTE", "device")
    monkeypatch.setattr(
        jax_nw_kernel, "nw_band_batch",
        lambda *a, interpret=False, **k: nw_band_batch_ref(*a, **k))
    windows = _long_windows()
    cfg = PolisherConfig(backend="cuda", num_threads=2, match=5,
                         mismatch=-4, gap=-8, window_length=10000,
                         refine_passes=1)
    with contextlib.redirect_stderr(io.StringIO()):
        stage = TorchConsensusStage(cfg, "cpu")
        got, got_pol = stage.consensus_windows(windows, cfg, Logger())
        want, want_pol = TpuConsensusStage(cfg, interpret=True) \
            .consensus_windows(windows, cfg, Logger())
    assert any(p.get((10240, 2048)) for p in stage.tier_items)
    assert stage.prof["wide_host_items"] == 0
    assert got == want
    assert got_pol == want_pol
    assert all(len(c) > 9000 for c in got)

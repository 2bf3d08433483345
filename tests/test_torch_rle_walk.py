"""RLE traceback walk of the PyTorch port (its plain version, on the CPU)
against the JAX package's walk_moves_rle_t on the same move words (from
the jnp oracle nw_band_batch_ref): event bytes and escape flags equal,
byte for byte -- including the 16-rows-per-word run boundaries, the fused
second event, and the budget-overflow escape (the pattern of
tests/test_rle_walk.py)."""

import numpy as np
import pytest
import torch

from racon_tpu.native import bindings
from racon_tpu.ops.nw_kernel import (encode, nw_band_batch_ref, rle_events,
                                     walk_moves_rle_t)
from racon_tpu_torch.ops import nw_kernel as port

torch.set_num_threads(2)
M_CAP = N_CAP = 128
W = 64
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


def _moves(pairs, scores, del_costs=None):
    B = len(pairs)
    match, mismatch, gap = scores
    q = np.full((B, M_CAP), 5, np.int32)
    t = np.full((B, N_CAP), 5, np.int32)
    gc = np.zeros((B, N_CAP + 1), np.int32)
    m = np.zeros(B, np.int32)
    n = np.zeros(B, np.int32)
    for b, (qa, ta) in enumerate(pairs):
        q[b, : len(qa)] = encode(qa)
        t[b, : len(ta)] = encode(ta)
        m[b], n[b] = len(qa), len(ta)
        dc = np.full(N_CAP, gap, np.int32)
        if del_costs is not None:
            dc[: len(ta)] = del_costs[b]
        gc[b, 1:] = np.cumsum(dc)
    moves, _ = nw_band_batch_ref(q, t, gc, m_cap=M_CAP, n_cap=N_CAP,
                                 w_band=W, match=match, mismatch=mismatch,
                                 gap=gap)
    return np.array(moves)[:B], m, n


def _both(moves, m, n, max_events):
    want_ev, want_esc = walk_moves_rle_t(
        moves.transpose(1, 2, 0), m, n, m_cap=M_CAP, n_cap=N_CAP, w_band=W,
        max_events=max_events)
    got = port.rle_walk(torch.from_numpy(moves), torch.from_numpy(m),
                        torch.from_numpy(n), m_cap=M_CAP, n_cap=N_CAP,
                        w_band=W, max_events=max_events).numpy()
    assert got.shape == (len(m), max_events + 1)
    assert np.array_equal(got[:, :-1], np.asarray(want_ev))
    assert np.array_equal(got[:, -1] != 0, np.asarray(want_esc))
    return got


@pytest.mark.parametrize("scores", [(5, -4, -8), (0, -1, -1)])
def test_rle_payload_matches_reference(scores):
    rng = np.random.default_rng(17)
    pairs = []
    for _ in range(48):
        tlen = int(rng.integers(8, N_CAP))
        t = rng.choice(ACGT, tlen)
        pairs.append((_mutate(rng, t, int(rng.integers(0, tlen // 3 + 1)))
                      [:M_CAP], t))
    pairs.append((np.zeros(0, np.uint8), np.zeros(0, np.uint8)))  # empty
    moves, m, n = _moves(pairs, scores)
    got = _both(moves, m, n, rle_events(M_CAP, N_CAP, W))
    # the events decode to complete op lists for every item in the band
    ops, off, cnt = bindings.opstream_rle_to_ops_batch(
        np.ascontiguousarray(got[:, :-1]), got.shape[1] - 1, m, n, 2)
    assert (cnt[got[:, -1] == 0] > 0).sum() >= len(pairs) - 3


def test_rle_free_deletion_columns():
    """Zero-cost columns (refinement-pass candidates) make long deletion
    runs, LEFT events and fused run+indel pairs."""
    rng = np.random.default_rng(23)
    pairs, dels = [], []
    for _ in range(32):
        tlen = int(rng.integers(30, N_CAP))
        t = rng.choice(ACGT, tlen)
        dc = np.full(tlen, -8, np.int32)
        dc[rng.random(tlen) < 0.3] = 0
        pairs.append((_mutate(rng, t, int(rng.integers(0, 6)))[:M_CAP], t))
        dels.append(dc)
    moves, m, n = _moves(pairs, (5, -4, -8), dels)
    _both(moves, m, n, rle_events(M_CAP, N_CAP, W))


def test_rle_band_escape_and_budget_overflow():
    """Unrelated sequences overflow a small event budget and a half-length
    query leaves the band: both must flag escape exactly as the
    reference does, not emit a truncated stream."""
    rng = np.random.default_rng(5)
    t = rng.choice(ACGT, 100)
    pairs = [(rng.choice(ACGT, 100), t), (t[:40].copy(), t),
             (t.copy(), t)]
    moves, m, n = _moves(pairs, (0, -1, -1))
    got = _both(moves, m, n, 8)
    assert got[0, -1] == 1 and got[1, -1] == 1

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
from racon_tpu_torch.ops.geometry import RLE_LEFT, RLE_UP

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


# ----------------------------------------------- the kernel's staged design

def _staged_walk_model(moves, m, n, max_events):
    """Python model of kernels/csrc/rle_walk.cu at M_CAP, N_CAP, W: per
    block of rle_walk_items(E) items, a zeroed staging area holds the
    items' payload rows as they lie in global memory; each item's walk
    writes its event bytes (the fused second one only when taken) and its
    escape flag into its row; the warp copies the span out as whole
    16-byte words, each on a 16-byte boundary, and the bytes past the last
    one. Returns the payload, and asserts that every byte of it was
    written exactly once."""
    from racon_tpu_torch.ops import geometry

    B, E = len(m), max_events
    row = E + 1
    items = geometry.rle_walk_items(E)
    dlo = geometry.band_dlo(M_CAP, N_CAP, W)
    words = moves.astype(np.int64) & 0xFFFFFFFF
    gmem = np.zeros(B * row, np.uint8)
    writes = np.zeros_like(gmem, np.int64)
    for b0 in range(0, B, items):
        nb = min(items, B - b0)
        span = nb * row
        g0 = b0 * row                            # the span's offset
        stage = np.zeros(geometry.rle_walk_launch(B, E)[2], np.uint8)
        assert span <= len(stage) and g0 % 16 == 0
        for lane in range(nb):
            ev = lane * row                      # the item's staged row
            b = b0 + lane
            i, j, esc, s = int(m[b]), int(n[b]), False, 0
            while s + 1 < E and not (i == 0 and j == 0) and not esc:
                interior = i > 0 and j > 0
                r = max(i - 1, 0)
                k = j - i - dlo
                word = int(words[b, r >> 4, min(max(k, 0), W - 1)])
                p = r & 15
                mv = (word >> (2 * p)) & 3
                mv = 2 if i == 0 else (1 if j == 0 and i > 0 else mv)
                esc = interior and not (0 <= k < W and mv != 3)
                z = (word << (2 * (15 - p))) & 0xFFFFFFFF
                d = min((32 - z.bit_length() if z else 31) >> 1, p + 1)
                d = min(d, i, j) if interior and not esc else 0
                out = d or {1: RLE_UP, 2: RLE_LEFT}.get(mv, 0)
                di = d or int(mv == 1)
                dj = d or int(mv == 2)
                if esc:
                    out = di = dj = 0
                i1, j1 = i - di, j - dj
                p2 = p - d
                mv2 = (word >> (2 * max(p2, 0))) & 3
                mv2 = 2 if i1 == 0 else (1 if j1 == 0 and i1 > 0 else mv2)
                take2 = (not esc and d > 0 and not (i1 == 0 and j1 == 0)
                         and (not (i1 > 0 and j1 > 0)
                              or (p2 >= 0 and mv2 in (1, 2))))
                stage[ev + s] = out
                if take2:
                    stage[ev + s + 1] = RLE_UP if mv2 == 1 else RLE_LEFT
                i -= di + int(take2 and mv2 == 1)
                j -= dj + int(take2 and mv2 == 2)
                s += 2
            stage[ev + E] = int(esc or i != 0 or j != 0)
        body = span // 16
        copies = [range(16 * k, 16 * k + 16) for k in range(body)]
        copies.append(range(16 * body, span))                   # tail
        for c in copies:
            for x in c:
                gmem[g0 + x] = stage[x]
                writes[g0 + x] += 1
    assert (writes == 1).all()
    return gmem.reshape(B, row)


@pytest.mark.parametrize("max_events", [None, 8, 41, 200])
def test_staged_walk_model_matches_reference(max_events):
    """The kernel's staged payload: 49 items (a block of 32, then a ragged
    one of 17, whose span ends off a 16-byte boundary), E + 1 odd or
    even, the escape byte, budget overflows (E = 8) and the zero fill --
    byte for byte the JAX package's walk_moves_rle_t and the port's plain
    walk."""
    rng = np.random.default_rng(29)
    pairs = []
    for _ in range(48):
        tlen = int(rng.integers(8, N_CAP))
        t = rng.choice(ACGT, tlen)
        pairs.append((_mutate(rng, t, int(rng.integers(0, tlen // 3 + 1)))
                      [:M_CAP], t))
    pairs.append((np.zeros(0, np.uint8), np.zeros(0, np.uint8)))
    moves, m, n = _moves(pairs, (5, -4, -8))
    E = max_events or rle_events(M_CAP, N_CAP, W)
    want = _both(moves, m, n, E)
    assert np.array_equal(_staged_walk_model(moves, m, n, E), want)


def test_rle_walk_launch_geometry():
    """A warp of 32 items a block: B = 4096 on 128 blocks, 4097 on 129;
    every tier the RLE walk serves (the consensus tiers and the scored
    align route's, W <= 1024) within 227 KB of shared memory a block, the
    (40960,1024) tier at 16 items a block, and every block's payload span
    on a 16-byte boundary; the constants are the kernel's."""
    import re
    from pathlib import Path

    from racon_tpu_torch.ops import geometry
    from racon_tpu_torch.ops.align_stage import _TIERS as ALIGN
    from racon_tpu_torch.ops.consensus_stage import _TIERS as CONSENSUS

    E = geometry.rle_events(640, 640, 128)
    assert geometry.rle_walk_launch(4096, E) == (128, 32, 7200)
    assert geometry.rle_walk_launch(4097, E)[0] == 129
    for cap, w in (*CONSENSUS, *ALIGN):
        if w > 1024:
            continue
        E = geometry.rle_events(cap, cap, w)
        blocks, threads, smem = geometry.rle_walk_launch(4097, E)
        items = geometry.rle_walk_items(E)
        assert items == (16 if (cap, w) == (40960, 1024) else 32)
        assert blocks == -(-4097 // items) and threads == 32
        # a block's span starts on a 16-byte boundary
        assert items * (E + 1) % 16 == 0
        assert items * (E + 1) <= smem <= geometry.SMEM_BLOCK_MAX
    src = (Path(geometry.__file__).parents[1] / "kernels" / "csrc"
           / "rle_walk.cu").read_text()
    assert int(re.search(r"kWalkItems = (\d+);", src).group(1)) \
        == geometry.RLE_WALK_ITEMS
    assert re.search(r"kMaxStage = 227 \* 1024;", src) \
        and geometry.SMEM_BLOCK_MAX == 227 * 1024

"""The port's host walk over packed move planes (ops/nw_walk.walk_moves)
against racon_tpu's (racon_tpu/ops/nw_walk.py), on the move planes of the
port's plain sweep at the consensus tiers (640,128) and (5120,1024): the
same op lists, the same refusal where a path leaves the band; and against
the op lists that the port's RLE walk and its native decoder give for the
same planes, wherever that walk does not escape. Move planes that no
sweep would give (a path off the band, an invalid move) are refused by
both walks."""

import numpy as np
import pytest
import torch

from racon_tpu.ops.nw_walk import walk_moves as jax_walk_moves
from racon_tpu_torch.native import bindings
from racon_tpu_torch.ops import nw_kernel
from racon_tpu_torch.ops.batch import to_device
from racon_tpu_torch.ops.geometry import PAD_CODE, encode, rle_events
from racon_tpu_torch.ops.nw_walk import walk_moves

torch.set_num_threads(2)
ACGT = np.frombuffer(b"ACGT", np.uint8)


def _items(rng, B, cap, w_band):
    """B mutated read pairs at cap (4 % each of substitutions, insertions
    and deletions; 30 % free deletion columns), item 1 all PAD and item 2
    cut short by the band's width, so its path leaves the band."""
    q8 = np.full((B, cap), PAD_CODE, np.uint8)
    t8 = np.full((B, cap), PAD_CODE, np.uint8)
    dc = np.zeros((B, cap), np.uint8)
    m = np.zeros(B, np.int32)
    n = np.zeros(B, np.int32)
    for b in range(B):
        if b == 1:
            continue
        tl = int(rng.integers(cap // 2, cap))
        t = rng.choice(ACGT, tl)
        q = t[rng.random(tl) > 0.04]
        ins = np.flatnonzero(rng.random(len(q)) < 0.04)
        q = np.insert(q, ins, rng.choice(ACGT, len(ins)))
        sub = rng.random(len(q)) < 0.04
        q[sub] = rng.choice(ACGT, int(sub.sum()))
        if b == 2:
            q = q[: len(q) - 2 * w_band]
        q = q[:cap]
        q8[b, : len(q)] = encode(q)
        t8[b, :tl] = encode(t)
        m[b], n[b] = len(q), tl
        dc[b, :tl] = rng.random(tl) >= 0.3
    q4 = q8[:, 0::2] | (q8[:, 1::2] << 4)
    t4 = t8[:, 0::2] | (t8[:, 1::2] << 4)
    dcb = np.packbits(dc != 0, axis=1, bitorder="little")
    return q4, t4, dcb, m, n


@pytest.mark.parametrize("cap,w_band,B", [(640, 128, 24), (5120, 1024, 4)])
def test_walk_moves_matches_racon_tpu_and_rle_decoder(cap, w_band, B):
    rng = np.random.default_rng(cap)
    q4, t4, dcb, m, n = _items(rng, B, cap, w_band)
    geo = dict(m_cap=cap, n_cap=cap, w_band=w_band)
    batch = to_device(q4, t4, dcb, m, n, m_cap=cap, n_cap=cap, device="cpu")
    moves, _ = nw_kernel.nw_sweep_plain(batch.q4, batch.t4, batch.dcb,
                                        **geo, match=5, mismatch=-4, gap=-8)
    payload = nw_kernel.rle_walk_plain(moves, batch.m, batch.n,
                                       **geo).numpy()
    events = rle_events(cap, cap, w_band)
    ops, off, counts = bindings.opstream_rle_to_ops_batch(
        np.ascontiguousarray(payload[:, :-1]), events, m.astype(np.int64),
        n.astype(np.int64), 2)
    moves = moves.numpy()
    walked = 0
    for b in range(B):
        args = (moves[b], int(m[b]), int(n[b]), cap, cap, w_band)
        got = walk_moves(*args)
        want = jax_walk_moves(*args)
        assert got.dtype == np.int32 and np.array_equal(got, want)
        if payload[b, -1] == 0:
            o = int(off[b])
            assert np.array_equal(got, ops[o : o + int(counts[b])])
            walked += 1
    # the all-PAD item walks to an empty list, the cut item escapes the
    # RLE walk, and every other item is held against the decoder
    assert walk_moves(moves[1], 0, 0, cap, cap, w_band).shape == (0, 2)
    assert payload[2, -1] != 0
    assert walked == B - 1


@pytest.mark.parametrize("move,error", [(2, "left the band"),
                                        (3, "invalid move")])
def test_walk_moves_refuses_what_no_sweep_gives(move, error):
    """All-LEFT planes walk off the band's left edge; planes of the
    invalid code 3 stop at the first cell."""
    cap, w_band = 640, 128
    word = sum(move << (2 * r) for r in range(16))
    moves = np.full((cap // 16, w_band), word - (1 << 32) * (word >> 31),
                    np.int32)
    args = (moves, cap, cap, cap, cap, w_band)
    with pytest.raises(AssertionError):
        jax_walk_moves(*args)
    with pytest.raises(ValueError, match=error):
        walk_moves(*args)

"""The Myers plane-to-move transform (J5) and the "rle" Myers payload of
the PyTorch port (plain versions, on the CPU) against the JAX package:

- myers_moves_plain equals racon_tpu's myers_moves_from_planes on the
  planes of myers_sweep_ref (relaid to the port's (B, m_cap, 2, nw)), at
  every cell, at (256,128) and (1024,256); a numpy model of
  kernels/csrc/myers_moves.cu (each warp's 32 plane words, the five-step
  shuffle transpose, the codes and the row/column mask) equals it;
- align_walk_myers_padded(fmt="rle", device="cpu") gives racon_tpu's
  align_walk_myers_rle_batch(interpret=True) payload byte for byte, and
  its decoded op lists equal the rows route's for every item that
  neither escapes; on a mesh the payload stays "rows".
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from racon_tpu.ops.myers_kernel import (align_walk_myers_rle_batch,
                                        build_peq_T, myers_moves_from_planes,
                                        myers_sweep_ref, sweep_rows_g)
from racon_tpu.ops.nw_kernel import B_LANE
from racon_tpu_torch.ops import myers_kernel as mk
from racon_tpu_torch.ops.geometry import PAD_CODE, band_dlo, encode
from racon_tpu_torch.ops.nw_kernel import payload_decoder
from racon_tpu_torch.parallel import mesh

torch.set_num_threads(2)
ACGT = np.frombuffer(b"ACGT", np.uint8)
_M32 = 0xFFFFFFFF


def _items(seed, B, cap, w):
    """B read pairs at cap: 2-25 % edits, item 3 cut by more than half
    the band (an escape), item 6 all PAD; (q8, t8, m, n)."""
    rng = np.random.default_rng(seed)
    q8 = np.full((B, cap), PAD_CODE, np.uint8)
    t8 = np.full((B, cap), PAD_CODE, np.uint8)
    m = np.zeros(B, np.int32)
    n = np.zeros(B, np.int32)
    for b in range(B):
        if b == 6:
            continue
        tl = int(rng.integers(cap // 2, cap))
        t = rng.choice(ACGT, tl)
        rate = (0.02, 0.1, 0.25)[b % 3]
        q = t[rng.random(tl) > rate / 3]
        ins = np.flatnonzero(rng.random(len(q)) < rate / 3)
        q = np.insert(q, ins, rng.choice(ACGT, len(ins)))
        sub = rng.random(len(q)) < rate / 3
        q[sub] = rng.choice(ACGT, int(sub.sum()))
        if b == 3:
            q = q[: len(q) - w]
        q = q[:cap]
        q8[b, : len(q)] = encode(q)
        t8[b, :tl] = encode(t)
        m[b], n[b] = len(q), tl
    return q8, t8, m, n


def _pack(x8):
    return x8[:, 0::2] | (x8[:, 1::2] << 4)


def _ref_planes(q8, t8, cap, w):
    """myers_sweep_ref's planes, (m_cap, 2, nw, B)."""
    tT = jnp.asarray(t8.astype(np.int32).T)
    return np.asarray(myers_sweep_ref(jnp.asarray(q8.astype(np.int32).T),
                                      build_peq_T(tT, cap, w), m_cap=cap,
                                      n_cap=cap, w_band=w))


def _kernel_model(planes, m, *, m_cap, n_cap, w_band):
    """numpy model of myers_moves.cu: a warp per (item, 16-row group,
    word); lane j loads row 16g + (j >> 1), plane j & 1; the shuffle
    transpose (lane j takes lane j ^ s's word at steps s = 16 .. 1);
    then lane t's codes and mask for band lane 32w + t."""
    B, _, _, nw = planes.shape
    G = m_cap // 16
    W = w_band
    words = (planes.astype(np.int64) & _M32).reshape(B, G, 16, 2, nw)
    x = words.transpose(0, 1, 4, 2, 3).reshape(B, G, nw, 32)  # lane j
    lane = np.arange(32)
    for s, mk_ in ((16, 0x0000FFFF), (8, 0x00FF00FF), (4, 0x0F0F0F0F),
                   (2, 0x33333333), (1, 0x55555555)):
        y = x[..., lane ^ s]
        hi = (lane & s) != 0
        x = np.where(hi, (x & ~mk_ & _M32) | ((y >> s) & mk_),
                     (x & mk_) | (((y & mk_) << s) & _M32))
    nd = ~x & 0x55555555
    up = (x >> 1) & 0x55555555
    code = (nd & up) | ((nd & ~up & _M32) << 1)
    k = 32 * np.arange(nw)[:, None] + lane                # (nw, 32)
    g = np.arange(G)[:, None, None]
    j0 = 16 * g + 1 + band_dlo(m_cap, n_cap, W) + k       # (G, nw, 32)
    rlo = np.maximum(0, 1 - j0)
    rhi = np.minimum(np.minimum(15, n_cap - j0),
                     np.asarray(m, np.int64)[:, None, None, None]
                     - (16 * g + 1))

    def below(r):
        return np.where(r >= 16, _M32, (1 << (2 * np.clip(r, 0, 15))) - 1)

    valid = np.where(rlo > rhi, 0, below(rhi + 1) & ~below(rlo) & _M32)
    out = (code | (~valid & _M32)).reshape(B, G, W)
    return np.where(out >= 2 ** 31, out - 2 ** 32, out).astype(np.int32)


@pytest.mark.parametrize("cap,w,B", [(256, 128, 12), (1024, 256, 7)])
def test_myers_moves_plain_matches_jax(cap, w, B):
    q8, t8, m, n = _items(cap + w, B, cap, w)
    planes = _ref_planes(q8, t8, cap, w)
    rg = sweep_rows_g(cap, w)
    want = np.asarray(myers_moves_from_planes(
        planes.reshape(cap // rg, rg * 2 * (w // 32), B), m, m_cap=cap,
        n_cap=cap, w_band=w))                              # (cap/16, W, B)
    port_planes = np.ascontiguousarray(planes.transpose(3, 0, 1, 2))
    geo = dict(m_cap=cap, n_cap=cap, w_band=w)
    got = mk.myers_moves(torch.from_numpy(port_planes), torch.from_numpy(m),
                         **geo)
    assert got.dtype == torch.int32 and got.shape == (B, cap // 16, w)
    assert np.array_equal(got.numpy(), want.transpose(2, 0, 1))
    # a smaller row chunk of the plain version, and the kernel's model
    assert torch.equal(mk.myers_moves_plain(
        torch.from_numpy(port_planes), torch.from_numpy(m), **geo, rows=32),
        got)
    assert np.array_equal(_kernel_model(port_planes, m, **geo), got.numpy())


def _ops(fmt, payload, cap, w, m, n):
    decode, codes, budget = payload_decoder(fmt, payload, cap, w)
    ops, off, cnt = decode(codes, budget, m.astype(np.int64),
                           n.astype(np.int64), 2)
    return [ops[int(o) : int(o) + int(c)] for o, c in zip(off, cnt)]


def test_myers_rle_payload_matches_jax_and_rows_route():
    cap, w, B = 256, 128, 24
    q8, t8, m, n = _items(5, B, cap, w)
    q4, t4 = _pack(q8), _pack(t8)
    geo = dict(m_cap=cap, n_cap=cap, w_band=w, device="cpu")
    payload, score, fmt = mk.align_walk_myers_padded(q4, t4, m, n, **geo,
                                                     fmt="rle")
    assert fmt == "rle" and not score.any()
    # the reference's transposed kernels take B_LANE items: pad with PAD
    pad = ((0, B_LANE - B), (0, 0))
    jp, _ = align_walk_myers_rle_batch(
        np.pad(q4, pad, constant_values=0x55),
        np.pad(t4, pad, constant_values=0x55), np.pad(m, pad[0]),
        np.pad(n, pad[0]), m_cap=cap, n_cap=cap, w_band=w, interpret=True)
    assert np.array_equal(payload.numpy(), np.asarray(jp)[:B])

    rows, _, rows_fmt = mk.align_walk_myers_padded(q4, t4, m, n, **geo)
    assert rows_fmt == "rows"
    esc_rle = payload[:, -1].numpy() != 0
    esc_rows = rows[:, -1].numpy() != 0
    assert esc_rle[3] and esc_rows[3]  # the item cut short escapes both
    got = _ops("rle", payload.numpy(), cap, w, m, n)
    want = _ops("rows", rows.numpy(), cap, w, m, n)
    checked = [b for b in range(B) if not (esc_rle[b] or esc_rows[b])]
    assert len(checked) >= B - 3
    for b in checked:
        assert np.array_equal(got[b], want[b]), b

    # on a mesh the payload stays "rows", as the reference's does
    mesh.set_active_mesh(["cpu", "cpu"])
    try:
        shards, _, mesh_fmt = mk.align_walk_myers_padded(q4, t4, m, n,
                                                         **geo, fmt="rle")
    finally:
        mesh.clear_active_mesh()
    assert mesh_fmt == "rows"
    assert torch.equal(torch.cat(shards), rows)

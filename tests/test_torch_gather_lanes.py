"""A numpy model of the row gather's lanes (J6, kernels/csrc/pack_gather.cu)
on the CPU, where the kernel cannot run:

- the unit rule (geometry.gather_units, mirrored from rtt_pack_gather):
  a warp is one unit of an item's row segments, grouped as "row", "pair"
  or "item"; one wave at the consensus stage's (640,128) B = 4096, more
  than 8 warps at (5120,1024) B = 8;
- the lane scheme: the meta row loaded by lanes 0-3 and broadcast, lane
  l's loads s + w0 + l + 32 j, the high neighbour from lane l + 1 by
  shuffle, lane 31's from lane 0's next word, the fill past m or n;
- every output word written exactly once, every blob word of a row that
  the row needs loaded once (twice only where a segment boundary falls
  inside the row), none past the row or the blob;
- bytes equal to pack_gather_plain, and to racon_tpu's _gather_nib_cols /
  _gather_bit_cols on the same blobs, at every start offset mod 8 and mod
  32, lengths 0, 1, 7, 8, 9, 31, 32, 33 and cap, rows ending at a blob's
  last element, every tier cap, m_cap = 40 and 264 and unequal caps;
- the wrapper's one output buffer (gather.out_layout).
"""

import jax
import numpy as np
import pytest
import torch

from racon_tpu.ops.nw_kernel import _gather_bit_cols, _gather_nib_cols
from racon_tpu_torch.ops import gather
from racon_tpu_torch.ops.geometry import (GATHER_LANE_WORDS, GATHER_MODES,
                                          GATHER_SMS, PAD_CODE,
                                          gather_mode, gather_units)

M32 = 0xFFFFFFFF
U = np.uint64
KJ = GATHER_LANE_WORDS
LANE = np.arange(32)
EDGE_LENGTHS = (0, 1, 7, 8, 9, 31, 32, 33)
CAPS = [(256, 256), (640, 640), (1280, 1280), (2560, 2560), (5120, 5120),
        (10240, 10240), (40, 64), (264, 288), (2560, 640)]


def _unit_segments(B, m_cap, n_cap, mode, J):
    """Per unit (b, r), u = b * upi + r: its item and the segment
    of each row it holds (-1: none), as pack_gather_kernel decodes them."""
    mode = mode or gather_mode(m_cap, n_cap, B)
    S, sq, st, upi, _ = gather_units(m_cap, n_cap, B, mode, J)
    u = np.arange(B * upi)
    b, r = u // upi, u % upi
    none = np.full_like(u, -1)
    if mode == "item":
        kq = np.where(r < sq, r, -1)
        kt = kd = np.where(r < st, r, -1)
    elif mode == "pair":
        kq = np.where(r < sq, r, -1)
        kt = kd = np.where(r >= sq, r - sq, -1)
    else:
        kq = np.where(r < sq, r, -1)
        kt = np.where((r >= sq) & (r < sq + st), r - sq, none)
        kd = np.where(r >= sq + st, r - sq - st, none)
    return S, b, {"q": kq, "t": kt, "d": kd}


def _lane_model(words, start, length, k, seg, row_words, per_word):
    """One row segment a unit, all lanes at once: (unit, lane, j) loads,
    then the outputs each lane stores. Returns (stores: (unit, lane, j)
    output word or -1, values, loads: (unit, lane, j+1) relative word or
    -1)."""
    w32 = words.view(np.uint32).astype(np.uint64)
    shift = 3 if per_word == 8 else 5
    s = start >> shift
    sh = (start & (per_word - 1)) * (32 // per_word)
    last = np.where(length > 0, ((start + length - 1) >> shift) - s, -1)
    w0 = k * seg
    w1 = np.minimum(w0 + seg, row_words)
    # loads: lane l, slot j = 0 .. J (J lane words: the kernel's template
    # argument; the bit row's segments one), the words the row needs up to
    # w1 inside the blob
    J = -(-seg // 32)
    w = w0[:, None, None] + LANE[None, :, None] + 32 * np.arange(J + 1)
    top = np.minimum(w1, last)[:, None, None]
    idx = s[:, None, None] + w
    take = (w <= top) & (idx < len(w32))
    lo = np.where(take, w32[np.where(take, idx, 0)], U(0))
    loads = np.where(take, w, -1)
    # shuffles: lane l takes lane l + 1's word, lane 31 lane 0's next one
    give = np.where(LANE[None, :, None] == 0, lo[:, :, 1:], lo[:, :, :-1])
    hi = give[:, (LANE + 1) % 32, :]
    v = ((hi << U(32) | lo[:, :, :-1])
         >> sh.astype(np.uint64)[:, None, None]) & U(M32)
    wout = w[:, :, :-1]
    rel = length[:, None, None] - per_word * wout
    fill = U(0x55555555 if per_word == 8 else M32)
    keep = (U(1) << np.clip((32 // per_word) * rel, 0, 32).astype(
        np.uint64)) - U(1)
    v = np.where(rel <= 0, fill, (v & keep) | (fill & ~keep))
    stores = np.where(wout < w1[:, None, None], wout, -1)
    return stores, v, loads, last, s


def _model(words, meta, m_cap, n_cap, mode=None, J=None):
    """The three outputs the kernel writes under `mode` (and J lane words
    a segment, the rule's by default), and checks of every store and load
    on the way."""
    B = len(meta)
    S, b, ks = _unit_segments(B, m_cap, n_cap, mode, J)
    # lanes 0-3 load the meta row, every lane takes the four fields
    mv = np.where(LANE[None, :] < 4, meta[b][:, np.minimum(LANE, 3)], 0)
    fields = mv[:, :4]
    rows = {"q": (words[0], 0, m_cap // 8, 8, S),
            "t": (words[1], 2, n_cap // 8, 8, S),
            "d": (words[2], 2, n_cap // 32, 32, S // 4)}
    out = []
    for name, (blob, f, row_words, per_word, seg) in rows.items():
        k = ks[name]
        on = k >= 0
        start, length = fields[on, f], fields[on, f + 1]
        stores, v, loads, last, s = _lane_model(
            blob, start.astype(np.int64), length.astype(np.int64), k[on],
            seg, row_words, per_word)
        item = np.broadcast_to(b[on][:, None, None], stores.shape)
        got = np.zeros((B, row_words), np.uint64)
        count = np.zeros((B, row_words), np.int64)
        hit = stores >= 0
        np.add.at(count, (item[hit], stores[hit]), 1)
        got[item[hit], stores[hit]] = v[hit]
        assert (count == 1).all(), f"{mode} {name}: an output word not " \
            "written exactly once"
        # loads: each word 0 .. last of the row that lies in the blob,
        # once, and once more at each segment boundary inside the row
        nl = np.zeros((B, row_words + 2), np.int64)
        item = np.broadcast_to(b[on][:, None, None], loads.shape)
        hit = loads >= 0
        np.add.at(nl, (item[hit], loads[hit]), 1)
        r = np.arange(row_words + 2)
        lastb = np.full(B, -1)
        lastb[b[on]] = last
        sb = np.zeros(B, np.int64)
        sb[b[on]] = s
        need = (r[None, :] <= lastb[:, None]) \
            & (sb[:, None] + r[None, :] < len(blob))
        boundary = (r % seg == 0) & (r > 0) & (r < row_words)
        assert np.array_equal(nl, need * (1 + boundary[None, :])), \
            f"{mode} {name}: a blob word loaded other than once"
        out.append(got.astype(np.uint32).view(np.uint8).reshape(B, -1))
    return out


def _edge_case(rng, m_cap, n_cap):
    """Word blobs and meta rows: every (length, start mod 32) of the query
    and of the target row, lengths EDGE_LENGTHS and the cap, and rows that
    end at each blob's last element (a blob a whole number of bit words
    long, the other not)."""
    ql = [x for x in EDGE_LENGTHS if x < m_cap] + [m_cap]
    tl = [x for x in EDGE_LENGTHS if x < n_cap] + [n_cap]
    cap = max(m_cap, n_cap)
    Lq, Lt = 4 * cap + 256, 4 * cap + 256 + 5
    B = 32 * max(len(ql), len(tl))
    b = np.arange(B)
    qlen = np.array(ql)[b % len(ql)]
    tlen = np.array(tl)[(b // 32) % len(tl)]
    qs = 32 * rng.integers(0, (Lq - m_cap) // 32 - 1, B) + (b // len(ql)) % 32
    ts = 32 * rng.integers(0, (Lt - n_cap) // 32 - 1, B) + b % 32
    # rows ending at the blobs' last elements
    for i, x in enumerate((m_cap, 1, 33 % m_cap or 1)):
        qlen[i], qs[i] = x, Lq - x
    for i, x in enumerate((n_cap, 1, 33)):
        tlen[3 + i], ts[3 + i] = x, Lt - x
    q8 = rng.integers(0, 5, Lq).astype(np.int8)
    t8 = rng.integers(0, 5, Lt).astype(np.int8)
    dmask = rng.random(Lt) >= 0.3
    meta = np.stack([qs, qlen, ts, tlen], 1).astype(np.int32)
    gather.check_meta(meta, (Lq + 7) // 8, (Lt + 7) // 8, m_cap=m_cap,
                      n_cap=n_cap)
    return (gather.code_words(q8), gather.code_words(t8),
            gather.bit_words(dmask)), meta


def _jax_gathers(m_cap, n_cap):
    """racon_tpu's word-wise row gathers of the three rows, under one jit
    (op by op they take seconds to trace at each shape)."""
    def run(qw, tw, dw, meta):
        qs, m, ts, n = (meta[:, c] for c in range(4))
        return (_gather_nib_cols(qw, qs, m, m_cap, 0, PAD_CODE),
                _gather_nib_cols(tw, ts, n, n_cap, 0, PAD_CODE),
                _gather_bit_cols(dw, ts, n, n_cap, 1))
    return jax.jit(run)


def _pack_nib(c8):
    return (c8[:, 0::2] | (c8[:, 1::2] << 4)).astype(np.uint8)


@pytest.mark.parametrize("m_cap,n_cap", CAPS)
def test_lane_model_matches_plain_and_jax(m_cap, n_cap):
    rng = np.random.default_rng(m_cap * 7 + n_cap)
    words, meta = _edge_case(rng, m_cap, n_cap)
    plain = [x.numpy() for x in gather.pack_gather_plain(
        *(torch.from_numpy(x) for x in (*words, meta)), m_cap=m_cap,
        n_cap=n_cap)]
    # every grouping at the rule's J, and every J the rows take grouped
    # as the rule groups them
    longer = max(m_cap, n_cap) // 8
    cases = [(mode, None) for mode in GATHER_MODES] + [
        (None, J) for J in range(1, min(KJ, -(-longer // 32)) + 1)]
    for mode, J in cases:
        got = _model(words, meta, m_cap, n_cap, mode, J)
        for part, g, p in zip(("q4", "t4", "dcb"), got, plain):
            assert np.array_equal(g, p), (mode, J, part)
    # racon_tpu's word-wise gathers on the same blobs
    qT, tT, dT = (np.asarray(x) for x in _jax_gathers(m_cap, n_cap)(
        *words, meta))
    assert np.array_equal(plain[0], _pack_nib(qT.T.astype(np.uint8)))
    assert np.array_equal(plain[1], _pack_nib(tT.T.astype(np.uint8)))
    assert np.array_equal(plain[2], np.packbits(dT.T != 0, axis=1,
                                                bitorder="little"))


@pytest.mark.parametrize("m_cap,n_cap,B,mode,S,units,warps", [
    (640, 640, 4096, "item", 96, 4096, 8),   # one wave: 31 warps an SM
    (256, 256, 4097, "item", 32, 4097, 8),
    (5120, 5120, 8, "pair", 32, 320, 2),     # one lane word: 320 warps
    (10240, 10240, 409, "item", 128, 4090, 8),
    (40, 64, 1, "pair", 32, 2, 1),
    (2560, 640, 100, "pair", 32, 1300, 8),
    (2560, 640, 600, "item", 128, 1800, 8),
])
def test_unit_rule(m_cap, n_cap, B, mode, S, units, warps):
    assert gather_mode(m_cap, n_cap, B) == mode
    seg, sq, st, upi, wpb = gather_units(m_cap, n_cap, B)
    assert (seg, B * upi, wpb) == (S, units, warps)
    assert S % 32 == 0 and S <= 32 * KJ
    # every row whole in its segments, the bit row in as many
    assert sq * S >= m_cap // 8 and st * S >= n_cap // 8
    assert st * (S // 4) >= n_cap // 32
    # the most warps a block (a power of two up to 8) that still fill
    # GATHER_SMS blocks
    assert wpb == 1 or B * upi >= wpb * GATHER_SMS
    assert wpb == 8 or B * upi < 2 * wpb * GATHER_SMS


@pytest.mark.parametrize("B,m_cap,n_cap", [(0, 640, 640), (1, 40, 64),
                                           (4097, 264, 288),
                                           (8, 5120, 5120)])
def test_out_layout(B, m_cap, n_cap):
    offsets, widths, nbytes = gather.out_layout(B, m_cap, n_cap)
    assert widths == (m_cap // 2, n_cap // 2, n_cap // 8)
    ends = [o + B * w for o, w in zip(offsets, widths)]
    assert all(o % gather.OUT_ALIGN == 0 for o in offsets)
    assert offsets[0] == 0 and ends[0] <= offsets[1] and ends[1] <= offsets[2]
    assert ends[2] <= nbytes < ends[2] + gather.OUT_ALIGN

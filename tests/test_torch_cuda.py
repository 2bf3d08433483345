"""The port's CUDA kernels against their plain PyTorch versions, and the
cuda backend end to end against device="cpu". Needs an NVIDIA GPU (sm_90a
build): marked `cuda` and skipped without one. On a GPU machine:

    python -m pytest tests/test_torch_cuda.py -m cuda

This file imports no jax, so it also runs where jax is not installed.
"""

import contextlib
import io

import numpy as np
import pytest
import torch

from racon_tpu_torch.kernels import LAUNCHES
from racon_tpu_torch.ops import myers_kernel as mk
from racon_tpu_torch.ops import nw_kernel as nk
from racon_tpu_torch.ops.batch import to_device
from racon_tpu_torch.ops.geometry import encode, sweep_kernel

pytestmark = pytest.mark.cuda
ACGT = np.frombuffer(b"ACGT", np.uint8)


@pytest.fixture
def gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _packed(seed, B, cap, drift):
    rng = np.random.default_rng(seed)
    q8 = np.full((B, cap), 5, np.uint8)
    t8 = np.full((B, cap), 5, np.uint8)
    m = np.zeros(B, np.int32)
    n = np.zeros(B, np.int32)
    for b in range(B):
        if b % 7 == 6:
            continue  # all-PAD item
        tl = int(rng.integers(cap // 2, cap))
        t = rng.choice(ACGT, tl)
        q = t[rng.random(tl) > 0.05]
        q = q[: len(q) - (drift if b % 5 == 2 else 0)]
        q8[b, : len(q)] = encode(q)
        t8[b, :tl] = encode(t)
        m[b], n[b] = len(q), tl
    dc = rng.random((B, cap)) >= 0.3
    return (q8[:, 0::2] | (q8[:, 1::2] << 4), t8[:, 0::2] | (t8[:, 1::2] << 4),
            np.packbits(dc, axis=1, bitorder="little"), m, n)


@pytest.mark.parametrize("cap,w,B", [(256, 128, 4097), (640, 128, 4097),
                                     (1280, 256, 4097), (1280, 512, 96)])
def test_sweep_and_rle_walk_match_plain(gpu, cap, w, B):
    """K1's tiers on the warp kernel (W <= 256; B = 4097 leaves the last
    block one warp), and W = 512 on the block kernel, with _packed's
    all-PAD and out-of-band items."""
    q4, t4, dcb, m, n = _packed(cap + w, B, cap, w)
    geo = dict(m_cap=cap, n_cap=cap, w_band=w)
    sc = dict(match=5, mismatch=-4, gap=-8)
    g = to_device(q4, t4, dcb, m, n, m_cap=cap, n_cap=cap, device=gpu)
    c = to_device(q4, t4, dcb, m, n, m_cap=cap, n_cap=cap, device="cpu")
    sweep = sweep_kernel(w)
    assert sweep == ("nw_sweep" if w <= 256 else "nw_sweep_block")
    before = dict(LAUNCHES)
    moves, score = nk.nw_sweep(g.q4, g.t4, g.dcb, **geo, **sc)
    payload = nk.rle_walk(moves, g.m, g.n, **geo)
    torch.cuda.synchronize()
    assert LAUNCHES[sweep] == before[sweep] + 1
    assert LAUNCHES["rle_walk"] == before["rle_walk"] + 1
    pm, ps = nk.nw_sweep_plain(c.q4, c.t4, c.dcb, **geo, **sc)
    assert torch.equal(moves.cpu(), pm) and torch.equal(score.cpu(), ps)
    assert torch.equal(payload.cpu(), nk.rle_walk_plain(pm, c.m, c.n, **geo))


@pytest.mark.parametrize("cap,w,B,scores", [
    (1280, 384, 97, (5, -4, -8)), (1024, 288, 41, (5, -4, -8)),
    (2560, 1024, 33, (0, -1, -1)), (2560, 1024, 31, (3, -5, -4)),
    (5120, 2048, 13, (5, -4, -8)), (10240, 4096, 5, (0, -1, -1))])
def test_strip_sweep_matches_plain(gpu, cap, w, B, scores):
    """The strip kernel (W > 256) on ragged batches, byte for byte against
    the plain version, with _packed's all-PAD and out-of-band items: W =
    384 (three strips), 288 (its last strip cut to one thread in four),
    1024, 2048 and 4096; the align scores with every deletion bit set.
    Each launch counts once, as nw_sweep_block or nw_sweep_wide."""
    q4, t4, dcb, m, n = _packed(cap + w + 3, B, cap, w // 2)
    if scores == (0, -1, -1):
        dcb[:] = 0xFF
    geo = dict(m_cap=cap, n_cap=cap, w_band=w)
    sc = dict(zip(("match", "mismatch", "gap"), scores))
    g = to_device(q4, t4, dcb, m, n, m_cap=cap, n_cap=cap, device=gpu)
    c = to_device(q4, t4, dcb, m, n, m_cap=cap, n_cap=cap, device="cpu")
    sweep = sweep_kernel(w)
    assert sweep == ("nw_sweep_block" if w <= 1024 else "nw_sweep_wide")
    before = dict(LAUNCHES)
    moves, score = nk.nw_sweep(g.q4, g.t4, g.dcb, **geo, **sc)
    torch.cuda.synchronize()
    assert LAUNCHES[sweep] == before[sweep] + 1
    pm, ps = nk.nw_sweep_plain(c.q4, c.t4, c.dcb, **geo, **sc)
    assert torch.equal(moves.cpu(), pm) and torch.equal(score.cpu(), ps)


@pytest.mark.parametrize("cap,w,B,scores", [
    (256, 128, 4097, (5, -4, -8)), (640, 128, 4097, (5, -4, -8)),
    (640, 128, 4096, (5, -4, -8)), (256, 128, 13, (5, -4, -8)),
    (256, 96, 130, (5, -4, -8)), (320, 160, 130, (5, -4, -8)),
    (512, 256, 1025, (3, -5, -4)), (2560, 512, 48, (0, -1, -1)),
    (768, 288, 48, (5, -4, -8)), (512, 1024, 40, (0, -1, -1)),
    (256, 512, 1024, (0, -1, -1))])
def test_sweep16_matches_plain_and_int32(gpu, monkeypatch, cap, w, B, scores):
    """RACON_TPU_DP16=1: the int16 warp kernel (W <= 256; at W = 128 four
    items a warp, whose last warp runs part empty at B = 4097 and 13) and
    strip kernel (W = 288 with its last strip cut, 512 and 1024; at B =
    1024 the launch rule's other side) against the int16 plain version and
    the int32 kernel, byte for byte, with _packed's all-PAD and out-of-band
    items;
    nw_sweep launches the int16 kernel and not the int32 one, and
    launch_sweep16 counts each launch."""
    q4, t4, dcb, m, n = _packed(cap + w, B, cap, w)
    geo = dict(m_cap=cap, n_cap=cap, w_band=w)
    sc = dict(zip(("match", "mismatch", "gap"), scores))
    g = to_device(q4, t4, dcb, m, n, m_cap=cap, n_cap=cap, device=gpu)
    c = to_device(q4, t4, dcb, m, n, m_cap=cap, n_cap=cap, device="cpu")
    monkeypatch.delenv("RACON_TPU_DP16", raising=False)
    m32, s32 = nk.nw_sweep(g.q4, g.t4, g.dcb, **geo, **sc)
    monkeypatch.setenv("RACON_TPU_DP16", "1")
    name = sweep_kernel(w, True)
    assert name == ("nw_sweep16" if w <= 256 else "nw_sweep_block16")
    before = dict(LAUNCHES)
    m16, s16 = nk.nw_sweep(g.q4, g.t4, g.dcb, **geo, **sc)
    torch.cuda.synchronize()
    assert LAUNCHES[name] == before[name] + 1
    assert LAUNCHES[sweep_kernel(w)] == before[sweep_kernel(w)]
    assert torch.equal(m16, m32) and torch.equal(s16, s32)
    again = nk.launch_sweep16(g.q4, g.t4, g.dcb, **geo, **sc)
    torch.cuda.synchronize()
    assert LAUNCHES[name] == before[name] + 2
    assert torch.equal(again[0], m16) and torch.equal(again[1], s16)
    pm, ps = nk.nw_sweep_plain(c.q4, c.t4, c.dcb, **geo, **sc)
    assert torch.equal(m16.cpu(), pm) and torch.equal(s16.cpu(), ps)


@pytest.mark.parametrize("cap,w", [(640, 128), (5120, 1024)])
def test_rows_walk_matches_plain(gpu, cap, w):
    q4, t4, dcb, m, n = _packed(cap + w + 2, 96 if cap < 1000 else 8, cap,
                                w)
    geo = dict(m_cap=cap, n_cap=cap, w_band=w)
    g = to_device(q4, t4, dcb, m, n, m_cap=cap, n_cap=cap, device=gpu)
    c = to_device(q4, t4, dcb, m, n, m_cap=cap, n_cap=cap, device="cpu")
    moves, _ = nk.nw_sweep(g.q4, g.t4, g.dcb, **geo, match=5, mismatch=-4,
                           gap=-8)
    before = LAUNCHES["rows_walk"]
    payload = nk.rows_walk(moves, g.m, g.n, **geo)
    torch.cuda.synchronize()
    assert LAUNCHES["rows_walk"] == before + 1
    assert torch.equal(payload.cpu(),
                       nk.rows_walk_plain(moves.cpu(), c.m, c.n, **geo))


@pytest.mark.parametrize("cap,w", [(256, 128), (10240, 2048),
                                   (10240, 4096)])
def test_sweep_and_packed_walk_match_plain(gpu, cap, w):
    """The packed2 path: at W = 2048 and 4096 the sweep's two- and
    four-lanes-per-thread instantiations (counted as nw_sweep_wide), then
    the packed walk."""
    q4, t4, dcb, m, n = _packed(cap + w + 1, 8, cap, w // 2 - 100)
    geo = dict(m_cap=cap, n_cap=cap, w_band=w)
    sc = dict(match=5, mismatch=-4, gap=-8)
    g = to_device(q4, t4, dcb, m, n, m_cap=cap, n_cap=cap, device=gpu)
    c = to_device(q4, t4, dcb, m, n, m_cap=cap, n_cap=cap, device="cpu")
    sweep = sweep_kernel(w)
    before = dict(LAUNCHES)
    moves, score = nk.nw_sweep(g.q4, g.t4, g.dcb, **geo, **sc)
    payload = nk.packed_walk(moves, g.m, g.n, **geo)
    torch.cuda.synchronize()
    assert LAUNCHES[sweep] == before[sweep] + 1
    assert LAUNCHES["packed_walk"] == before["packed_walk"] + 1
    pm, ps = nk.nw_sweep_plain(c.q4, c.t4, c.dcb, **geo, **sc)
    assert torch.equal(moves.cpu(), pm) and torch.equal(score.cpu(), ps)
    assert torch.equal(payload.cpu(),
                       nk.packed_walk_plain(pm, c.m, c.n, **geo))


@pytest.mark.parametrize("cap,w,B,drift,scores", [
    (10240, 2048, 204, 700, (5, -4, -8)),
    (40960, 4096, 25, 1500, (0, -1, -1))])
def test_packed_walk_at_stage_chunks(gpu, cap, w, B, drift, scores):
    """J4 at the stages' chunks: the consensus stage's (10240,2048) B =
    204 and the align stage's scored route at (40960,4096) B = 25 (0/-1/-1,
    every deletion bit set), every 5th item drifting far off the diagonal,
    every 7th all PAD. Every item byte-equal to the plain walk on the
    kernel sweep's moves, copied to the CPU."""
    q4, t4, dcb, m, n = _packed(cap + w + B, B, cap, drift)
    if scores[0] == 0:
        dcb[:] = 0xFF
    geo = dict(m_cap=cap, n_cap=cap, w_band=w)
    g = to_device(q4, t4, dcb, m, n, m_cap=cap, n_cap=cap, device=gpu)
    c = to_device(q4, t4, dcb, m, n, m_cap=cap, n_cap=cap, device="cpu")
    moves, _ = nk.nw_sweep(g.q4, g.t4, g.dcb, **geo, match=scores[0],
                           mismatch=scores[1], gap=scores[2])
    before = LAUNCHES["packed_walk"]
    payload = nk.packed_walk(moves, g.m, g.n, **geo)
    torch.cuda.synchronize()
    assert LAUNCHES["packed_walk"] == before + 1
    want = nk.packed_walk_plain(moves.cpu(), c.m, c.n, **geo)
    assert torch.equal(payload.cpu(), want)
    assert want[:, -1].any() and not want[:, -1].all()


def test_rows_walk_at_the_align_chunk(gpu):
    """K6 at the align stage's scored chunk, (10240,1024) B = 409 with the
    align scores (0/-1/-1, every deletion bit set): every item byte-equal
    to the plain walk on the kernel sweep's moves, copied to the CPU."""
    from racon_tpu_torch.ops.align_stage import _chunk_size

    cap, w = 10240, 1024
    B = _chunk_size(cap, w, False)
    assert B == 409
    q4, t4, dcb, m, n = _packed(cap + w + B, B, cap, w // 2 + 100)
    dcb[:] = 0xFF
    geo = dict(m_cap=cap, n_cap=cap, w_band=w)
    g = to_device(q4, t4, dcb, m, n, m_cap=cap, n_cap=cap, device=gpu)
    c = to_device(q4, t4, dcb, m, n, m_cap=cap, n_cap=cap, device="cpu")
    moves, _ = nk.nw_sweep(g.q4, g.t4, g.dcb, **geo, match=0, mismatch=-1,
                           gap=-1)
    before = LAUNCHES["rows_walk"]
    payload = nk.rows_walk(moves, g.m, g.n, **geo)
    torch.cuda.synchronize()
    assert LAUNCHES["rows_walk"] == before + 1
    want = nk.rows_walk_plain(moves.cpu(), c.m, c.n, **geo)
    assert torch.equal(payload.cpu(), want)
    assert want[:, -1].any() and not want[:, -1].all()


def test_rows_walk_long_deletion_runs(gpu):
    """Rows whose deletion run crosses one or two 32-lane groups (the
    walk's out-of-line step) or passes 63 lanes (escape), as in
    test_myers_walk_long_deletion_runs but through the scored sweep at the
    align scores: A/C queries, targets with G/T blocks of 0-12 and 33-70
    bases, at W = 256, 1024 and 4096. Runs up to 63 are taken whole, 64
    and 70 escape."""
    rng = np.random.default_rng(67)
    runs = (33, 47, 52, 58, 63, 64, 70)
    for cap, w in ((256, 256), (1024, 1024), (1024, 4096)):
        pairs = []
        for run in runs:
            for early in (0, 6, 12):
                q = rng.choice(ACGT[:2], int(rng.integers(120, 160)))
                pos = int(rng.integers(40, len(q) - 10))
                t = np.insert(q, pos, rng.choice(ACGT[2:], run))
                pairs.append((q, np.insert(t, 20, rng.choice(ACGT[2:],
                                                              early))))
        B = len(pairs)
        q8 = np.full((B, cap), 5, np.uint8)
        t8 = np.full((B, cap), 5, np.uint8)
        m = np.array([len(q) for q, _ in pairs], np.int32)
        n = np.array([len(t) for _, t in pairs], np.int32)
        for b, (q, t) in enumerate(pairs):
            q8[b, : len(q)] = encode(q)
            t8[b, : len(t)] = encode(t)
        q4 = q8[:, 0::2] | (q8[:, 1::2] << 4)
        t4 = t8[:, 0::2] | (t8[:, 1::2] << 4)
        dcb = np.full((B, cap // 8), 0xFF, np.uint8)
        geo = dict(m_cap=cap, n_cap=cap, w_band=w)
        g = to_device(q4, t4, dcb, m, n, m_cap=cap, n_cap=cap, device=gpu)
        c = to_device(q4, t4, dcb, m, n, m_cap=cap, n_cap=cap, device="cpu")
        moves, _ = nk.nw_sweep(g.q4, g.t4, g.dcb, **geo, match=0,
                               mismatch=-1, gap=-1)
        before = LAUNCHES["rows_walk"]
        payload = nk.rows_walk(moves, g.m, g.n, **geo)
        torch.cuda.synchronize()
        assert LAUNCHES["rows_walk"] == before + 1
        want = nk.rows_walk_plain(moves.cpu(), c.m, c.n, **geo)
        assert torch.equal(payload.cpu(), want), (cap, w)
        planned = np.repeat(runs, 3)
        longest = (want[:, :cap].numpy() >> 2).max(1)
        taken = planned <= 63
        assert (longest[taken] == planned[taken]).all(), (cap, w)
        assert want[~taken, -1].all() and not want[taken, -1].any()


@pytest.mark.parametrize("cap,w,B,check", [(512, 64, 9, 9),
                                           (2560, 512, 9, 9),
                                           (10240, 4096, 9, 9),
                                           (10240, 1024, 409, 8)])
def test_myers_sweep_and_walk_match_plain(gpu, cap, w, B, check):
    """Ragged batches (the walk's last block runs one warp), and the
    align stage's former chunk at (10240, 1024), 409 items, whose first
    `check` items are held against the plain versions."""
    q4, t4, _, m, n = _packed(cap + w, B, cap, w)
    geo = dict(m_cap=cap, n_cap=cap, w_band=w)
    g = to_device(q4, t4, None, m, n, m_cap=cap, n_cap=cap, device=gpu)
    c = to_device(q4[:check], t4[:check], None, m[:check], n[:check],
                  m_cap=cap, n_cap=cap, device="cpu")
    before = LAUNCHES["myers_walk"]
    planes = mk.myers_sweep(g.q4, g.t4, **geo)
    payload = mk.myers_walk(planes, g.m, g.n, **geo)
    torch.cuda.synchronize()
    assert LAUNCHES["myers_walk"] == before + 1
    pl = mk.myers_sweep_plain(c.q4, c.t4, **geo)
    assert torch.equal(planes[:check].cpu(), pl)
    assert torch.equal(payload[:check].cpu(),
                       mk.myers_walk_plain(pl, c.m, c.n, **geo))


@pytest.mark.parametrize("cap,w,B,sample", [(2560, 512, 1024, None),
                                            (10240, 1024, 1024, 8)])
def test_myers_sweep_full_grid_matches_plain(gpu, cap, w, B, sample):
    """The sweep at a full align chunk, one item a block: every item at
    (2560,512); at (10240,1024) `sample` items spread over the launch plus
    item 2 (drifts out of the band: escapes), item 6 (all PAD) and the
    last block's, every word of their planes and the walk's payload after
    them."""
    q4, t4, _, m, n = _packed(3 * cap + w, B, cap, w)
    geo = dict(m_cap=cap, n_cap=cap, w_band=w)
    g = to_device(q4, t4, None, m, n, m_cap=cap, n_cap=cap, device=gpu)
    idx = (np.arange(B) if sample is None else np.unique(np.r_[
        np.linspace(0, B - 1, sample).astype(int), 2, 6, B - 1]))
    c = to_device(q4[idx], t4[idx], None, m[idx], n[idx], m_cap=cap,
                  n_cap=cap, device="cpu")
    before = LAUNCHES["myers_sweep"]
    planes = mk.myers_sweep(g.q4, g.t4, **geo)
    payload = mk.myers_walk(planes, g.m, g.n, **geo)
    torch.cuda.synchronize()
    assert LAUNCHES["myers_sweep"] == before + 1
    pl = mk.myers_sweep_plain(c.q4, c.t4, **geo)
    sel = torch.from_numpy(idx).to(gpu)
    assert torch.equal(planes[sel].cpu(), pl)
    pp = mk.myers_walk_plain(pl, c.m, c.n, **geo)
    assert torch.equal(payload[sel].cpu(), pp)
    assert pp[:, -1].any() and not pp[:, -1].all()


@pytest.mark.parametrize("cap,w,B", [(640, 128, 4096), (640, 128, 4097),
                                     (256, 128, 4097), (1280, 256, 1024),
                                     (5120, 1024, 40), (40960, 1024, 17)])
def test_rle_walk_staged_matches_plain(gpu, cap, w, B):
    """The RLE walk's staged, coalesced payload on every item: a warp of
    32 items a block (B = 4097 leaves one in the last), shared staging
    past 48 KB at (5120,1024) (E = 1792) and 16 items a block at
    (40960,1024) (E = 10752; B = 17 leaves one)."""
    q4, t4, dcb, m, n = _packed(cap + 5 * w + B, B, cap, w)
    geo = dict(m_cap=cap, n_cap=cap, w_band=w)
    g = to_device(q4, t4, dcb, m, n, m_cap=cap, n_cap=cap, device=gpu)
    c = to_device(q4, t4, dcb, m, n, m_cap=cap, n_cap=cap, device="cpu")
    moves, _ = nk.nw_sweep(g.q4, g.t4, g.dcb, **geo, match=5, mismatch=-4,
                           gap=-8)
    before = LAUNCHES["rle_walk"]
    payload = nk.rle_walk(moves, g.m, g.n, **geo)
    torch.cuda.synchronize()
    assert LAUNCHES["rle_walk"] == before + 1
    want = nk.rle_walk_plain(moves.cpu(), c.m, c.n, **geo)
    assert torch.equal(payload.cpu(), want)
    assert want[:, -1].any()


def test_myers_walk_long_deletion_runs(gpu):
    """Rows whose deletion run exits one or two words below kvec's (the
    walk's out-of-line step) or runs past 63 lanes (escape): A/C queries,
    targets with G/T blocks of 0-12 and 33-70 bases, at W = 256, 1024
    and 4096."""
    rng = np.random.default_rng(67)
    for cap, w in ((256, 256), (1024, 1024), (1024, 4096)):
        pairs = []
        for run in (33, 47, 52, 58, 63, 64, 70):
            for early in (0, 6, 12):
                q = rng.choice(ACGT[:2], int(rng.integers(120, 160)))
                pos = int(rng.integers(40, len(q) - 10))
                t = np.insert(q, pos, rng.choice(ACGT[2:], run))
                pairs.append((q, np.insert(t, 20, rng.choice(ACGT[2:],
                                                              early))))
        B = len(pairs)
        q8 = np.full((B, cap), 5, np.uint8)
        t8 = np.full((B, cap), 5, np.uint8)
        m = np.array([len(q) for q, _ in pairs], np.int32)
        n = np.array([len(t) for _, t in pairs], np.int32)
        for b, (q, t) in enumerate(pairs):
            q8[b, : len(q)] = encode(q)
            t8[b, : len(t)] = encode(t)
        q4 = q8[:, 0::2] | (q8[:, 1::2] << 4)
        t4 = t8[:, 0::2] | (t8[:, 1::2] << 4)
        geo = dict(m_cap=cap, n_cap=cap, w_band=w)
        g = to_device(q4, t4, None, m, n, m_cap=cap, n_cap=cap, device=gpu)
        c = to_device(q4, t4, None, m, n, m_cap=cap, n_cap=cap, device="cpu")
        planes = mk.myers_sweep(g.q4, g.t4, **geo)
        payload = mk.myers_walk(planes, g.m, g.n, **geo)
        torch.cuda.synchronize()
        want = mk.myers_walk_plain(planes.cpu(), c.m, c.n, **geo)
        assert torch.equal(payload.cpu(), want), (cap, w)
        assert int(want[:, :cap].max()) >> 2 == 63


def _panels(seed, B, m_cap, n_cap, w):
    """Panel-sweep inputs: _packed's items (every 7th all PAD, every 5th
    drifting) with each target moved n_cap - m_cap columns right, so that
    a band right of the diagonal (n_cap > m_cap + W/2) still follows them,
    and the same items packed at m_cap when n_cap == m_cap."""
    q4, t4, dcb, m, n = _packed(seed, B, m_cap, w // 2)
    unpack = lambda x4: np.stack([x4 & 15, x4 >> 4], -1).reshape(B, -1)
    t8 = np.full((B, n_cap), 5, np.uint8)
    t8[:, n_cap - m_cap:] = unpack(t4)
    t8[:, : n_cap - m_cap] = np.random.default_rng(seed).choice(
        np.arange(4, dtype=np.uint8), (B, n_cap - m_cap))
    dc = np.ones((B, n_cap), np.int32)
    dc[:, n_cap - m_cap:] = np.unpackbits(dcb, axis=1, bitorder="little")
    panels = nk.sweep_t_panels(torch.from_numpy(unpack(q4)),
                               torch.from_numpy(t8),
                               torch.from_numpy(dc * -8), w_band=w)
    return panels, (q4, t4, dcb, m, n)


@pytest.mark.parametrize("m_cap,n_cap,w", [(640, 640, 128),
                                           (256, 512, 128), (512, 512, 256),
                                           (256, 256, 96), (640, 640, 512)])
def test_panel_sweep_and_ablation_variants_match_plain(gpu, m_cap, n_cap,
                                                       w):
    """K7 (nw_sweep_t) and every K8 variant (run_variant) against their
    plain versions (nomoves: the score only), on the warp kernel at the
    harness's shape, with the band right of the diagonal (dlo = 192), at
    W = 256 (eight lanes a thread) and W = 96 (pad lanes), and on the
    block kernel at W = 512; at equal caps K7 against K1 (nw_sweep) on
    the same items packed."""
    from racon_tpu_torch.benchmarks import profile_ablate as pa

    geo = dict(m_cap=m_cap, n_cap=n_cap, w_band=w)
    cpu, packed = _panels(m_cap + n_cap, 96, m_cap, n_cap, w)
    g = [x.to(gpu) for x in cpu]
    before = dict(LAUNCHES)
    moves, score = nk.nw_sweep_t(*g, **geo, **pa.SCORES)
    torch.cuda.synchronize()
    assert LAUNCHES["nw_sweep_t"] == before["nw_sweep_t"] + 1
    pm, ps = nk.nw_sweep_t_plain(*cpu, **geo, **pa.SCORES)
    assert torch.equal(moves.cpu(), pm) and torch.equal(score.cpu(), ps)
    for v in pa.VARIANTS:
        vm, vs = pa.run_variant(*g, **geo, variant=v)
        torch.cuda.synchronize()
        wm, ws = pa.run_variant_plain(*cpu, **geo, variant=v)
        assert torch.equal(vs.cpu(), ws), v
        if v != "nomoves":
            assert torch.equal(vm.cpu(), wm), v
    assert LAUNCHES["nw_ablate"] == before["nw_ablate"] + len(pa.VARIANTS)
    if m_cap == n_cap:
        p = to_device(*packed, m_cap=m_cap, n_cap=m_cap, device=gpu)
        km, ks = nk.nw_sweep(p.q4, p.t4, p.dcb, **geo, **pa.SCORES)
        assert torch.equal(km, moves) and torch.equal(ks, score)


def test_kernels_refuse_wrong_inputs(gpu):
    from racon_tpu_torch.kernels.build import kernels

    q4 = torch.zeros((4, 128), dtype=torch.uint8, device=gpu)
    dcb = torch.zeros((4, 32), dtype=torch.uint8, device=gpu)
    moves = torch.empty((4, 16, 128), dtype=torch.int64, device=gpu)
    score = torch.empty((4,), dtype=torch.int32, device=gpu)
    with pytest.raises(RuntimeError, match="dtype"):
        kernels().nw_sweep(q4, q4, dcb, moves, score, 256, 256, 128, 5, -4,
                           -8, 128)


@pytest.mark.parametrize("env", [{}, {"RACON_TPU_MYERS": "0",
                                      "RACON_TPU_WALK": "rows"}])
def test_cuda_polish_matches_cpu(gpu, tmp_path, monkeypatch, env):
    """The default path, and the scored stack on both stages (the scored
    align route and the rows walk)."""
    for key, value in env.items():
        monkeypatch.setenv(key, value)
    from racon_tpu_torch.models.polish_model import PolisherConfig
    from racon_tpu_torch.polisher import create_polisher

    rng = np.random.default_rng(7)
    true = rng.choice(ACGT, 3000)
    reads, paf = [], []
    for r in range(24):
        s = int(rng.integers(0, 600))
        e = int(rng.integers(2400, 3000))
        read = true[s:e].copy()
        sub = rng.random(len(read)) < 0.05
        read[sub] = rng.choice(ACGT, int(sub.sum()))
        reads.append(b">r%d\n%s\n" % (r, read.tobytes()))
        paf.append(b"r%d\t%d\t0\t%d\t+\tctg\t3000\t%d\t%d\t9\t9\t60\n"
                   % (r, len(read), len(read), s, e))
    draft = true.copy()
    draft[rng.choice(3000, 30, replace=False)] = ord("A")
    (tmp_path / "r.fasta").write_bytes(b"".join(reads))
    (tmp_path / "o.paf").write_bytes(b"".join(paf))
    (tmp_path / "d.fasta").write_bytes(b">ctg\n" + draft.tobytes() + b"\n")
    paths = [str(tmp_path / f) for f in ("r.fasta", "o.paf", "d.fasta")]
    outs = []
    for device in ("cuda", "cpu"):
        cfg = PolisherConfig(backend="cuda", num_threads=2, match=5,
                             mismatch=-4, gap=-8)
        with contextlib.redirect_stderr(io.StringIO()):
            p = create_polisher(*paths, cfg, device=device)
            p.initialize()
            outs.append(p.polish(True))
    assert outs[0] == outs[1]


def test_consensus_cohorts_equal_on_card(gpu, monkeypatch):
    """The stage on the bench workload runs 3 cohorts by default on the
    card, with the same bytes as one cohort."""
    from racon_tpu_torch.models.polish_model import PolisherConfig
    from racon_tpu_torch.ops.consensus_stage import TorchConsensusStage
    from racon_tpu_torch.testing.synth import build_workload
    from racon_tpu_torch.utils.logger import Logger

    windows, _ = build_workload(seed=1234)
    cfg = PolisherConfig(backend="cuda", num_threads=8, match=5,
                         mismatch=-4, gap=-8)
    outs, counts = [], []
    for env in ("1", None):
        if env is None:
            monkeypatch.delenv("RACON_TPU_COHORTS", raising=False)
        else:
            monkeypatch.setenv("RACON_TPU_COHORTS", env)
        stage = TorchConsensusStage(cfg, gpu)
        with contextlib.redirect_stderr(io.StringIO()):
            outs.append(stage.consensus_windows(windows, cfg, Logger()))
        counts.append(stage.n_cohorts)
    assert counts == [1, 3]
    assert outs[0] == outs[1]


def test_prefetch_matches_blocking_fetch(gpu, monkeypatch):
    """A payload prefetched right after its launch, resolved while later
    chunks are still queued behind it, equals a blocking .cpu() of it."""
    from racon_tpu_torch.ops import prefetch

    monkeypatch.delenv("RACON_TPU_FETCH_THREADS", raising=False)
    geo = dict(m_cap=640, n_cap=640, w_band=128, match=5, mismatch=-4,
               gap=-8)
    first = None
    for k in range(4):
        batch = _packed(k, 4096, 640, 128)
        payload, _, fmt = nk.align_walk_padded(*batch, **geo, device=gpu)
        fetch = prefetch.submit(payload)
        assert fetch.host.is_pinned()
        if first is None:
            first = (payload, fetch)
    got = prefetch.resolve(*first)
    assert fmt == "rle" and isinstance(got, np.ndarray)
    assert np.array_equal(got, first[0].cpu().numpy())


def test_to_device_uploads_from_pinned_memory(gpu):
    """to_device's copies on a CUDA device leave page-locked memory
    (named so by the profiler) and match the numpy arrays."""
    from torch.profiler import ProfilerActivity, profile

    q4, t4, dcb, m, n = _packed(3, 1024, 640, 128)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        g = to_device(q4, t4, dcb, m, n, m_cap=640, n_cap=640, device=gpu)
        torch.cuda.synchronize()
    copies = [e.name for e in prof.events() if "Memcpy HtoD" in e.name]
    assert len(copies) == 5
    assert all("Pinned" in c and "Pageable" not in c for c in copies)
    for got, want in zip((g.q4, g.t4, g.dcb, g.m, g.n), (q4, t4, dcb, m, n)):
        assert np.array_equal(got.cpu().numpy(), want)


@pytest.mark.parametrize("fmt,cap,w,B", [("rle", 640, 128, 4097),
                                         ("rows", 640, 128, 1025),
                                         ("packed2", 256, 128, 1023),
                                         ("myers", 2560, 512, 1023)])
def test_sharded_dispatch_matches_unsharded(gpu, fmt, cap, w, B):
    """mesh.sharded_align_walk on (cuda:0, cuda:0), an odd B so the shards
    are uneven: every item's payload and score equal the unsharded
    launch's, each shard on its device, one launch a shard."""
    from racon_tpu_torch.parallel import mesh

    dev = torch.device("cuda", 0)
    batch = _packed(B + cap, B, cap, w)
    geo = dict(m_cap=cap, n_cap=cap, w_band=w)
    sc = dict(match=5, mismatch=-4, gap=-8)
    before = dict(LAUNCHES)
    payloads, scores = mesh.sharded_align_walk((dev, dev), *batch, **geo,
                                               **sc, fmt=fmt)
    walk = "myers_walk" if fmt == "myers" else {
        "rle": "rle_walk", "rows": "rows_walk",
        "packed2": "packed_walk"}[fmt]
    assert LAUNCHES[walk] == before[walk] + 2
    assert [len(p) for p in payloads] == [(B + 1) // 2, B // 2]
    assert all(p.device == dev for p in payloads + scores)
    q4, t4, dcb, m, n = batch
    g = to_device(q4, t4, dcb, m, n, m_cap=cap, n_cap=cap, device=dev)
    if fmt == "myers":
        want = mk.myers_walk(mk.myers_sweep(g.q4, g.t4, **geo), g.m, g.n,
                             **geo)
        want_sc = torch.zeros_like(g.m)
    else:
        moves, want_sc = nk.nw_sweep(g.q4, g.t4, g.dcb, **geo, **sc)
        want = {"rle": nk.rle_walk, "rows": nk.rows_walk,
                "packed2": nk.packed_walk}[fmt](moves, g.m, g.n, **geo)
    assert torch.equal(torch.cat(payloads), want)
    assert torch.equal(torch.cat(scores), want_sc)


def test_prefetch_of_sharded_payload(gpu, monkeypatch):
    """A mesh's per-shard payloads, each prefetched on its own device's
    stream and resolved while later chunks are queued, join into the
    bytes of a blocking fetch."""
    from racon_tpu_torch.ops import prefetch
    from racon_tpu_torch.parallel import mesh

    monkeypatch.delenv("RACON_TPU_FETCH_THREADS", raising=False)
    geo = dict(m_cap=640, n_cap=640, w_band=128, match=5, mismatch=-4,
               gap=-8)
    mesh.set_active_mesh(["cuda:0", "cuda:0", "cuda:0"])
    try:
        first = None
        for k in range(4):
            payload, _, fmt = nk.align_walk_padded(*_packed(k, 4097, 640, 128),
                                                   **geo, device=gpu)
            fetch = prefetch.submit(payload)
            assert isinstance(payload, list) and len(fetch) == 3
            assert all(f.host.is_pinned() for f in fetch)
            if first is None:
                first = (payload, fetch)
    finally:
        mesh.clear_active_mesh()
    got = prefetch.resolve(*first)
    want = torch.cat(first[0]).cpu().numpy()
    assert fmt == "rle" and np.array_equal(got, want)
    unsharded, _, _ = nk.align_walk_padded(*_packed(0, 4097, 640, 128),
                                           **geo, device=gpu)
    assert np.array_equal(got, unsharded.cpu().numpy())


def test_launch_follows_the_tensor_device(gpu):
    """A launch on tensors of cuda:1 while the current device is 0 runs
    on cuda:1 (device guard, that device's stream) and equals the plain
    version; a tensor on another device than the first is refused."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    from racon_tpu_torch.kernels.build import kernels

    torch.cuda.set_device(0)
    q4, t4, dcb, m, n = _packed(5, 513, 640, 128)
    geo = dict(m_cap=640, n_cap=640, w_band=128)
    sc = dict(match=5, mismatch=-4, gap=-8)
    g = to_device(q4, t4, dcb, m, n, m_cap=640, n_cap=640, device="cuda:1")
    moves, score = nk.nw_sweep(g.q4, g.t4, g.dcb, **geo, **sc)
    payload = nk.rle_walk(moves, g.m, g.n, **geo)
    assert torch.cuda.current_device() == 0
    assert moves.device == payload.device == torch.device("cuda", 1)
    c = to_device(q4, t4, dcb, m, n, m_cap=640, n_cap=640, device="cpu")
    pm, ps = nk.nw_sweep_plain(c.q4, c.t4, c.dcb, **geo, **sc)
    assert torch.equal(moves.cpu(), pm) and torch.equal(score.cpu(), ps)
    assert torch.equal(payload.cpu(),
                       nk.rle_walk_plain(pm, c.m, c.n, **geo))
    with pytest.raises(RuntimeError, match="is on"):
        kernels().nw_sweep(g.q4, g.t4.to("cuda:0"), g.dcb, moves, score,
                           640, 640, 128, 5, -4, -8, 128)


def _gather_blobs(seed, B, cap):
    """Word blobs and meta rows for the gather kernel: odd starts, rows of
    length 0 and cap, a row ending at each blob's end, an all-PAD item,
    deletion-cost bits 30 % clear; also the numpy blobs the host packers
    read."""
    from racon_tpu_torch.ops import gather

    rng = np.random.default_rng(seed)
    L = 2 * B * cap // 3 + cap + 7
    q8 = rng.integers(0, 5, L).astype(np.int8)
    t8 = rng.integers(0, 5, L).astype(np.int8)
    dmask = rng.random(L) >= 0.3
    lens = rng.integers(0, cap + 1, (2, B))
    lens[:, 0], lens[:, 1] = 0, cap
    starts = rng.integers(0, L - cap, (2, B))
    starts[:, 2] = L - lens[:, 2]
    starts[:, 3] |= 1
    meta = np.stack([starts[0], lens[0], starts[1], lens[1]],
                    1).astype(np.int32)
    words = (gather.code_words(q8), gather.code_words(t8),
             gather.bit_words(dmask))
    return words, meta, (q8, t8, dmask.view(np.int8))


@pytest.mark.parametrize("cap,B", [(640, 4096), (256, 4097), (5120, 8)])
def test_pack_gather_matches_plain_and_packers(gpu, cap, B):
    """J6's kernel against its plain version and the host packers over the
    same ranges, byte for byte, one launch counted."""
    from racon_tpu_torch.native import bindings
    from racon_tpu_torch.ops import gather
    from racon_tpu_torch.ops.geometry import PAD_CODE

    words, meta, (q8, t8, del8) = _gather_blobs(cap + B, B, cap)
    dev = [torch.from_numpy(w).to(gpu) for w in (*words, meta)]
    before = LAUNCHES["pack_gather"]
    got = gather.pack_gather(*dev, m_cap=cap, n_cap=cap)
    torch.cuda.synchronize()
    assert LAUNCHES["pack_gather"] == before + 1
    plain = gather.pack_gather_plain(
        *(torch.from_numpy(w) for w in (*words, meta)), m_cap=cap, n_cap=cap)
    qs, m, ts, n = meta.T.astype(np.int64)
    packers = (bindings.pack_rows_nib(q8, qs, qs + m, cap, PAD_CODE, 8),
               bindings.pack_rows_nib(t8, ts, ts + n, cap, PAD_CODE, 8),
               bindings.pack_rows_bits(del8, ts, ts + n, cap, 8))
    for g, p, h in zip(got, plain, packers):
        assert torch.equal(g.cpu(), p)
        assert np.array_equal(p.numpy(), h)


def _gather_edges(seed, B, m_cap, n_cap):
    """Word blobs and B meta rows at the row gather's edge cases (as
    tests/test_torch_gather_lanes.py's lane model takes them): lengths the
    cap, 0, 1, 7, 8, 9, 31, 32 and 33, every start mod 32, the first three
    rows ending at each blob's last element (one blob a whole number of
    bit words long, the other not); also the numpy blobs the host packers
    read."""
    from racon_tpu_torch.ops import gather

    rng = np.random.default_rng(seed)
    edges = (0, 1, 7, 8, 9, 31, 32, 33)
    ql = np.array([m_cap] + [x for x in edges if x < m_cap])
    tl = np.array([n_cap] + [x for x in edges if x < n_cap])
    cap = max(m_cap, n_cap)
    Lq, Lt = 4 * cap + 256, 4 * cap + 261
    b = np.arange(B)
    qlen, tlen = ql[b % len(ql)], tl[(b // 32) % len(tl)]
    qs = 32 * rng.integers(0, (Lq - m_cap) // 32 - 1, B) + (b // len(ql)) % 32
    ts = 32 * rng.integers(0, (Lt - n_cap) // 32 - 1, B) + b % 32
    qs[:3], ts[:3] = Lq - qlen[:3], Lt - tlen[:3]
    q8 = rng.integers(0, 5, Lq).astype(np.int8)
    t8 = rng.integers(0, 5, Lt).astype(np.int8)
    dmask = rng.random(Lt) >= 0.3
    meta = np.stack([qs, qlen, ts, tlen], 1).astype(np.int32).reshape(B, 4)
    words = (gather.code_words(q8), gather.code_words(t8),
             gather.bit_words(dmask))
    return words, meta, (q8, t8, dmask.view(np.int8))


@pytest.mark.parametrize("m_cap,n_cap,B", [
    (m, n, B) for m, n in ((256, 256), (640, 640), (1280, 1280),
                           (2560, 2560), (5120, 5120), (10240, 10240),
                           (40, 64), (264, 288), (2560, 640))
    for B in (0, 1, 288)])
def test_pack_gather_edge_cases(gpu, m_cap, n_cap, B):
    """J6's kernel at the lane model's edge cases, B = 0 and 1 among them,
    against its plain version and the host packers, byte for byte."""
    from racon_tpu_torch.native import bindings
    from racon_tpu_torch.ops import gather
    from racon_tpu_torch.ops.geometry import PAD_CODE

    words, meta, (q8, t8, del8) = _gather_edges(m_cap + n_cap + B, B, m_cap,
                                                n_cap)
    dev = [torch.from_numpy(w).to(gpu) for w in (*words, meta)]
    got = gather.pack_gather(*dev, m_cap=m_cap, n_cap=n_cap)
    torch.cuda.synchronize()
    plain = gather.pack_gather_plain(
        *(torch.from_numpy(w) for w in (*words, meta)), m_cap=m_cap,
        n_cap=n_cap)
    qs, m, ts, n = meta.T.astype(np.int64)
    packers = (bindings.pack_rows_nib(q8, qs, qs + m, m_cap, PAD_CODE, 8),
               bindings.pack_rows_nib(t8, ts, ts + n, n_cap, PAD_CODE, 8),
               bindings.pack_rows_bits(del8, ts, ts + n, n_cap, 8))
    for g, p, h in zip(got, plain, packers):
        assert g.shape == p.shape and torch.equal(g.cpu(), p)
        assert np.array_equal(p.numpy(), h)
        assert g.data_ptr() % gather.OUT_ALIGN == 0


def test_align_walk_gather_matches_dense_on_card(gpu):
    """The gather route's fused call against the dense one on the same
    rows, and on the mesh (cuda:0, cuda:0) in two shards."""
    from racon_tpu_torch.native import bindings
    from racon_tpu_torch.ops import gather
    from racon_tpu_torch.ops.geometry import PAD_CODE
    from racon_tpu_torch.parallel import mesh

    cap, w, B = 640, 128, 4097
    words, meta, (q8, t8, del8) = _gather_blobs(9, B, cap)
    geo = dict(m_cap=cap, n_cap=cap, w_band=w, match=5, mismatch=-4, gap=-8)
    qs, m, ts, n = meta.T.astype(np.int64)
    want_p, want_s, fmt = nk.align_walk_padded(
        bindings.pack_rows_nib(q8, qs, qs + m, cap, PAD_CODE, 8),
        bindings.pack_rows_nib(t8, ts, ts + n, cap, PAD_CODE, 8),
        bindings.pack_rows_bits(del8, ts, ts + n, cap, 8),
        m.astype(np.int32), n.astype(np.int32), **geo, device=gpu)
    blobs = [gather.put_blob(x, [gpu]) for x in words]
    payload, score, gfmt = nk.align_walk_gather(*blobs, meta, **geo,
                                                device=gpu)
    assert gfmt == fmt
    assert torch.equal(payload, want_p) and torch.equal(score, want_s)
    dev = torch.device("cuda", 0)
    blobs = [gather.put_blob(x, [dev, dev]) for x in words]
    assert all(list(b) == [dev] for b in blobs)
    payloads, scores = mesh.sharded_align_walk_gather(
        (dev, dev), *blobs, meta, **geo, fmt=fmt)
    assert [len(p) for p in payloads] == [(B + 1) // 2, B // 2]
    assert torch.equal(torch.cat(payloads), want_p)
    assert torch.equal(torch.cat(scores), want_s)


def test_consensus_gather_equals_dense_on_card(gpu, monkeypatch):
    """The stage on the bench workload under RACON_TPU_DEVGATHER=1: the
    dense route's bytes, the gather kernel launched, no host packer."""
    from racon_tpu_torch.models.polish_model import PolisherConfig
    from racon_tpu_torch.native import bindings
    from racon_tpu_torch.ops.consensus_stage import TorchConsensusStage
    from racon_tpu_torch.testing.synth import build_workload
    from racon_tpu_torch.utils.logger import Logger

    windows, _ = build_workload(seed=1234)
    cfg = PolisherConfig(backend="cuda", num_threads=8, match=5,
                         mismatch=-4, gap=-8)
    packed = []
    real = bindings.pack_rows_nib

    def counted(*a, **kw):
        packed.append(1)
        return real(*a, **kw)

    monkeypatch.setattr(bindings, "pack_rows_nib", counted)
    outs = []
    for env in (None, "1"):
        if env is None:
            monkeypatch.delenv("RACON_TPU_DEVGATHER", raising=False)
        else:
            monkeypatch.setenv("RACON_TPU_DEVGATHER", env)
        packed.clear()
        before = LAUNCHES["pack_gather"]
        stage = TorchConsensusStage(cfg, gpu)
        with contextlib.redirect_stderr(io.StringIO()):
            outs.append(stage.consensus_windows(windows, cfg, Logger()))
        launched = LAUNCHES["pack_gather"] - before
        assert (launched > 0 and not packed) if env else (packed and
                                                          not launched)
    assert outs[0] == outs[1]


@pytest.mark.parametrize("cap,w,B", [(10240, 1024, 96), (2560, 512, 257),
                                     (512, 64, 9)])
def test_myers_moves_and_rle_payload_match_plain(gpu, cap, w, B):
    """J5's kernel against its plain version on the sweep kernel's planes
    (8 items spread over the launch), and the "rle" payload of
    align_walk_myers_padded against the plain route's on those items."""
    q4, t4, _, m, n = _packed(cap + w + 1, B, cap, w)
    geo = dict(m_cap=cap, n_cap=cap, w_band=w)
    g = to_device(q4, t4, None, m, n, m_cap=cap, n_cap=cap, device=gpu)
    idx = np.unique(np.r_[np.linspace(0, B - 1, 8).astype(int), 6, B - 1])
    sel = torch.from_numpy(idx).to(gpu)
    planes = mk.myers_sweep(g.q4, g.t4, **geo)
    before = LAUNCHES["myers_moves"]
    moves = mk.myers_moves(planes, g.m, **geo)
    torch.cuda.synchronize()
    assert LAUNCHES["myers_moves"] == before + 1
    want = mk.myers_moves_plain(planes[sel].cpu(), g.m[sel].cpu(), **geo)
    assert torch.equal(moves[sel].cpu(), want)
    payload, _, fmt = mk.align_walk_myers_padded(q4, t4, m, n, **geo,
                                                 device=gpu, fmt="rle")
    assert fmt == "rle"
    assert torch.equal(payload[sel].cpu(), nk.rle_walk_plain(
        want, g.m[sel].cpu(), g.n[sel].cpu(), **geo))

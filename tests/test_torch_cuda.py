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
from racon_tpu_torch.ops.geometry import encode

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


@pytest.mark.parametrize("cap,w", [(256, 128), (640, 128), (1280, 512)])
def test_sweep_and_rle_walk_match_plain(gpu, cap, w):
    q4, t4, dcb, m, n = _packed(cap + w, 96, cap, w)
    geo = dict(m_cap=cap, n_cap=cap, w_band=w)
    sc = dict(match=5, mismatch=-4, gap=-8)
    g = to_device(q4, t4, dcb, m, n, m_cap=cap, n_cap=cap, device=gpu)
    c = to_device(q4, t4, dcb, m, n, m_cap=cap, n_cap=cap, device="cpu")
    before = dict(LAUNCHES)
    moves, score = nk.nw_sweep(g.q4, g.t4, g.dcb, **geo, **sc)
    payload = nk.rle_walk(moves, g.m, g.n, **geo)
    torch.cuda.synchronize()
    assert LAUNCHES["nw_sweep"] == before["nw_sweep"] + 1
    assert LAUNCHES["rle_walk"] == before["rle_walk"] + 1
    pm, ps = nk.nw_sweep_plain(c.q4, c.t4, c.dcb, **geo, **sc)
    assert torch.equal(moves.cpu(), pm) and torch.equal(score.cpu(), ps)
    assert torch.equal(payload.cpu(), nk.rle_walk_plain(pm, c.m, c.n, **geo))


@pytest.mark.parametrize("cap,w", [(512, 64), (2560, 512), (10240, 4096)])
def test_myers_sweep_and_walk_match_plain(gpu, cap, w):
    q4, t4, _, m, n = _packed(cap + w, 8, cap, w)
    geo = dict(m_cap=cap, n_cap=cap, w_band=w)
    g = to_device(q4, t4, None, m, n, m_cap=cap, n_cap=cap, device=gpu)
    c = to_device(q4, t4, None, m, n, m_cap=cap, n_cap=cap, device="cpu")
    planes = mk.myers_sweep(g.q4, g.t4, **geo)
    payload = mk.myers_walk(planes, g.m, g.n, **geo)
    pl = mk.myers_sweep_plain(c.q4, c.t4, **geo)
    assert torch.equal(planes.cpu(), pl)
    assert torch.equal(payload.cpu(), mk.myers_walk_plain(pl, c.m, c.n,
                                                          **geo))


def test_kernels_refuse_wrong_inputs(gpu):
    from racon_tpu_torch.kernels.build import kernels

    q4 = torch.zeros((4, 128), dtype=torch.uint8, device=gpu)
    dcb = torch.zeros((4, 32), dtype=torch.uint8, device=gpu)
    moves = torch.empty((4, 16, 128), dtype=torch.int64, device=gpu)
    score = torch.empty((4,), dtype=torch.int32, device=gpu)
    with pytest.raises(RuntimeError, match="dtype"):
        kernels().nw_sweep(q4, q4, dcb, moves, score, 256, 256, 128, 5, -4,
                           -8, 128)


def test_cuda_polish_matches_cpu(gpu, tmp_path):
    from racon_tpu.models.polish_model import PolisherConfig
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

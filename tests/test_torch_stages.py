"""The port's two device stages, on the CPU through the kernels' plain
versions, against the JAX package's stages:

- TorchConsensusStage vs TpuConsensusStage (interpreted kernels, at the
  real tier shapes) on the bench workload: consensus bytes and polished
  flags equal;
- TorchAlignStage vs TpuAlignStage (interpreted) and NativeAlignStage on
  the same overlaps: identical breaking points, hence identical layers.
"""

import contextlib
import io

import numpy as np

import bench
from racon_tpu.models.polish_model import PolisherConfig
from racon_tpu.ops.consensus_stage_tpu import TpuConsensusStage
from racon_tpu.polisher import create_polisher as jax_create_polisher
from racon_tpu.utils.logger import Logger
from racon_tpu_torch.ops.consensus_stage import (TorchConsensusStage,
                                                 bucket_tiers, chunk_spans)
from racon_tpu_torch.polisher import create_polisher

import torch

torch.set_num_threads(2)


def test_consensus_stage_matches_jax_stage(monkeypatch):
    # the reference's interpret mode caps its tiers at 256 unless told to
    # run the real shapes (640/128 for these 500 bp windows)
    monkeypatch.setenv("RACON_TPU_INTERPRET_FULLCAP", "1")
    monkeypatch.setenv("RACON_TPU_CONSENSUS_ROUTE", "device")
    windows, true = bench.build_workload(n_windows=8)
    cfg = PolisherConfig(num_threads=2, match=5, mismatch=-4, gap=-8)
    with contextlib.redirect_stderr(io.StringIO()):
        port = TorchConsensusStage(cfg, "cpu")
        got, got_pol = port.consensus_windows(windows, cfg, Logger())
        want, want_pol = TpuConsensusStage(cfg, interpret=True) \
            .consensus_windows(windows, cfg, Logger())
    assert got == want
    assert got_pol == want_pol
    assert port.prof["device_items"] > 0


def test_tier_bucketing_folds_small_tiers():
    tiers = ((256, 128), (640, 128), (1280, 256))
    mlen = np.array([100, 500, 500, 1000])
    nlen = np.array([100, 510, 700, 1000])
    # first fits: (256,128); (640,128); a drift of 200 exceeds every
    # margin -> host; (1280,256). Then the lone (256,128) item folds into
    # (640,128), whose 2 items cannot fold into the 1-item (1280,256).
    ids = bucket_tiers(mlen, nlen, tiers)
    assert ids.tolist() == [1, 1, -1, 2]
    assert bucket_tiers(np.array([5000]), np.array([5000]), tiers)[0] == -1


def test_chunk_spans_cover_exactly():
    for k, step in ((0, 8), (1, 8), (8, 8), (9, 8), (1000, 409)):
        spans = chunk_spans(k, step)
        assert sum(hi - lo for lo, hi in spans) == k
        assert all(hi - lo <= step for lo, hi in spans)
        assert [lo for lo, _ in spans[1:]] == [hi for _, hi in spans[:-1]]


def _align_data(tmp_path, seed=21):
    rng = np.random.default_rng(seed)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    comp = bytes.maketrans(b"ACGT", b"TGCA")
    glen = 700
    true = rng.choice(acgt, glen)
    draft = true.copy()
    for pos in rng.choice(glen, 8, replace=False):
        draft[pos] = rng.choice(acgt)
    reads, paf = [], []
    for r in range(10):
        s = int(rng.integers(0, 80))
        e = int(rng.integers(glen - 80, glen))
        read = true[s:e].copy()
        for pos in rng.choice(len(read), len(read) // 30, replace=False):
            read[pos] = rng.choice(acgt)
        strand = b"+"
        data = read.tobytes()
        if r % 2:  # reverse-strand overlaps exercise revcomp coordinates
            data, strand = data[::-1].translate(comp), b"-"
        reads.append((b"r%d" % r, data))
        paf.append(b"\t".join([
            b"r%d" % r, b"%d" % len(read), b"0", b"%d" % len(read), strand,
            b"ctg", b"%d" % glen, b"%d" % s, b"%d" % e, b"9", b"9", b"60"]))
    (tmp_path / "reads.fasta").write_bytes(
        b"".join(b">" + n + b"\n" + d + b"\n" for n, d in reads))
    (tmp_path / "ovl.paf").write_bytes(b"\n".join(paf) + b"\n")
    (tmp_path / "draft.fasta").write_bytes(b">ctg\n" + draft.tobytes()
                                           + b"\n")
    return [str(tmp_path / f) for f in ("reads.fasta", "ovl.paf",
                                        "draft.fasta")]


def test_align_stage_matches_jax_and_native(tmp_path):
    paths = _align_data(tmp_path)
    cfg = PolisherConfig(num_threads=2, window_length=100)
    polishers = []
    with contextlib.redirect_stderr(io.StringIO()):
        port = create_polisher(*paths, PolisherConfig(
            **{**cfg.__dict__, "backend": "cuda"}), device="cpu")
        port.initialize()
        polishers.append(port)
        for backend in ("tpu", "native"):
            p = jax_create_polisher(*paths, PolisherConfig(
                **{**cfg.__dict__, "backend": backend}))
            p.initialize()
            polishers.append(p)
    assert port.align_stage.stats["device_items"] == 10
    w0 = polishers[0].windows
    for p in polishers[1:]:
        w = p.windows
        for field in ("lay_win", "lay_begin", "lay_end", "lay_qbegin",
                      "lay_qlen", "lay_strand"):
            assert np.array_equal(getattr(w0, field), getattr(w, field)), \
                field

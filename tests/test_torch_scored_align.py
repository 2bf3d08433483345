"""The scored align route of the PyTorch port (RACON_TPU_MYERS=0; plain
versions, on the CPU) against the JAX package:

- the sweep at W = 4096 (four band lanes per thread on the card) and the
  packed2 walk, against the jnp oracle nw_band_batch_ref with
  walk_moves_device (align_walk_core): payload bytes and scores equal;
- the align stage under RACON_TPU_MYERS=0, with and without
  RACON_TPU_WALK=rows, against the port's Myers route and racon_tpu's
  tpu and native stages: identical breaking points, on overlaps of which
  one drifts far enough to need a W = 4096 tier.

Integer DP, so tolerance 0 throughout."""

import contextlib
import io

import jax.numpy as jnp
import numpy as np

from racon_tpu.models.polish_model import PolisherConfig
from racon_tpu.ops.nw_kernel import (align_walk_core, encode,
                                     nw_band_batch_ref, pack_codes4,
                                     pack_delbits)
from racon_tpu.polisher import create_polisher as jax_create_polisher
from racon_tpu_torch.models.polish_model import \
    PolisherConfig as PortPolisherConfig
from racon_tpu_torch.ops import nw_kernel as port
from racon_tpu_torch.ops.batch import to_device
from racon_tpu_torch.polisher import create_polisher

import torch

torch.set_num_threads(2)
ACGT = np.frombuffer(b"ACGT", np.uint8)
PAD = 5
ALIGN = dict(match=0, mismatch=-1, gap=-1)


def test_w4096_sweep_and_packed_walk_match_jnp_oracle():
    """(4096, 4096): two items at 2 % error, one of them 1200 bases
    shorter than its target (its path drifts 1200 lanes off the
    diagonal), and one all-PAD item; unit deletion costs, the align
    stage's scores."""
    rng = np.random.default_rng(4096)
    cap, w = 4096, 4096
    B = 3
    q8 = np.full((B, cap), PAD, np.int8)
    t8 = np.full((B, cap), PAD, np.int8)
    m = np.zeros(B, np.int32)
    n = np.zeros(B, np.int32)
    for b, (tl, drift) in enumerate(((3000, 0), (3900, 1200))):
        t = rng.choice(ACGT, tl)
        q = t[rng.random(tl) >= 0.02]
        q = np.delete(q, rng.choice(len(q), drift, replace=False))
        sub = rng.random(len(q)) < 0.02
        q[sub] = rng.choice(ACGT, int(sub.sum()))
        q8[b, : len(q)] = encode(q)
        t8[b, :tl] = encode(t)
        m[b], n[b] = len(q), tl
    dc8 = np.full((B, cap), -1, np.int8)
    g = to_device(pack_codes4(q8), pack_codes4(t8), pack_delbits(dc8), m, n,
                  m_cap=cap, n_cap=cap, device="cpu")
    geo = dict(m_cap=cap, n_cap=cap, w_band=w)
    moves, score = port.nw_sweep(g.q4, g.t4, g.dcb, **geo, **ALIGN)
    payload, _, fmt = port.align_walk_padded(
        pack_codes4(q8), pack_codes4(t8), pack_delbits(dc8), m, n, **geo,
        **ALIGN, device="cpu")
    assert fmt == "packed2"
    assert np.array_equal(payload.numpy(), port.packed_walk(
        moves, g.m, g.n, **geo).numpy())
    want, want_sc = align_walk_core(
        jnp.asarray(q8), jnp.asarray(t8), jnp.asarray(dc8), jnp.asarray(m),
        jnp.asarray(n), **geo, nw_fn=nw_band_batch_ref, **ALIGN)
    assert np.array_equal(payload.numpy(), np.asarray(want))
    assert np.array_equal(score.numpy(), np.asarray(want_sc)[:B, 0])
    assert payload.numpy()[:, -1].tolist() == [0, 0, 0]
    assert n[1] - m[1] > 1100


def _align_data(tmp_path, seed=21):
    """A 2.4 kb contig and 11 reads. The contig is C/G/T with ten blocks
    of 50 A's and has 8 substitutions (C/G/T, away from the blocks). Ten
    reads of 2.2-2.4 kb carry 3 % substitutions (odd ones on the reverse
    strand); the eleventh lost the ten A blocks, so its overlap drifts
    past the (10240, 1024) tier's margin of 448 into (10240, 4096) while
    staying within the overlap filter's 30 % length difference. Every read
    has one optimal alignment, so the host aligners, whose ties break
    otherwise than the device walks', must agree: a substitution costs
    less than any indel pair, and no query base of the eleventh read
    matches a deleted A, so no block can slide or be spread by tied
    diagonals."""
    rng = np.random.default_rng(seed)
    comp = bytes.maketrans(b"ACGT", b"TGCA")
    cgt = np.frombuffer(b"CGT", np.uint8)
    glen = 2400
    true = rng.choice(cgt, glen)
    blocks = np.concatenate([np.arange(b, b + 50)
                             for b in range(200, 2200, 200)])
    true[blocks] = ord("A")
    draft = true.copy()
    draft[np.arange(320, 1920, 200)] = rng.choice(cgt, 8)
    reads, paf = [], []
    for r in range(11):
        s = int(rng.integers(0, 100))
        e = int(rng.integers(glen - 100, glen))
        read = true[s:e].copy()
        if r == 10:
            read = np.delete(read, blocks - s)
        else:
            sub = rng.random(len(read)) < 0.03
            read[sub] = rng.choice(ACGT, int(sub.sum()))
        strand = b"+"
        data = read.tobytes()
        if r % 2:
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


def test_scored_align_route_matches_myers_and_jax(tmp_path, monkeypatch):
    paths = _align_data(tmp_path)
    cfg = PolisherConfig(num_threads=2, window_length=100)
    runs = {}
    with contextlib.redirect_stderr(io.StringIO()):
        for name, env in (("myers", {}),
                          ("scored", {"RACON_TPU_MYERS": "0"}),
                          ("scored_rows", {"RACON_TPU_MYERS": "0",
                                           "RACON_TPU_WALK": "rows"})):
            for key in ("RACON_TPU_MYERS", "RACON_TPU_WALK"):
                monkeypatch.delenv(key, raising=False)
            for key, value in env.items():
                monkeypatch.setenv(key, value)
            p = create_polisher(*paths, PortPolisherConfig(
                num_threads=2, window_length=100, backend="cuda"),
                device="cpu")
            p.initialize()
            runs[name] = p
        monkeypatch.delenv("RACON_TPU_MYERS", raising=False)
        monkeypatch.delenv("RACON_TPU_WALK", raising=False)
        for backend in ("tpu", "native"):
            p = jax_create_polisher(*paths, PolisherConfig(
                **{**cfg.__dict__, "backend": backend}))
            p.initialize()
            runs[backend] = p
    tiers = {name: dict(runs[name].align_stage.stats["tier_items"])
             for name in ("myers", "scored", "scored_rows")}
    assert tiers["myers"] == {(2560, 512, "myers"): 10,
                              (10240, 4096, "myers"): 1}
    assert tiers["scored"] == {(2560, 512, "scored/rle"): 10,
                               (10240, 4096, "scored/packed2"): 1}
    assert tiers["scored_rows"] == {(2560, 512, "scored/rows"): 10,
                                    (10240, 4096, "scored/packed2"): 1}
    for name in ("myers", "scored", "scored_rows"):
        assert runs[name].align_stage.stats["host_items"] == 0, name
    w0 = runs["myers"].windows
    for name in ("scored", "scored_rows", "tpu", "native"):
        w = runs[name].windows
        for field in ("lay_win", "lay_begin", "lay_end", "lay_qbegin",
                      "lay_qlen", "lay_strand"):
            assert np.array_equal(getattr(w0, field), getattr(w, field)), \
                (name, field)

"""The consensus stage's device-gather route (J6, RACON_TPU_DEVGATHER=1)
on the CPU (device="cpu": the kernels' plain versions), against the JAX
package and the port's dense route:

- pack_gather_plain on word blobs equals racon_tpu's word-wise gathers
  (_gather_nib_cols, _gather_bit_cols, transposed and packed) and the
  port's host packers (bindings.pack_rows_nib / pack_rows_bits) over the
  same ranges, byte for byte, with odd starts, rows of length 0 and cap,
  a row ending at the blob's end and deletion-cost bits 30 % clear (where
  a byte-indexed reading, the reference's fault C1, would differ); the
  numpy model of kernels/csrc/pack_gather.cu's lanes
  (tests/test_torch_gather_lanes.py) equals it;
- align_walk_gather equals the dense align_walk_padded, and its body
  racon_tpu's gather core (align_walk_gather_core with its pure-jnp
  sweep) on the same blobs;
- the stage under RACON_TPU_DEVGATHER=1 at 1 and 2 cohorts and under a
  tiny RACON_TPU_GATHER_BLOB_ELEMS equals its dense route and racon_tpu's
  dense route, with no host row packer called; past the 2^31 guard
  (scaled down) every chunk goes dense, counted and logged;
- _auto_cohorts with gather_elems against the reference's;
- sharded_align_walk_gather on the mesh (cpu, cpu) equals the unsharded
  call.
"""

import contextlib
import functools
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from racon_tpu.models.polish_model import PolisherConfig as JaxPolisherConfig
from racon_tpu.ops.consensus_stage_tpu import TpuConsensusStage
from racon_tpu.ops.nw_kernel import (_gather_bit_cols, _gather_nib_cols,
                                     align_walk_gather_core,
                                     nw_band_batch_ref)
from racon_tpu.utils.logger import Logger
from racon_tpu_torch.models.polish_model import PolisherConfig
from racon_tpu_torch.native import bindings
from racon_tpu_torch.ops import consensus_stage as cs
from racon_tpu_torch.ops import gather
from racon_tpu_torch.ops import nw_kernel as nk
from racon_tpu_torch.ops.geometry import PAD_CODE
from racon_tpu_torch.parallel import mesh
from racon_tpu_torch.polisher import create_polisher
from test_torch_gather_lanes import _model as _lane_model

torch.set_num_threads(2)
ACGT = np.frombuffer(b"ACGT", np.uint8)
CPU = torch.device("cpu")
SCORES = dict(match=5, mismatch=-4, gap=-8)


@pytest.fixture(autouse=True)
def _no_pinned_mesh():
    mesh.clear_active_mesh()
    yield
    mesh.clear_active_mesh()


def _ranges(rng, L, B, cap):
    """(starts, lengths) of B rows in a blob of L elements: odd and even
    starts, lengths 0 and cap among them, one row ending at the blob's
    end."""
    lens = rng.integers(1, cap, B)
    lens[0], lens[1] = 0, cap
    starts = rng.integers(0, L - cap, B)
    starts[2] = L - lens[2]
    starts[3] |= 1
    return starts.astype(np.int64), lens.astype(np.int64)


def _pack_nib(c8):
    return (c8[:, 0::2] | (c8[:, 1::2] << 4)).astype(np.uint8)


@pytest.mark.parametrize("cap,B", [(256, 40), (640, 24), (5120, 6)])
def test_plain_gather_matches_packers_and_jax(cap, B):
    rng = np.random.default_rng(cap)
    L = 3 * cap + 77
    q8 = rng.integers(0, 5, L).astype(np.int8)
    t8 = rng.integers(0, 5, L + 5).astype(np.int8)
    dmask = rng.random(L + 5) >= 0.3  # 30 % of the columns free
    qs, m = _ranges(rng, L, B, cap)
    ts, n = _ranges(rng, L + 5, B, cap)
    qw, tw, dw = (gather.code_words(q8), gather.code_words(t8),
                  gather.bit_words(dmask))
    meta = np.stack([qs, m, ts, n], 1).astype(np.int32)
    got = [x.numpy() for x in gather.pack_gather(
        torch.from_numpy(qw), torch.from_numpy(tw), torch.from_numpy(dw),
        torch.from_numpy(meta), m_cap=cap, n_cap=cap)]

    # the port's host packers over the same ranges
    thr = 2
    del8 = dmask.view(np.int8)
    want = [bindings.pack_rows_nib(q8, qs, qs + m, cap, PAD_CODE, thr),
            bindings.pack_rows_nib(t8, ts, ts + n, cap, PAD_CODE, thr),
            bindings.pack_rows_bits(del8, ts, ts + n, cap, thr)]
    for g, w in zip(got, want):
        assert g.dtype == np.uint8 and np.array_equal(g, w)

    # racon_tpu's word-wise gathers on the same int32 word blobs
    j = [jnp.asarray(x) for x in (qs, m, ts, n)]
    qT = np.asarray(_gather_nib_cols(jnp.asarray(qw), j[0], j[1], cap, 0,
                                     PAD_CODE))
    tT = np.asarray(_gather_nib_cols(jnp.asarray(tw), j[2], j[3], cap, 0,
                                     PAD_CODE))
    dT = np.asarray(_gather_bit_cols(jnp.asarray(dw), j[2], j[3], cap, 1))
    assert np.array_equal(got[0], _pack_nib(qT.T.astype(np.uint8)))
    assert np.array_equal(got[1], _pack_nib(tT.T.astype(np.uint8)))
    assert np.array_equal(got[2], np.packbits(dT.T != 0, axis=1,
                                              bitorder="little"))
    # the word blob read with byte indices (fault C1: _gather_bit_rows'
    # bits[e >> 3]) would differ
    w32 = dw.view(np.uint32)
    e = ts[:, None] + np.arange(cap)
    c1 = np.where(np.arange(cap) < n[:, None],
                  (w32[np.minimum(e >> 3, len(w32) - 1)] >> (e & 7)) & 1, 1)
    assert not np.array_equal(got[2], np.packbits(c1, axis=1,
                                                  bitorder="little"))

    # the kernel's lanes (the unit rule's grouping and segments)
    for g, k in zip(got, _lane_model((qw, tw, dw), meta, cap, cap)):
        assert np.array_equal(k, g)


def _gather_case():
    """The blobs of tests/test_nw_kernel.py's gather test (seed 7, 16
    items at (256,128)) and their host-packed rows."""
    rng = np.random.default_rng(7)
    cap, B = 256, 16
    lens_q = rng.integers(40, cap, B)
    lens_t = rng.integers(40, cap, B)
    qblob = np.concatenate([rng.integers(0, 5, L).astype(np.int8)
                            for L in lens_q])
    tblob = np.concatenate([rng.integers(0, 5, L).astype(np.int8)
                            for L in lens_t])
    dmask = rng.random(len(tblob)) < 0.3
    qoff = np.concatenate([[0], np.cumsum(lens_q)])
    toff = np.concatenate([[0], np.cumsum(lens_t)])
    meta = np.stack([qoff[:-1], lens_q, toff[:-1], lens_t],
                    1).astype(np.int32)
    return qblob, tblob, dmask, meta


def _blobs(qblob, tblob, dmask):
    return [gather.put_blob(w, [CPU]) for w in (
        gather.code_words(qblob), gather.code_words(tblob),
        gather.bit_words(dmask))]


@pytest.mark.parametrize("walk", ["rle", "rows"])
def test_align_walk_gather_matches_dense(monkeypatch, walk):
    monkeypatch.setenv("RACON_TPU_WALK", walk)
    cap, band = 256, 128
    qblob, tblob, dmask, meta = _gather_case()
    geo = dict(m_cap=cap, n_cap=cap, w_band=band, **SCORES)
    payload, score, fmt = nk.align_walk_gather(
        *_blobs(qblob, tblob, dmask), meta, **geo, device="cpu")
    assert fmt == walk
    qs, m, ts, n = meta.T.astype(np.int64)
    q4 = bindings.pack_rows_nib(qblob, qs, qs + m, cap, PAD_CODE, 2)
    t4 = bindings.pack_rows_nib(tblob, ts, ts + n, cap, PAD_CODE, 2)
    dcb = bindings.pack_rows_bits(dmask.view(np.int8), ts, ts + n, cap, 2)
    want_p, want_s, want_fmt = nk.align_walk_padded(
        q4, t4, dcb, m.astype(np.int32), n.astype(np.int32), **geo,
        device="cpu")
    assert want_fmt == fmt
    assert torch.equal(payload, want_p) and torch.equal(score, want_s)


def test_gather_sweep_walk_matches_jax_gather_core():
    """The port's gather body against racon_tpu's gather core on the uint8
    test blobs (byte blobs, so its byte-indexed bit gather reads them
    right), with its pure-jnp sweep nw_band_batch_ref (bit-identical to the
    Pallas kernels; the reference's own route on CPU meshes), whose
    payload is the packed2 step stream."""
    cap, band = 256, 128
    qblob, tblob, dmask, meta = _gather_case()
    geo = dict(m_cap=cap, n_cap=cap, w_band=band, **SCORES)
    payload, score = nk.gather_sweep_walk(
        *(b[CPU] for b in _blobs(qblob, tblob, dmask)),
        torch.from_numpy(meta), **geo, fmt="packed2")
    core = jax.jit(functools.partial(align_walk_gather_core,
                                     nw_fn=nw_band_batch_ref, **geo))
    jp, js = core(gather.pack_codes4_flat(qblob),
                  gather.pack_codes4_flat(tblob),
                  gather.pack_bits_flat(dmask), meta)
    assert np.array_equal(payload.numpy(), np.asarray(jp))
    assert np.array_equal(score.numpy(), np.asarray(js).reshape(-1))


def test_sharded_gather_matches_unsharded():
    cap, band = 256, 128
    qblob, tblob, dmask, meta = _gather_case()
    blobs = _blobs(qblob, tblob, dmask)
    geo = dict(m_cap=cap, n_cap=cap, w_band=band, **SCORES)
    want_p, want_s, fmt = nk.align_walk_gather(*blobs, meta, **geo,
                                               device="cpu")
    mesh.set_active_mesh(["cpu", "cpu"])
    two = mesh.active_mesh()
    assert nk.gather_devices("cpu") == two
    payloads, scores, fmt2 = nk.align_walk_gather(*blobs, meta, **geo,
                                                  device="cpu")
    assert fmt2 == fmt and [len(p) for p in payloads] == [8, 8]
    assert torch.equal(torch.cat(payloads), want_p)
    assert torch.equal(torch.cat(scores), want_s)
    direct, _ = mesh.sharded_align_walk_gather(two, *blobs, meta[:5], **geo,
                                               fmt=fmt)
    assert [len(p) for p in direct] == [3, 2]
    assert torch.equal(torch.cat(direct), want_p[:5])


def _build_windows(d, seed=11, n_reads=14, glen=900, wlen=150):
    """tests/test_tpu_stage.py's _build_windows case, polished by the
    port: a 900 bp draft with 12 substitutions and 5 deletions, 14 reads
    at 2.5 % error; the port's windows (w = 150) and config."""
    rng = np.random.default_rng(seed)
    true = rng.choice(ACGT, glen)
    draft = true.copy()
    for pos in rng.choice(glen, 12, replace=False):
        draft[pos] = rng.choice(ACGT)
    draft = np.delete(draft, rng.choice(glen, 5, replace=False))
    reads, paf = [], []
    for r in range(n_reads):
        s = int(rng.integers(0, 120))
        e = int(rng.integers(glen - 120, glen))
        read = true[s:e].copy()
        for pos in rng.choice(len(read), len(read) // 40, replace=False):
            read[pos] = rng.choice(ACGT)
        reads.append(b">r%d\n%s\n" % (r, read.tobytes()))
        paf.append(b"r%d\t%d\t0\t%d\t+\tctg\t%d\t%d\t%d\t9\t9\t60\n"
                   % (r, len(read), len(read), len(draft), s,
                      min(len(draft), e)))
    (d / "reads.fasta").write_bytes(b"".join(reads))
    (d / "ovl.paf").write_bytes(b"".join(paf))
    (d / "draft.fasta").write_bytes(b">ctg\n" + draft.tobytes() + b"\n")
    cfg = PolisherConfig(backend="cuda", num_threads=2, window_length=wlen,
                         match=5, mismatch=-4, gap=-8)
    with contextlib.redirect_stderr(io.StringIO()):
        p = create_polisher(*(str(d / f) for f in (
            "reads.fasta", "ovl.paf", "draft.fasta")), cfg, device="cpu")
        p.initialize()
    return p.windows, cfg


def test_stage_gather_matches_dense_and_jax(tmp_path, monkeypatch):
    monkeypatch.setenv("RACON_TPU_INTERPRET_FULLCAP", "1")
    monkeypatch.setenv("RACON_TPU_CONSENSUS_ROUTE", "device")
    for k in ("RACON_TPU_DEVGATHER", "RACON_TPU_COHORTS",
              "RACON_TPU_GATHER_BLOB_ELEMS"):
        monkeypatch.delenv(k, raising=False)
    windows, cfg = _build_windows(tmp_path)
    packed = []
    for name in ("pack_rows_nib", "pack_rows_bits"):
        real = getattr(bindings, name)

        def counted(*a, _real=real, **kw):
            packed.append(1)
            return _real(*a, **kw)

        monkeypatch.setattr(bindings, name, counted)

    def run(env):
        for k, v in env.items():
            monkeypatch.setenv(k, v)
        packed.clear()
        stage = cs.TorchConsensusStage(cfg, "cpu")
        err = io.StringIO()
        with contextlib.redirect_stderr(err):
            out = stage.consensus_windows(windows, cfg, Logger())
        for k in env:
            monkeypatch.delenv(k)
        return out, stage, len(packed), err.getvalue()

    dense, st_dense, n_dense, _ = run({})
    assert not st_dense.use_gather and n_dense > 0
    assert st_dense.prof["gather_items"] == 0
    for env, coh in (({"RACON_TPU_COHORTS": "1"}, 1),
                     ({"RACON_TPU_COHORTS": "2"}, 2),
                     ({"RACON_TPU_GATHER_BLOB_ELEMS": "512"}, None)):
        out, st, n_packed, _ = run({"RACON_TPU_DEVGATHER": "1", **env})
        assert out == dense, env
        assert st.use_gather and n_packed == 0
        assert st.prof["gather_items"] == st_dense.prof["device_items"] > 0
        assert st.prof["gather_dense_chunks"] == 0
        if coh:
            assert st.n_cohorts == coh
        else:  # the layer blob split so no cohort's passes 512 elements
            assert 3 <= st.n_cohorts <= windows.num_windows
    # the guard (2^31 elements, scaled down): every chunk dense, counted
    # and logged
    monkeypatch.setattr(cs, "MAX_BLOB_ELEMS", 64)
    out, st, n_packed, err = run({"RACON_TPU_DEVGATHER": "1"})
    assert out == dense and n_packed == n_dense
    assert st.prof["gather_items"] == 0
    assert st.prof["gather_dense_chunks"] > 0
    assert "dense route" in err
    # racon_tpu's dense route (interpreted kernels, real tier shapes)
    jcfg = JaxPolisherConfig(num_threads=2, match=5, mismatch=-4, gap=-8,
                             window_length=150)
    monkeypatch.setenv("RACON_TPU_DEVGATHER", "0")
    with contextlib.redirect_stderr(io.StringIO()):
        want = TpuConsensusStage(jcfg, interpret=True).consensus_windows(
            windows, jcfg, Logger())
    assert dense == want


class _Ref(TpuConsensusStage):
    """The reference's stage, for its _auto_cohorts."""

    def __init__(self, interpret):
        super().__init__(JaxPolisherConfig(), interpret)


@pytest.mark.parametrize("device,n_active,passes,elems,cap_env,coh,want", [
    ("cpu", 100, 4, 5000, "512", None, 10),
    ("cpu", 5, 4, 5000, "512", None, 5),
    ("cpu", 100, 4, 5000, "bogus", None, 1),
    ("cpu", 100, 4, 5000, "512", "2", 2),
    ("cpu", 100, 1, 0, "512", None, 1),
    ("cuda", 200, 4, 3 * 2 ** 30 + 1, None, None, 4),
    ("cuda", 200, 4, 2 ** 30, None, None, 1),
])
def test_auto_cohorts_with_gather_elems(monkeypatch, device, n_active,
                                        passes, elems, cap_env, coh, want):
    for key, value in (("RACON_TPU_GATHER_BLOB_ELEMS", cap_env),
                       ("RACON_TPU_COHORTS", coh)):
        if value is None:
            monkeypatch.delenv(key, raising=False)
        else:
            monkeypatch.setenv(key, value)
    stage = cs.TorchConsensusStage(PolisherConfig(), device)
    assert stage._auto_cohorts(n_active, passes, gather_elems=elems) == want
    # the reference's, which does not probe the link below 256 windows
    assert _Ref(device == "cpu")._auto_cohorts(
        n_active, passes, gather_elems=elems) == want

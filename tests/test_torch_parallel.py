"""The port's multi-device path (racon_tpu_torch/parallel/mesh.py) on the
CPU: meshes of 1, 2, 3 and 8 torch.device("cpu") entries, each shard on
the kernels' plain versions, against the unsharded port and the JAX
package's own mesh path (its 8-device CPU mesh, which tier-1 runs):

- sharded_nw_band_batch and polish_step_sharded equal the unsharded
  plain path and racon_tpu.parallel.mesh's sharded_nw_band_batch /
  polish_step_sharded (interpret=True), byte for byte;
- sharded_align_walk at fmt rle, rows, packed2 and myers equals the
  unsharded dispatch, with B not a multiple of k and k > B (idle
  devices); the stages' fused calls dispatch over a pinned mesh, and
  prefetch joins the shards in order;
- active_mesh(), RACON_TPU_MESH=0, set_active_mesh / clear_active_mesh;
- both stages under a pinned 3-device mesh equal the same stages without
  one and racon_tpu's stages on its 8-device mesh.
"""

import contextlib
import io

import jax
import numpy as np
import pytest
import torch

import bench
from racon_tpu.models.polish_model import PolisherConfig as JaxPolisherConfig
from racon_tpu.ops.consensus_stage_tpu import TpuConsensusStage
from racon_tpu.ops.nw_kernel import PAD_CODE, encode
from racon_tpu.parallel import mesh as jax_mesh
from racon_tpu.polisher import create_polisher as jax_create_polisher
from racon_tpu.utils.logger import Logger
from racon_tpu_torch.models.polish_model import PolisherConfig
from racon_tpu_torch.ops import myers_kernel as mk
from racon_tpu_torch.ops import nw_kernel as nk
from racon_tpu_torch.ops import prefetch
from racon_tpu_torch.ops.batch import to_device
from racon_tpu_torch.ops.consensus_stage import TorchConsensusStage
from racon_tpu_torch.parallel import dist, mesh
from racon_tpu_torch.polisher import create_polisher

torch.set_num_threads(2)
CAP, W = 128, 64
SCORES = dict(match=5, mismatch=-4, gap=-8)
ACGT = np.frombuffer(b"ACGT", np.uint8)
CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _no_pinned_mesh():
    mesh.clear_active_mesh()
    yield
    mesh.clear_active_mesh()


def _batch(B, seed=7):
    """racon_tpu/tests/test_parallel.py's items: (q, t, gc) int32 for the
    reference, uniform deletion costs, m and n."""
    rng = np.random.default_rng(seed)
    q = np.full((B, CAP), PAD_CODE, np.int32)
    t = np.full((B, CAP), PAD_CODE, np.int32)
    gc = np.zeros((B, CAP + 1), np.int32)
    m = np.zeros(B, np.int32)
    n = np.zeros(B, np.int32)
    for b in range(B):
        nlen = int(rng.integers(40, CAP))
        mlen = int(rng.integers(max(1, nlen - 20), min(CAP, nlen + 20)))
        tb = rng.choice(ACGT, nlen)
        qb = rng.choice(ACGT, mlen)
        k = min(mlen, nlen)
        qb[:k] = tb[:k]
        for pos in rng.choice(mlen, mlen // 10, replace=False):
            qb[pos] = rng.choice(ACGT)
        q[b, :mlen] = encode(qb)
        t[b, :nlen] = encode(tb)
        gc[b, 1:] = np.cumsum(np.full(CAP, SCORES["gap"], np.int32))
        m[b], n[b] = mlen, nlen
    return q, t, gc, m, n


def _packed(q, t):
    """The port's uplink of _batch's items: nibble codes and an all-ones
    deletion bitmask (every column costs `gap`)."""
    q8, t8 = q.astype(np.uint8), t.astype(np.uint8)
    return (q8[:, 0::2] | (q8[:, 1::2] << 4), t8[:, 0::2] | (t8[:, 1::2] << 4),
            np.full((len(q), CAP // 8), 0xFF, np.uint8))


@pytest.fixture(scope="module")
def reference():
    """racon_tpu's sharded sweep and polish step on its 8-device CPU mesh
    (interpret=True), on 128 items."""
    devs = jax.devices("cpu")
    assert len(devs) >= 8
    jm = jax_mesh.window_mesh(devs[:8])
    q, t, gc, m, n = _batch(128)
    moves, score = jax_mesh.sharded_nw_band_batch(
        jm, q, t, gc, m_cap=CAP, n_cap=CAP, w_band=W, interpret=True,
        **SCORES)
    step = jax_mesh.polish_step_sharded(jm, m_cap=CAP, n_cap=CAP, w_band=W,
                                        interpret=True, **SCORES)
    codes, esc, score2 = jax.device_get(step(q, t, gc, m, n))
    return dict(batch=(q, t, gc, m, n), moves=np.asarray(moves),
                score=np.asarray(score)[:, 0], codes=np.asarray(codes),
                esc=np.asarray(esc), score2=np.asarray(score2)[:, 0])


@pytest.mark.parametrize("k", [1, 2, 3, 8])
def test_sharded_sweep_matches_unsharded_and_jax(reference, k):
    q, t, _, m, n = reference["batch"]
    q4, t4, dcb = _packed(q, t)
    geo = dict(m_cap=CAP, n_cap=CAP, w_band=W)
    moves, scores = mesh.sharded_nw_band_batch((CPU,) * k, q4, t4, dcb,
                                               **geo, **SCORES)
    assert len(moves) == k
    assert [len(x) for x in moves] == [
        hi - lo for lo, hi in (dist.shard_range(128, i, k)
                               for i in range(k))]
    b = to_device(q4, t4, dcb, m, n, m_cap=CAP, n_cap=CAP, device="cpu")
    want_mv, want_sc = nk.nw_sweep_plain(b.q4, b.t4, b.dcb, **geo, **SCORES)
    assert torch.equal(torch.cat(moves), want_mv)
    assert torch.equal(torch.cat(scores), want_sc)
    assert np.array_equal(torch.cat(moves).numpy(), reference["moves"])
    assert np.array_equal(torch.cat(scores).numpy(), reference["score"])


@pytest.mark.parametrize("k", [1, 2, 3, 8])
def test_polish_step_sharded_matches_unsharded_and_jax(reference, k):
    """The packed2 step stream at m_cap + n_cap steps: the reference's
    codes four to a byte, its escape flags, its scores."""
    q, t, _, m, n = reference["batch"]
    q4, t4, dcb = _packed(q, t)
    step = mesh.polish_step_sharded((CPU,) * k, m_cap=CAP, n_cap=CAP,
                                    w_band=W, **SCORES)
    payloads, scores = step(q4, t4, dcb, m, n)
    payload = torch.cat(payloads).numpy()
    geo = dict(m_cap=CAP, n_cap=CAP, w_band=W)
    b = to_device(q4, t4, dcb, m, n, m_cap=CAP, n_cap=CAP, device="cpu")
    mv, _ = nk.nw_sweep_plain(b.q4, b.t4, b.dcb, **geo, **SCORES)
    want = nk.packed_walk_plain(mv, b.m, b.n, **geo, max_steps=2 * CAP)
    assert np.array_equal(payload, want.numpy())
    codes = reference["codes"].astype(np.int32).reshape(128, -1, 4)
    packed = (codes << np.array([0, 2, 4, 6])).sum(-1).astype(np.uint8)
    assert np.array_equal(payload[:, :-1], packed)
    assert np.array_equal(payload[:, -1], reference["esc"].astype(np.uint8))
    assert np.array_equal(torch.cat(scores).numpy(), reference["score2"])
    assert not payload[:, -1].any()


def _items(seed, B, cap, w):
    """Packed items at (cap, cap, w): mutated pairs, every 7th all PAD,
    every 5th drifting out of the band, 30 % free deletion columns."""
    rng = np.random.default_rng(seed)
    q8 = np.full((B, cap), PAD_CODE, np.uint8)
    t8 = np.full((B, cap), PAD_CODE, np.uint8)
    m = np.zeros(B, np.int32)
    n = np.zeros(B, np.int32)
    for b in range(B):
        if b % 7 == 6:
            continue
        tl = int(rng.integers(cap // 2, cap))
        tb = rng.choice(ACGT, tl)
        qb = tb[rng.random(tl) > 0.05]
        qb = qb[: len(qb) - (w if b % 5 == 2 else 0)]
        q8[b, : len(qb)] = encode(qb)
        t8[b, :tl] = encode(tb)
        m[b], n[b] = len(qb), tl
    dc = rng.random((B, cap)) >= 0.3
    return (q8[:, 0::2] | (q8[:, 1::2] << 4), t8[:, 0::2] | (t8[:, 1::2] << 4),
            np.packbits(dc, axis=1, bitorder="little"), m, n)


def _unsharded(fmt, batch, cap, w):
    """The single-device kernels on the whole batch."""
    q4, t4, dcb, m, n = batch
    geo = dict(m_cap=cap, n_cap=cap, w_band=w)
    b = to_device(q4, t4, None if fmt == "myers" else dcb, m, n, m_cap=cap,
                  n_cap=cap, device="cpu")
    if fmt == "myers":
        payload = mk.myers_walk(mk.myers_sweep(b.q4, b.t4, **geo), b.m, b.n,
                                **geo)
        return payload, torch.zeros_like(b.m)
    moves, score = nk.nw_sweep(b.q4, b.t4, b.dcb, **geo, **SCORES)
    walk = {"rle": nk.rle_walk, "rows": nk.rows_walk,
            "packed2": nk.packed_walk}[fmt]
    return walk(moves, b.m, b.n, **geo), score


@pytest.mark.parametrize("fmt,cap,w", [("rle", 256, 128), ("rows", 256, 128),
                                       ("packed2", 256, 128),
                                       ("myers", 512, 64)])
@pytest.mark.parametrize("k,B", [(3, 11), (8, 5), (2, 16)])
def test_sharded_align_walk_matches_unsharded(fmt, cap, w, k, B):
    batch = _items(cap + w + B, B, cap, w)
    payloads, scores = mesh.sharded_align_walk(
        (CPU,) * k, *batch, m_cap=cap, n_cap=cap, w_band=w, fmt=fmt,
        **SCORES)
    sizes = [len(p) for p in payloads]
    assert sizes == [s for s in (hi - lo for lo, hi in (
        dist.shard_range(B, i, k) for i in range(k))) if s]
    assert len(payloads) == min(k, B)
    want_p, want_s = _unsharded(fmt, batch, cap, w)
    assert torch.equal(torch.cat(payloads), want_p)
    assert torch.equal(torch.cat(scores), want_s)
    assert want_p[:, -1].any() and not want_p[:, -1].all()


def test_shards_cover_the_batch():
    for k in (1, 2, 3, 8):
        devs = tuple(torch.device("cpu", i) for i in range(k))
        for B in (0, 1, 5, 8, 9, 100):
            sh = mesh.shards(devs, B)
            if B == 0:
                assert sh == [(devs[0], 0, 0)]
                continue
            assert sh[0][1] == 0 and sh[-1][2] == B
            assert all(a[2] == b[1] for a, b in zip(sh, sh[1:]))
            assert [s[0] for s in sh] == list(devs[: len(sh)])
            sizes = [hi - lo for _, lo, hi in sh]
            assert min(sizes) >= 1 and max(sizes) - min(sizes) <= 1


@pytest.mark.parametrize("fetch_threads", ["4", "0"])
def test_fused_calls_dispatch_over_pinned_mesh(monkeypatch, fetch_threads):
    """align_walk_padded and align_walk_myers_padded return one payload
    per shard on a pinned CPU mesh, and prefetch (or the inline fetch)
    joins them into the unsharded bytes; a CPU stage ignores a mesh of
    another device type."""
    monkeypatch.setenv("RACON_TPU_FETCH_THREADS", fetch_threads)
    q4, t4, dcb, m, n = _items(5, 13, 256, 128)
    geo = dict(m_cap=256, n_cap=256, w_band=128)
    want, want_sc, fmt = nk.align_walk_padded(q4, t4, dcb, m, n, **geo,
                                              **SCORES, device="cpu")
    mq4, mt4, _, mm, mn = _items(6, 13, 512, 64)
    mgeo = dict(m_cap=512, n_cap=512, w_band=64)
    mwant, _, _ = mk.align_walk_myers_padded(mq4, mt4, mm, mn, **mgeo,
                                             device="cpu")
    mesh.set_active_mesh(["cpu"] * 3)
    got, got_sc, fmt2 = nk.align_walk_padded(q4, t4, dcb, m, n, **geo,
                                             **SCORES, device="cpu")
    assert fmt2 == fmt == "rle"
    assert isinstance(got, list) and len(got) == 3
    assert torch.equal(torch.cat(got_sc), want_sc)
    assert np.array_equal(prefetch.resolve(got, prefetch.submit(got)),
                          want.numpy())
    mgot, msc, mfmt = mk.align_walk_myers_padded(mq4, mt4, mm, mn, **mgeo,
                                                 device="cpu")
    assert mfmt == "rows" and len(mgot) == 3
    assert np.array_equal(prefetch.resolve(mgot, prefetch.submit(mgot)),
                          mwant.numpy())
    assert not torch.cat(msc).any()
    mesh.set_active_mesh(["meta"] * 2)
    got, _, _ = nk.align_walk_padded(q4, t4, dcb, m, n, **geo, **SCORES,
                                     device="cpu")
    assert torch.equal(got, want)


def test_active_mesh(monkeypatch):
    """None without a GPU and with one device; the local devices when
    there are several, unless RACON_TPU_MESH=0; a pinned mesh until
    cleared."""
    monkeypatch.delenv("RACON_TPU_MESH", raising=False)
    if not torch.cuda.is_available():
        assert dist.local_devices() == ()
        assert mesh.active_mesh() is None
    two = (torch.device("cuda", 0), torch.device("cuda", 1))
    for devices, env, want in (((two[0],), None, None), (two, None, two),
                               (two, "0", None), (two, "1", two)):
        monkeypatch.setattr(dist, "local_devices", lambda d=devices: d)
        if env is None:
            monkeypatch.delenv("RACON_TPU_MESH", raising=False)
        else:
            monkeypatch.setenv("RACON_TPU_MESH", env)
        mesh.clear_active_mesh()
        assert mesh.active_mesh() == want
        assert mesh.window_mesh() == devices
    mesh.set_active_mesh(["cpu", "cpu"])
    assert mesh.active_mesh() == (CPU, CPU)
    mesh.set_active_mesh(None)
    assert mesh.active_mesh() is None
    mesh.clear_active_mesh()
    assert mesh.active_mesh() == two  # derived again (env "1")


def test_consensus_stage_on_pinned_mesh_matches(monkeypatch):
    """TorchConsensusStage on a pinned 3-device CPU mesh against itself
    without a mesh and against TpuConsensusStage on racon_tpu's
    8-device mesh (interpreted kernels, real tier shapes)."""
    monkeypatch.setenv("RACON_TPU_INTERPRET_FULLCAP", "1")
    monkeypatch.setenv("RACON_TPU_CONSENSUS_ROUTE", "device")
    jax_mesh.clear_active_mesh()
    assert jax_mesh.active_mesh().devices.size == 8
    windows, _ = bench.build_workload(n_windows=8)
    cfg = PolisherConfig(num_threads=2, match=5, mismatch=-4, gap=-8)
    jcfg = JaxPolisherConfig(num_threads=2, match=5, mismatch=-4, gap=-8)
    outs = []
    with contextlib.redirect_stderr(io.StringIO()):
        for pinned in (None, ["cpu"] * 3):
            mesh.set_active_mesh(pinned)
            stage = TorchConsensusStage(cfg, "cpu")
            outs.append(stage.consensus_windows(windows, cfg, Logger()))
            assert stage.prof["device_items"] > 0
        want = TpuConsensusStage(jcfg, interpret=True).consensus_windows(
            windows, jcfg, Logger())
    assert outs[0] == outs[1] == want


def _align_data(d, seed=21):
    """A 700 bp contig, ten reads on both strands, PAF without CIGARs."""
    rng = np.random.default_rng(seed)
    comp = bytes.maketrans(b"ACGT", b"TGCA")
    glen = 700
    true = rng.choice(ACGT, glen)
    draft = true.copy()
    for pos in rng.choice(glen, 8, replace=False):
        draft[pos] = rng.choice(ACGT)
    reads, paf = [], []
    for r in range(10):
        s = int(rng.integers(0, 80))
        e = int(rng.integers(glen - 80, glen))
        read = true[s:e].copy()
        for pos in rng.choice(len(read), len(read) // 30, replace=False):
            read[pos] = rng.choice(ACGT)
        data, strand = read.tobytes(), b"+"
        if r % 2:
            data, strand = data[::-1].translate(comp), b"-"
        reads.append((b"r%d" % r, data))
        paf.append(b"\t".join([
            b"r%d" % r, b"%d" % len(read), b"0", b"%d" % len(read), strand,
            b"ctg", b"%d" % glen, b"%d" % s, b"%d" % e, b"9", b"9", b"60"]))
    (d / "reads.fasta").write_bytes(
        b"".join(b">" + n + b"\n" + s + b"\n" for n, s in reads))
    (d / "ovl.paf").write_bytes(b"\n".join(paf) + b"\n")
    (d / "draft.fasta").write_bytes(b">ctg\n" + draft.tobytes() + b"\n")
    return [str(d / f) for f in ("reads.fasta", "ovl.paf", "draft.fasta")]


def test_align_stage_on_pinned_mesh_matches(tmp_path):
    """The align stage (Myers route) on a pinned 3-device CPU mesh: the
    same windows, layer for layer, as without a mesh and as racon_tpu's
    tpu backend on its 8-device mesh."""
    paths = _align_data(tmp_path)
    jax_mesh.clear_active_mesh()
    assert jax_mesh.active_mesh().devices.size == 8
    windows = []
    with contextlib.redirect_stderr(io.StringIO()):
        for pinned in (None, ["cpu"] * 3):
            mesh.set_active_mesh(pinned)
            p = create_polisher(*paths, PolisherConfig(
                num_threads=2, window_length=100, backend="cuda"),
                device="cpu")
            p.initialize()
            assert p.align_stage.stats["device_items"] == 10
            windows.append(p.windows)
        p = jax_create_polisher(*paths, JaxPolisherConfig(
            num_threads=2, window_length=100, backend="tpu"))
        p.initialize()
        windows.append(p.windows)
    for w in windows[1:]:
        for field in ("lay_win", "lay_begin", "lay_end", "lay_qbegin",
                      "lay_qlen", "lay_strand"):
            assert np.array_equal(getattr(windows[0], field),
                                  getattr(w, field)), field

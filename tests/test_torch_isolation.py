"""racon_tpu_torch stands alone:

- no module of the port and no line of chip_smoke.py imports jax or
  racon_tpu (an ast scan);
- with both made unimportable, every module of the port imports, the
  port polishes a synthetic case (device="cpu"), and the wrapper of its
  companion tools polishes the quick synthetic case;
- the port's copy of the native runtime agrees with racon_tpu's;
- without a GPU, "auto" (the default) raises like "cuda": the port never
  falls back to the host by itself.
"""

import ast
import contextlib
import io
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from racon_tpu.native import bindings as jax_bindings
from racon_tpu_torch import cli
from racon_tpu_torch.backends import BackendUnavailable, resolve_backend
from racon_tpu_torch.native import bindings

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "racon_tpu_torch")
ACGT = np.frombuffer(b"ACGT", np.uint8)


def _imported_roots(path):
    """Top-level package of every absolute import in a Python file."""
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_no_import_of_jax_or_racon_tpu():
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(PORT):
        files += [os.path.join(root, f) for f in names if f.endswith(".py")]
    assert len(files) > 30
    assert os.path.join(PORT, "ops", "prefetch.py") in files
    assert os.path.join(PORT, "ops", "gather.py") in files
    for name in ("__init__.py", "dist.py", "mesh.py"):
        assert os.path.join(PORT, "parallel", name) in files
    assert os.path.join(PORT, "testing", "dist_polish.py") in files
    for name in ("__init__.py", "cli.py", "preprocess.py", "rampler.py",
                 "wrapper.py"):
        assert os.path.join(PORT, "tools", name) in files
    assert os.path.join(PORT, "benchmarks", "genome_scale.py") in files
    bad = [(os.path.relpath(f, REPO), mod) for f in files
           for mod in _imported_roots(f) if mod in ("jax", "racon_tpu")]
    assert not bad


def test_port_polishes_with_jax_and_racon_tpu_blocked(tmp_path):
    code = textwrap.dedent(f"""
        import sys
        sys.modules["jax"] = sys.modules["racon_tpu"] = None
        import contextlib, importlib, io, pkgutil
        import racon_tpu_torch
        names = [mod.name for mod in pkgutil.walk_packages(
            racon_tpu_torch.__path__, "racon_tpu_torch.")]
        for name in names:
            importlib.import_module(name)
        assert "racon_tpu_torch.tools.wrapper" in names
        assert "racon_tpu_torch.benchmarks.genome_scale" in names
        assert "racon_tpu_torch.ops.gather" in names
        from racon_tpu_torch.models.polish_model import PolisherConfig
        from racon_tpu_torch.native import bindings
        from racon_tpu_torch.polisher import create_polisher
        from racon_tpu_torch.testing.synth import make_dataset
        wd = {str(tmp_path)!r}
        true = make_dataset(wd, 6000, 2000, 8, 0.06, seed=3)
        paths = [wd + "/" + f for f in ("reads.fasta", "ovl.paf",
                                        "draft.fasta")]
        cfg = PolisherConfig(backend="cuda", num_threads=2)
        with contextlib.redirect_stderr(io.StringIO()):
            p = create_polisher(*paths, cfg, device="cpu")
            p.initialize()
            out = p.polish(True)
        draft = open(paths[2], "rb").read().split(b"\\n")[1]
        assert len(out) == 1
        before = bindings.edit_distance(draft, true.tobytes())
        after = bindings.edit_distance(out[0][1], true.tobytes())
        assert after < before, (before, after)
        assert not [m for m in sys.modules
                    if m.split(".")[0] in ("jax", "racon_tpu")
                    and sys.modules[m] is not None]
        print(before, after)
    """)
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         env=env, timeout=600)
    assert res.returncode == 0, res.stderr.decode()[-2000:]


def test_wrapper_runs_with_jax_and_racon_tpu_blocked(tmp_path):
    """tools.wrapper.main(..., device="cpu") on the quick synthetic case in
    a process where jax and racon_tpu cannot be imported: its stdout is
    the port's FASTA, and it removes its work directory."""
    from tests.test_torch_e2e import _synthetic_case

    from racon_tpu_torch.models.polish_model import PolisherConfig
    from racon_tpu_torch.polisher import create_polisher

    paths = _synthetic_case(tmp_path)
    code = textwrap.dedent(f"""
        import sys
        sys.modules["jax"] = sys.modules["racon_tpu"] = None
        from racon_tpu_torch.tools import wrapper
        rc = wrapper.main(["--backend", "cuda", "-t", "2", *{paths!r}],
                          device="cpu")
        assert rc == 0
        assert not [m for m in sys.modules
                    if m.split(".")[0] in ("jax", "racon_tpu")
                    and sys.modules[m] is not None]
    """)
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         env=env, timeout=600, cwd=tmp_path)
    assert res.returncode == 0, res.stderr.decode()[-2000:]
    assert not [d for d in os.listdir(tmp_path)
                if d.startswith("racon_work_directory_")]
    # the wrapper's scores: m=5 x=-4 g=-8, quality threshold 10
    cfg = PolisherConfig(backend="cuda", num_threads=2, match=5,
                         mismatch=-4, gap=-8)
    with contextlib.redirect_stderr(io.StringIO()):
        p = create_polisher(*paths, cfg, device="cpu")
        p.initialize()
        want = p.polish(True)
    assert res.stdout == b"".join(b">" + n + b"\n" + d + b"\n"
                                  for n, d in want)


def _edit_distance(bind, tmp_path):
    rng = np.random.default_rng(1)
    a = rng.choice(ACGT, 3000)
    b = np.delete(a, rng.choice(3000, 90, replace=False))
    b[rng.choice(len(b), 60, replace=False)] = ord("A")
    return [bind.edit_distance(a, b), bind.edit_distance(a.tobytes(), b"")]


def _parse_fastx(bind, tmp_path):
    path = tmp_path / "r.fastq"
    path.write_bytes(b"@r1 x\nACGTN\n+\n!!#%&\n@r2\nGGA\n+\n~~~\n")
    return list(bind.parse_fastx(str(path), True))


def _parse_overlaps(bind, tmp_path):
    path = tmp_path / "o.paf"
    path.write_bytes(b"r1\t100\t0\t90\t+\tctg\t1000\t10\t100\t80\t90\t60\n"
                     b"r2\t200\t5\t200\t-\tctg\t1000\t500\t700\t9\t9\t0\n")
    return list(bind.parse_overlaps(str(path), 0))


def _poa_round_batch(bind, tmp_path):
    """One merge round: four noisy layers over a 300 bp backbone, aligned
    with the per-column aligner of the same runtime."""
    rng = np.random.default_rng(4)
    bb = rng.choice(ACGT, 300)
    layers = []
    for _ in range(4):
        q = np.delete(bb, rng.choice(300, 6, replace=False))
        q = np.insert(q, rng.choice(len(q), 6), rng.choice(ACGT, 6))
        q[rng.choice(len(q), 6, replace=False)] = ord("C")
        layers.append(q.astype(np.uint8))
    lay_blob = np.concatenate(layers)
    lay_off = np.zeros(5, np.int64)
    np.cumsum([len(q) for q in layers], out=lay_off[1:])
    t_blob = np.tile(bb, 4)
    t_off = np.arange(5, dtype=np.int64) * 300
    ops, ops_off, _ = bind.align_batch_percol(
        lay_blob, lay_off, t_blob, t_off, np.full(1200, -8, np.int32), 5, -4,
        -8, 1)
    (blob, _, out_len, dels, slots, pol, fin, fin_len, fin_pol,
     conv) = bind.poa_round_batch(
        bb, np.array([0, 300], np.int64), np.zeros(300, np.int32),
        np.array([0, 4], np.int64), lay_blob, lay_off,
        np.ones(len(lay_blob), np.int32), np.zeros(4, np.int32), ops, ops_off,
        False, True, True, -8, 0.15, 2, 1024, np.zeros(1, np.int64),
        np.zeros(1, np.int32), 1, np.array([1112], np.int64),
        with_final=True)
    k, f = int(out_len[0]), int(fin_len[0])
    # an intermediate round: the expanded backbone with its deletion costs
    # and slot map, and the would-be final consensus
    return [ops, ops_off, out_len, pol, blob[:k], dels[:k], slots[:k],
            fin_len, fin_pol, conv, fin[:f]]


@pytest.mark.parametrize("call", [_edit_distance, _parse_fastx,
                                  _parse_overlaps, _poa_round_batch],
                         ids=["edit_distance", "parse_fastx",
                              "parse_overlaps", "poa_round_batch"])
def test_native_runtime_copy_matches_racon_tpu(call, tmp_path):
    got = call(bindings, tmp_path)
    want = call(jax_bindings, tmp_path)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert np.array_equal(np.asarray(g), np.asarray(w))
    assert any(np.size(g) for g in got)


def test_auto_backend_needs_a_gpu(tmp_path):
    """"auto" and "cuda" raise without a GPU; the CLI's default backend
    exits 1 with the message, after racon's own argument checks."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: auto resolves to cuda")
    for name in ("auto", "cuda"):
        with pytest.raises(BackendUnavailable, match="no CUDA device"):
            resolve_backend(name)
    assert resolve_backend("native") == "native"
    reads = tmp_path / "r.fasta"
    reads.write_text(">r\nACGT\n")
    paf = tmp_path / "o.paf"
    paf.write_text("")
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        code = cli.main([str(reads), str(paf), str(reads)])
    assert code == 1
    assert "no CUDA device" in err.getvalue()

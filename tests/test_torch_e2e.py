"""The port end to end on the CPU (device="cpu": the kernels' plain
versions):

- its FASTA on a small synthetic case equals racon_tpu's with
  --backend tpu (interpreted kernels), byte for byte;
- racon_tpu_torch imports and polishes with jax made unimportable;
- --backend cuda without a GPU exits 1 with a message;
- the CLI error probes and --version of tests/test_cli_errors.py hold for
  both entry points.
"""

import contextlib
import io
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from racon_tpu import cli as jax_cli
from racon_tpu.errors import RaconError as JaxRaconError
from racon_tpu.models.polish_model import PolisherConfig as JaxPolisherConfig
from racon_tpu.polisher import create_polisher as jax_create_polisher
from racon_tpu_torch import cli as torch_cli
from racon_tpu_torch.errors import RaconError
from racon_tpu_torch.models.polish_model import PolisherConfig
from racon_tpu_torch.polisher import create_polisher

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _synthetic_case(d):
    """The quick synthetic case: a 1.5 kb contig with 20 substitutions,
    15 reads at 2 % error, PAF overlaps without CIGARs."""
    rng = np.random.default_rng(7)
    true = rng.choice(list(b"ACGT"), 1500).astype(np.uint8)
    draft = true.copy()
    for pos in rng.choice(1500, 20, replace=False):
        draft[pos] = rng.choice(list(b"ACGT"))
    reads, paf = [], []
    for r in range(15):
        s = int(rng.integers(0, 300))
        e = int(rng.integers(1200, 1500))
        read = true[s:e].copy()
        for pos in rng.choice(len(read), len(read) // 50, replace=False):
            read[pos] = rng.choice(list(b"ACGT"))
        reads.append((f"read{r}".encode(), read.tobytes()))
        paf.append(b"\t".join([
            f"read{r}".encode(), b"%d" % len(read), b"0", b"%d" % len(read),
            b"+", b"ctg", b"1500", b"%d" % s, b"%d" % e, b"9", b"9",
            b"60"]))
    (d / "reads.fasta").write_bytes(
        b"".join(b">" + n + b"\n" + s + b"\n" for n, s in reads))
    (d / "ovl.paf").write_bytes(b"\n".join(paf) + b"\n")
    (d / "draft.fasta").write_bytes(b">ctg\n" + draft.tobytes() + b"\n")
    return [str(d / f) for f in ("reads.fasta", "ovl.paf", "draft.fasta")]


def _polish(create, paths, cfg, **kw):
    with contextlib.redirect_stderr(io.StringIO()):
        p = create(*paths, cfg, **kw)
        p.initialize()
        return p.polish(True)


def test_fasta_matches_racon_tpu(tmp_path, monkeypatch):
    paths = _synthetic_case(tmp_path)
    got = _polish(create_polisher, paths,  # --no-trimming
                  PolisherConfig(backend="cuda", num_threads=2, trim=False),
                  device="cpu")
    # the reference's interpreted stages, at the real tier shapes
    monkeypatch.setenv("RACON_TPU_INTERPRET_FULLCAP", "1")
    monkeypatch.setenv("RACON_TPU_CONSENSUS_ROUTE", "device")
    want = _polish(jax_create_polisher, paths,
                   JaxPolisherConfig(backend="tpu", num_threads=2,
                                     trim=False))
    assert got == want
    assert len(got) == 1 and len(got[0][1]) > 1400


def test_port_runs_with_jax_blocked(tmp_path):
    paths = _synthetic_case(tmp_path)
    code = textwrap.dedent(f"""
        import sys
        # any import of jax or of the JAX package now fails
        sys.modules["jax"] = sys.modules["racon_tpu"] = None
        import contextlib, io
        from racon_tpu_torch.models.polish_model import PolisherConfig
        from racon_tpu_torch.polisher import create_polisher
        cfg = PolisherConfig(backend="cuda", num_threads=2, trim=False)
        with contextlib.redirect_stderr(io.StringIO()):
            p = create_polisher(*{paths!r}, cfg, device="cpu")
            p.initialize()
            out = p.polish(True)
        assert not [m for m in sys.modules
                    if m.split(".")[0] in ("jax", "racon_tpu")
                    and sys.modules[m] is not None]
        sys.stdout.buffer.write(out[0][1])
    """)
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         env=env, timeout=600)
    assert res.returncode == 0, res.stderr.decode()[-2000:]
    want = _polish(create_polisher, paths,
                   PolisherConfig(backend="cuda", num_threads=2, trim=False),
                   device="cpu")
    assert res.stdout == want[0][1]


def test_cuda_backend_without_gpu_exits_1(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the cuda backend is available")
    paths = _synthetic_case(tmp_path)
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        code = torch_cli.main(["--backend", "cuda", *paths])
    assert code == 1
    assert "no CUDA device" in err.getvalue()


def _run(main, argv):
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        try:
            code = main(argv)
        except SystemExit as e:
            code = e.code
    return code, err.getvalue()


ENTRY = pytest.mark.parametrize("main", [jax_cli.main, torch_cli.main],
                                ids=["racon_tpu", "racon_tpu_torch"])


@ENTRY
def test_window_length_error(tmp_path, main):
    f = tmp_path / "x.fasta"
    f.write_text(">a\nACGT\n")
    o = tmp_path / "x.paf"
    o.write_text("")
    code, err = _run(main, ["-w", "0", str(f), str(o), str(f)])
    assert code != 0
    assert "[racon::createPolisher] error: invalid window length!" in err


@ENTRY
def test_sequences_extension_error(tmp_path, main):
    bad = tmp_path / "reads.txt"
    bad.write_text("")
    ok = tmp_path / "t.fasta"
    ok.write_text(">a\nACGT\n")
    paf = tmp_path / "o.paf"
    paf.write_text("")
    code, err = _run(main, [str(bad), str(paf), str(ok)])
    assert code != 0
    assert ("[racon::createPolisher] error: file %s has unsupported format "
            "extension (valid extensions: .fasta, .fasta.gz, .fna, .fna.gz, "
            ".fa, .fa.gz, .fastq, .fastq.gz, .fq, .fq.gz)!" % bad) in err


@ENTRY
def test_overlaps_extension_error(tmp_path, main):
    ok = tmp_path / "t.fasta"
    ok.write_text(">a\nACGT\n")
    bad = tmp_path / "o.txt"
    bad.write_text("")
    code, err = _run(main, [str(ok), str(bad), str(ok)])
    assert code != 0
    assert ("[racon::createPolisher] error: file %s has unsupported format "
            "extension (valid extensions: .mhap, .mhap.gz, .paf, .paf.gz, "
            ".sam, .sam.gz)!" % bad) in err


@ENTRY
def test_target_extension_error(tmp_path, main):
    ok = tmp_path / "t.fasta"
    ok.write_text(">a\nACGT\n")
    paf = tmp_path / "o.paf"
    paf.write_text("")
    bad = tmp_path / "target.txt"
    bad.write_text("")
    code, err = _run(main, [str(ok), str(paf), str(bad)])
    assert code != 0
    assert ("[racon::createPolisher] error: file %s has unsupported format "
            "extension" % bad) in err


@pytest.mark.parametrize(
    "create,config,error",
    [(jax_create_polisher, JaxPolisherConfig, JaxRaconError),
     (create_polisher, PolisherConfig, RaconError)],
    ids=["racon_tpu", "racon_tpu_torch"])
def test_invalid_type_error(create, config, error):
    with pytest.raises(error, match=r"\[racon::createPolisher\] "
                                    r"error: invalid polisher type!"):
        create("a.fasta", "b.paf", "c.fasta",
               config(type=3, backend="native"))


@ENTRY
def test_version_flag(capsys, main):
    code, _ = _run(main, ["--version"])
    assert code in (0, None)
    assert capsys.readouterr().out.strip() == "v1.4.17"

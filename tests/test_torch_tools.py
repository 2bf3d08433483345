"""The port's companion tools (racon_tpu_torch/tools) against racon_tpu's
(racon_tpu/tools), the cases of tests/test_tools.py: rampler's split and
subsample and the paired-end preprocessor write the same bytes on the
same inputs and seed; the wrapper's --split run on device="cpu" (the
cuda backend's plain versions) prints racon_tpu's wrapper's stdout
(--backend tpu, interpreted kernels) and removes its work directory;
without a GPU, --backend cuda exits 1 and never falls back to the host."""

import contextlib
import gzip
import io
import os

import numpy as np
import pytest
import torch

from racon_tpu.tools import preprocess as jax_preprocess
from racon_tpu.tools import rampler as jax_rampler
from racon_tpu.tools import wrapper as jax_wrapper
from racon_tpu_torch.tools import cli, preprocess, rampler, wrapper

torch.set_num_threads(2)
ACGT = np.frombuffer(b"ACGT", np.uint8)


def _fastq(d):
    rng = np.random.default_rng(3)
    path = d / "reads.fastq"
    with open(path, "wb") as f:
        for i in range(40):
            data = rng.choice(ACGT, 100).tobytes()
            qual = bytes(rng.integers(33, 74, 100).astype(np.uint8))
            f.write(b"@read%d\n%s\n+\n%s\n" % (i, data, qual))
    return str(path)


def _fasta_oversized(d):
    path = d / "seqs.fasta"
    path.write_bytes(b">a\n" + b"A" * 500 + b"\n>b\n" + b"C" * 50 + b"\n")
    return str(path)


def _fasta_gz(d):
    path = d / "seqs.fasta.gz"
    with gzip.open(path, "wb") as f:
        f.write(b">s1\nACGTACGT\n>s2\nTTTT\n")
    return str(path)


def _both(tmp_path, call):
    """call(tool module, input directory, output directory) for both
    packages, each on its own copy of the inputs; (port's, racon_tpu's)
    output paths relative to their output directory, and their bytes."""
    runs = []
    for name, mod in (("port", rampler), ("jax", jax_rampler)):
        d = tmp_path / name
        (d / "out").mkdir(parents=True)
        paths = call(mod, d, str(d / "out"))
        runs.append([(os.path.basename(p), open(p, "rb").read())
                     for p in paths])
    return runs


@pytest.mark.parametrize("case", [
    ("split", _fastq, (1000,)),
    ("split", _fasta_oversized, (100,)),
    ("subsample", _fastq, (400, ["5"], 11)),
    ("subsample", _fastq, (4000, ["100"], 1)),
    ("subsample", _fastq, (400, ["1", "3", "7"], 0)),
    ("subsample", _fasta_gz, (12, ["1"], 0)),
], ids=["split_fastq", "split_oversized", "subsample_5x",
        "subsample_capped", "subsample_three", "subsample_gz"])
def test_rampler_matches_racon_tpu(tmp_path, case):
    mode, make, args = case

    def call(mod, d, out):
        src = make(d)
        if mode == "split":
            return mod.split(src, *args, out)
        ref_len, covs, seed = args
        return mod.subsample(src, ref_len, covs, out, seed=seed)

    got, want = _both(tmp_path, call)
    assert got == want and got
    assert all(body for _, body in got)
    if make is _fastq and mode == "split":
        # 40 x 100 bp into <= 1000-byte chunks: 4 files of 10 records
        assert [n for n, _ in got] == [f"reads_{i}.fastq" for i in range(4)]
    if make is _fasta_gz:
        assert got == [("seqs_1x.fasta", b">s1\nACGTACGT\n>s2\nTTTT\n")]


def test_rampler_cli_matches_racon_tpu(tmp_path):
    """The console form: `raconx-torch-tools subsample` with --seed and
    -o, and an invalid mode (exit 1)."""
    outs = []
    for name, main in (("port", lambda a: cli.main(["subsample", *a])),
                       ("jax", lambda a: jax_rampler.main(["subsample",
                                                           *a]))):
        d = tmp_path / name
        d.mkdir()
        src = _fastq(d)
        with contextlib.redirect_stdout(io.StringIO()):
            assert main(["-o", str(d), "--seed", "5", src, "400", "2"]) == 0
        outs.append((d / "reads_2x.fastq").read_bytes())
    assert outs[0] == outs[1] and outs[0]
    err = io.StringIO()
    with contextlib.redirect_stderr(err), \
            contextlib.redirect_stdout(io.StringIO()):
        assert cli.main(["split", "x.fasta"]) == 1
        assert cli.main(["nosuchtool"]) == 1
    assert "invalid mode" in err.getvalue()
    assert "unknown tool 'nosuchtool'" in err.getvalue()


@pytest.mark.parametrize("files", [
    {"r1.fastq": "@p extra\nACGT\n+\nIIII\n@q\nGG\n+\nII\n",
     "r2.fastq": "@p\nTTTT\n+\nIIII\n"},
    {"r.fastq": "@m\nAC\nGT\n+\nII\nII\n"},
], ids=["pairs", "multiline"])
def test_preprocess_matches_racon_tpu(tmp_path, files):
    outs = []
    for mod in (preprocess, jax_preprocess):
        seen: set = set()
        out = io.StringIO()
        for fname, text in files.items():
            p = tmp_path / fname
            p.write_text(text)
            mod.parse_file(str(p), seen, out)
        outs.append(out.getvalue())
    assert outs[0] == outs[1]
    assert outs[0].startswith("@p1\n" if "r1.fastq" in files else "@m1\n")


def _two_contigs(d):
    """tests/test_tools.py's wrapper case: two 1 kb contigs with 15
    substitutions each, 12 error-free 600 bp reads apiece, PAF overlaps."""
    rng = np.random.default_rng(5)
    true = rng.choice(ACGT, 2000)
    draft = true.copy()
    for pos in rng.choice(2000, 30, replace=False):
        draft[pos] = rng.choice(ACGT)
    reads, paf = [], []
    for ctg in range(2):
        base = 1000 * ctg
        for r in range(12):
            s = base + (r % 4) * 200
            e = min(base + 1000, s + 600)
            read = true[s:e].copy()
            rid = f"read{ctg}_{r}".encode()
            reads.append(b">%s\n%s\n" % (rid, read.tobytes()))
            paf.append(b"\t".join([
                rid, b"%d" % len(read), b"0", b"%d" % len(read), b"+",
                b"ctg%d" % ctg, b"1000", b"%d" % (s - base),
                b"%d" % (e - base), b"9", b"9", b"255"]) + b"\n")
    (d / "reads.fasta").write_bytes(b"".join(reads))
    (d / "ovl.paf").write_bytes(b"".join(paf))
    (d / "draft.fasta").write_bytes(
        b">ctg0\n" + draft[:1000].tobytes() + b"\n>ctg1\n"
        + draft[1000:].tobytes() + b"\n")
    return true


ARGS = ["--split", "1000", "-t", "2", "reads.fasta", "ovl.paf",
        "draft.fasta"]


def test_wrapper_split_matches_racon_tpu(tmp_path, monkeypatch,
                                         capfdbinary):
    true = _two_contigs(tmp_path)
    monkeypatch.chdir(tmp_path)
    assert wrapper.main(["--backend", "cuda", *ARGS], device="cpu") == 0
    got, err = capfdbinary.readouterr()
    assert b"total number of splits: 2" in err
    assert not [d for d in os.listdir(tmp_path)
                if d.startswith("racon_work_directory_")]
    # the reference's interpreted stages, at the real tier shapes
    monkeypatch.setenv("RACON_TPU_INTERPRET_FULLCAP", "1")
    monkeypatch.setenv("RACON_TPU_CONSENSUS_ROUTE", "device")
    assert jax_wrapper.main(["--backend", "tpu", *ARGS]) == 0
    want, _ = capfdbinary.readouterr()
    assert got == want
    recs = [r for r in got.split(b">") if r]
    assert [r.split(b" ")[0] for r in recs] == [b"ctg0", b"ctg1"]
    for k, r in enumerate(recs):
        seq = r.split(b"\n", 1)[1].replace(b"\n", b"")
        assert seq == true[1000 * k : 1000 * (k + 1)].tobytes()


def test_wrapper_cuda_without_gpu_exits_1(tmp_path, monkeypatch,
                                          capfdbinary):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the cuda backend is available")
    _two_contigs(tmp_path)
    monkeypatch.chdir(tmp_path)
    for backend in (["--backend", "cuda"], []):  # auto = cuda
        with pytest.raises(SystemExit) as e:
            wrapper.main([*backend, *ARGS])
        assert e.value.code == 1
        _, err = capfdbinary.readouterr()
        assert b"no CUDA device" in err
        assert b"processing data with racon" in err
    assert not [d for d in os.listdir(tmp_path)
                if d.startswith("racon_work_directory_")]

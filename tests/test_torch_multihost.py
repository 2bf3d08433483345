"""The port polishing in several processes (racon_tpu_torch/parallel/dist.py
and the Polisher's shard/gather branches) on the CPU, against one
process and against racon_tpu (racon_tpu/tests/test_multihost.py's
checks):

- two gloo processes (racon_tpu_torch.testing.dist_polish, a file://
  rendezvous in tmp_path) polish with --backend native, and with the
  cuda backend on device="cpu" over a 4-device CPU mesh each (dist x
  mesh): rank 0's FASTA equals the single-process port's and racon_tpu's
  single-process FASTA (native; tpu with interpreted kernels), byte for
  byte, and each rank aligned and polished only its shard;
- `python -m torch.distributed.run --standalone --nproc-per-node 2 -m
  racon_tpu_torch.cli --distributed --backend native`, and the same
  with RACON_TPU_DISTRIBUTED=1: rank 0's stdout is exactly the FASTA,
  the other rank prints nothing;
- dist_polish's main and the CLI's distributed main leave no process
  group behind when they return: a group left to the interpreter's exit
  let gloo abort a rank there (SIGABRT after its report was written).
"""

import contextlib
import io
import json
import os
import signal
import socket
import subprocess
import sys

import numpy as np
import pytest

from racon_tpu.models.polish_model import PolisherConfig as JaxPolisherConfig
from racon_tpu.polisher import create_polisher as jax_create_polisher
from racon_tpu_torch.models.polish_model import PolisherConfig
from racon_tpu_torch.polisher import create_polisher

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARGV = ["-m", "5", "-x", "-4", "-g", "-8", "--refine-passes", "2", "-t", "1"]
CFG = dict(num_threads=1, match=5, mismatch=-4, gap=-8, refine_passes=2)


def _dataset(d, seed=11):
    """A 3 kb contig with 45 substitutions, 20 reads of 1.2-2 kb at 2.5 %
    error on both strands (the align stage's (2560,512) tier), PAF
    without CIGARs: six 500 bp windows."""
    rng = np.random.default_rng(seed)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    comp = bytes.maketrans(b"ACGT", b"TGCA")
    glen = 3000
    true = rng.choice(acgt, glen)
    draft = true.copy()
    for pos in rng.choice(glen, 45, replace=False):
        draft[pos] = rng.choice(acgt)
    reads, paf = [], []
    for r in range(20):
        s = int(rng.integers(0, 1000))
        e = min(glen, s + int(rng.integers(1200, 2000)))
        read = true[s:e].copy()
        for pos in rng.choice(len(read), len(read) // 40, replace=False):
            read[pos] = rng.choice(acgt)
        data, strand = read.tobytes(), b"+"
        if r % 3 == 1:
            data, strand = data[::-1].translate(comp), b"-"
        reads.append((b"read%d" % r, data))
        paf.append(b"\t".join([
            b"read%d" % r, b"%d" % len(read), b"0", b"%d" % len(read),
            strand, b"ctg", b"%d" % glen, b"%d" % s, b"%d" % e, b"9", b"9",
            b"60"]))
    (d / "reads.fasta").write_bytes(
        b"".join(b">" + n + b"\n" + s + b"\n" for n, s in reads))
    (d / "ovl.paf").write_bytes(b"\n".join(paf) + b"\n")
    (d / "draft.fasta").write_bytes(b">ctg\n" + draft.tobytes() + b"\n")
    return [str(d / f) for f in ("reads.fasta", "ovl.paf", "draft.fasta")]


def _fasta(records):
    return b"".join(b">" + n + b"\n" + d + b"\n" for n, d in records)


def _polish(create, paths, cfg, **kw):
    with contextlib.redirect_stderr(io.StringIO()):
        p = create(*paths, cfg, **kw)
        p.initialize()
        return _fasta(p.polish(True))


def _env():
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    for var in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK",
                "LOCAL_RANK", "LOCAL_WORLD_SIZE", "RACON_TPU_DISTRIBUTED"):
        env.pop(var, None)
    return env


def _run(cmds, env, timeout=240):
    """One process (and its own process group) per command; each waited
    for within `timeout` seconds; on a failure or a hang every peer's
    group is killed. Returns their (stdout, stderr)."""
    procs = [subprocess.Popen(cmd, env=env, cwd=REPO, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, start_new_session=True)
             for cmd in cmds]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=timeout)
            assert p.returncode == 0, err.decode()[-3000:]
            outs.append((out, err))
    finally:
        for p in procs:
            if p.poll() is None:
                os.killpg(p.pid, signal.SIGKILL)
                p.wait()
    return outs


def _two_ranks(tmp_path, paths, polish_argv, worker_args=()):
    report = tmp_path / "report"
    init = (tmp_path / "rendezvous").as_uri()
    _run([[sys.executable, "-m", "racon_tpu_torch.testing.dist_polish",
           "--report", str(report), "--init-method", init, "--world-size",
           "2", "--rank", str(r), *worker_args, "--", *polish_argv, *paths]
          for r in range(2)], _env())
    ranks = [json.loads((report / f"rank{r}.json").read_text())
             for r in range(2)]
    assert [(x["world_size"], x["rank"]) for x in ranks] == [(2, 0), (2, 1)]
    assert [x["records"] for x in ranks] == [1, 0]
    return ranks, (report / "polished.fasta").read_bytes()


def test_two_process_native_polish_matches_single(tmp_path):
    paths = _dataset(tmp_path)
    _, got = _two_ranks(tmp_path, paths, ["--backend", "native", *ARGV])
    assert got.startswith(b">ctg")
    assert got == _polish(create_polisher, paths,
                          PolisherConfig(backend="native", **CFG))
    assert got == _polish(jax_create_polisher, paths,
                          JaxPolisherConfig(backend="native", **CFG))


def test_dist_times_mesh_polish_matches_single(tmp_path, monkeypatch):
    """Two processes, each splitting its shard's batches over its own
    4-device CPU mesh, give the single-process FASTA of the cuda backend
    (device="cpu", no mesh) and racon_tpu's tpu backend."""
    paths = _dataset(tmp_path)
    ranks, got = _two_ranks(tmp_path, paths, ["--backend", "cuda", *ARGV],
                            ["--device", "cpu", "--cpu-mesh", "4"])
    for x in ranks:
        assert x["mesh"] == ["cpu"] * 4 and x["stage_device"] == "cpu"
        assert 0 < x["align_items"] < 20 and 0 < x["consensus_windows"] < 6
    assert sum(x["align_items"] for x in ranks) == 20
    assert sum(x["consensus_windows"] for x in ranks) == 6
    assert got == _polish(create_polisher, paths,
                          PolisherConfig(backend="cuda", **CFG),
                          device="cpu")
    # the reference's interpreted stages, at the real tier shapes
    monkeypatch.setenv("RACON_TPU_INTERPRET_FULLCAP", "1")
    monkeypatch.setenv("RACON_TPU_CONSENSUS_ROUTE", "device")
    assert got == _polish(jax_create_polisher, paths,
                          JaxPolisherConfig(backend="tpu", **CFG))


@pytest.mark.parametrize("switch", ["flag", "env"])
def test_torchrun_cli_prints_fasta_on_rank0_only(tmp_path, switch):
    """torchrun --standalone (its own rendezvous, no port chosen here):
    with --log-dir and --redirects 1 each rank's stdout goes to a file of
    its own; rank 0's is exactly the single-process FASTA, rank 1's
    empty."""
    paths = _dataset(tmp_path)
    env = _env()
    flag = ["--distributed"] if switch == "flag" else []
    if switch == "env":
        env["RACON_TPU_DISTRIBUTED"] = "1"
    logs = tmp_path / "logs"
    [(out, _)] = _run([[sys.executable, "-m", "torch.distributed.run",
                        "--standalone", "--nproc-per-node", "2",
                        "--log-dir", str(logs), "--redirects", "1", "-m",
                        "racon_tpu_torch.cli", *flag, "--backend", "native",
                        *ARGV, *paths]], env)
    assert out == b""
    stdout = {p.parent.name: p.read_bytes()
              for p in logs.rglob("stdout.log")}
    assert sorted(stdout) == ["0", "1"]
    assert stdout["1"] == b""
    assert stdout["0"] == _polish(create_polisher, paths,
                                  PolisherConfig(backend="native", **CFG))


# each rank: the entry point's main, then whether a process group is
# still up when it has returned (the last line of its stderr: the CLI's
# distributed main points fd 1 at stderr and keeps the FASTA apart)
_LEAVE = """
import sys, torch.distributed
from racon_tpu_torch import cli
from racon_tpu_torch.testing import dist_polish
entry = dist_polish if sys.argv[1] == "dist_polish" else cli
rc = entry.main(sys.argv[2:])
print("group still up:", torch.distributed.is_initialized(),
      file=sys.stderr, flush=True)
sys.exit(rc)
"""


@pytest.mark.parametrize("entry", ["dist_polish", "cli"])
def test_ranks_leave_the_group_before_exit(tmp_path, entry):
    """Both ranks of dist_polish (file:// rendezvous) and of the CLI with
    --distributed (env:// on a free localhost port, as torchrun sets it
    up) take the gloo group down before main returns, so no rank's group
    is torn down at interpreter exit; their FASTA is still the
    single-process one."""
    paths = _dataset(tmp_path)
    env = _env()
    if entry == "dist_polish":
        init = (tmp_path / "rendezvous").as_uri()
        argvs = [["--report", str(tmp_path / "report"), "--init-method",
                  init, "--world-size", "2", "--rank", str(r), "--",
                  "--backend", "native", *ARGV, *paths] for r in range(2)]
        envs = [env, env]
    else:
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        argvs = [["--distributed", "--backend", "native", *ARGV, *paths]] * 2
        envs = [dict(env, MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                     WORLD_SIZE="2", RANK=str(r)) for r in range(2)]
    procs = [subprocess.Popen([sys.executable, "-c", _LEAVE, entry, *argv],
                              env=e, cwd=REPO, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE,
                              start_new_session=True)
             for argv, e in zip(argvs, envs)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=240)
            assert p.returncode == 0, err.decode()[-3000:]
            assert err.endswith(b"group still up: False\n"), \
                err.decode()[-3000:]
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                os.killpg(p.pid, signal.SIGKILL)
                p.wait()
    want = _polish(create_polisher, paths,
                   PolisherConfig(backend="native", **CFG))
    if entry == "dist_polish":
        assert (tmp_path / "report" / "polished.fasta").read_bytes() == want
    else:
        assert outs == [want, b""]

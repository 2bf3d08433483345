"""The port's multi-process helpers (racon_tpu_torch/parallel/dist.py):

- shard_range partitions exactly, as racon_tpu's does;
- allgather_ragged / gather_ragged_to0 / gather_blob_to0 in one process
  return every item in order (racon_tpu/tests/test_dist_utils.py);
- initialize() without torchrun's environment warns and carries on
  single-process; local_devices() per LOCAL_RANK / LOCAL_WORLD_SIZE;
- two gloo processes (a file:// rendezvous in tmp_path, so no port is
  chosen ahead of its bind): gather_ragged_to0 on the ragged ~40 KB
  payloads of racon_tpu/tests/test_dist_kv.py, then a second call on
  the same group, and allgather_ragged / allgather_blob with trailing
  dimensions and an empty shard.
"""

import contextlib
import io
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from racon_tpu.parallel import dist as jax_dist
from racon_tpu_torch.parallel import dist

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_shard_range_partitions_exactly():
    for n in (0, 1, 7, 100):
        for p in (1, 2, 3, 8):
            spans = [dist.shard_range(n, index=i, count=p) for i in range(p)]
            assert spans[0][0] == 0 and spans[-1][1] == n
            for (a, b), (c, d) in zip(spans, spans[1:]):
                assert b == c and b - a >= 0
            sizes = [b - a for a, b in spans]
            assert max(sizes) - min(sizes) <= 1
            assert spans == [jax_dist.shard_range(n, index=i, count=p)
                             for i in range(p)]
    assert dist.shard_range(10) == (0, 10)  # one process: everything


def test_allgather_ragged_single_process():
    items = [np.arange(3, dtype=np.int64), np.zeros(0, np.int64),
             np.arange(5, dtype=np.int64)]
    out = dist.allgather_ragged(items, np.int64)
    assert len(out) == 3
    for a, b in zip(items, out):
        assert np.array_equal(a, b)
    quads = [np.arange(8, dtype=np.int64).reshape(2, 4),
             np.zeros((0, 4), np.int64)]
    out = dist.allgather_ragged(quads, np.int64, trailing=(4,))
    assert out[0].shape == (2, 4) and out[1].shape == (0, 4)
    assert np.array_equal(out[0], quads[0])


def test_gather_to0_single_process():
    items = [np.arange(3, dtype=np.uint8), np.zeros(0, np.uint8),
             np.array([7, 9], np.uint8)]
    out = dist.gather_ragged_to0(items, np.uint8)
    assert len(out) == 3
    for a, b in zip(items, out):
        assert np.array_equal(a, b)
    blob = dist.gather_blob_to0(np.arange(5, dtype=np.int64))
    assert len(blob) == 1 and np.array_equal(blob[0], np.arange(5))


def test_initialize_without_environment_stays_single(monkeypatch):
    for var in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(var, raising=False)
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        dist.initialize()
    assert "continuing single-process" in err.getvalue()
    assert not torch.distributed.is_initialized()
    assert (dist.process_count(), dist.process_index()) == (1, 0)
    assert not dist.is_active()
    dist.barrier()  # no group: nothing to wait for


@pytest.mark.parametrize("count,env,want", [
    (0, {}, []),
    (4, {}, [0, 1, 2, 3]),
    (1, {"LOCAL_RANK": "1", "LOCAL_WORLD_SIZE": "2"}, [0]),
    (3, {"LOCAL_RANK": "2", "LOCAL_WORLD_SIZE": "4"}, [2]),
    (4, {"LOCAL_RANK": "1", "LOCAL_WORLD_SIZE": "2"}, [2, 3]),
    (5, {"LOCAL_RANK": "0", "LOCAL_WORLD_SIZE": "2"}, [0, 1, 2]),
    (5, {"LOCAL_RANK": "1", "LOCAL_WORLD_SIZE": "2"}, [3, 4]),
])
def test_local_devices(monkeypatch, count, env, want):
    """Every visible GPU without torchrun's local variables; device i %
    count when there are fewer GPUs than local ranks; else a balanced
    contiguous slice."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: count > 0)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: count)
    for var in ("LOCAL_RANK", "LOCAL_WORLD_SIZE"):
        monkeypatch.delenv(var, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    assert dist.local_devices() == tuple(torch.device("cuda", i)
                                         for i in want)


WORKER = r"""
import sys
import numpy as np
from racon_tpu_torch.parallel import dist

rank = int(sys.argv[1])
dist.initialize(sys.argv[2], 2, rank)
dist.initialize(sys.argv[2], 2, rank)  # already up: nothing happens
assert dist.is_active() and dist.process_index() == rank

# process 0 holds 2 items, process 1 holds 3 (~40 KB in all)
items = ([np.arange(100, dtype=np.int32), np.arange(7, dtype=np.int32)]
         if rank == 0 else
         [np.full(9000, 5, np.int32), np.arange(3, dtype=np.int32) * 2,
          np.arange(11, dtype=np.int32) + 1])
out = dist.gather_ragged_to0(items, np.int32)
if rank == 0:
    want = [np.arange(100), np.arange(7), np.full(9000, 5),
            np.arange(3) * 2, np.arange(11) + 1]
    assert len(out) == 5, len(out)
    for a, b in zip(out, want):
        assert a.dtype == np.int32 and np.array_equal(a, b)
else:
    assert out == [], out

# a second call on the same group must not collide with the first
out2 = dist.gather_ragged_to0([np.array([rank + 41], np.int64)], np.int64)
if rank == 0:
    assert [int(a[0]) for a in out2] == [41, 42]
flags = dist.gather_blob_to0(np.array([rank, 1, 0][rank:], np.uint8))
if rank == 0:
    assert [f.tolist() for f in flags] == [[0, 1, 0], [1, 0]]

# every process gets the whole list: quads, and an empty shard on rank 1
quads = ([np.arange(8).reshape(2, 4), np.arange(4).reshape(1, 4) + 9]
         if rank == 0 else [])
got = dist.allgather_ragged(quads, np.int64, trailing=(4,))
assert [g.shape for g in got] == [(2, 4), (1, 4)]
assert np.array_equal(got[1], np.arange(4).reshape(1, 4) + 9)
blobs = dist.allgather_blob(np.full(rank + 2, rank, np.float64))
assert [b.tolist() for b in blobs] == [[0.0, 0.0], [1.0, 1.0, 1.0]]
empty = dist.allgather_blob(np.zeros((0, 3), np.int32))
assert [e.shape for e in empty] == [(0, 3), (0, 3)]
dist.barrier()
print("WORKER_OK")
"""


def run_ranks(cmds, env, timeout=120):
    """Start one process per command; wait for each within `timeout`
    seconds, killing every peer if one fails or hangs. Returns their
    (stdout, stderr)."""
    procs = [subprocess.Popen(cmd, env=env, cwd=REPO, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE) for cmd in cmds]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=timeout)
            assert p.returncode == 0, err.decode()[-3000:]
            outs.append((out, err))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return outs


def worker_env():
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    for var in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK",
                "LOCAL_RANK", "LOCAL_WORLD_SIZE"):
        env.pop(var, None)
    return env


def test_two_process_gathers(tmp_path):
    worker = tmp_path / "worker.py"
    worker.write_text(WORKER)
    init = (tmp_path / "rendezvous").as_uri()
    outs = run_ranks([[sys.executable, str(worker), str(r), init]
                      for r in range(2)], worker_env())
    assert all(b"WORKER_OK" in out for out, _ in outs)

"""Multi-process polishing: per-process work shards and host gathers over
torch.distributed. Port of racon_tpu/parallel/dist.py.

racon's multi-GPU batch dispatch (one process, one batch queue per GPU,
src/cuda/cudapolisher.cpp:165-180) generalizes here to several processes
(torchrun, one or more nodes): every process parses the full input (IO
is cheap next to alignment and consensus), aligns a contiguous shard of
the overlaps, all-gathers the breaking points, builds the full window
set, polishes a contiguous shard of the windows and gathers the
consensus bytes to rank 0, which stitches and prints.

Everything moved here is host data (breaking points, consensus bytes),
so the group runs gloo on CPU tensors: the counterpart of the
reference's host (DCN) gathers. gloo also takes several ranks on one
card, which NCCL refuses.

Entry points:
  initialize()           -- torch.distributed.init_process_group("gloo")
  shutdown()             -- every process at one point, then the group gone
  is_active()            -- more than one process in the group
  shard_range(n)         -- this process's contiguous [lo, hi) of n items
  local_devices()        -- the CUDA devices this process owns
  allgather_blob(...)    -- variable-length per-process arrays -> full list
  gather_ragged_to0(...) -- per-process item lists -> rank 0 only
"""

from __future__ import annotations

import os
import sys

import numpy as np
import torch
import torch.distributed as tdist


def initialize(init_method: str | None = None,
               world_size: int | None = None,
               rank: int | None = None) -> None:
    """Bring the gloo group up before any device use, then make the first
    of this process's local_devices() the current CUDA device. With no
    arguments torchrun's MASTER_ADDR / MASTER_PORT / WORLD_SIZE / RANK
    are read (init_method "env://"); explicit arguments take the place of
    the reference's coordinator_address / num_processes / process_id
    (tests rendezvous through a "file://" path). Does nothing when the
    group is already up; a failed init warns and carries on single-process,
    as the reference does."""
    if tdist.is_initialized():
        return
    try:
        tdist.init_process_group(
            "gloo", init_method=init_method or "env://",
            world_size=-1 if world_size is None else world_size,
            rank=-1 if rank is None else rank)
    except (RuntimeError, ValueError) as e:
        sys.stderr.write(
            "[racon::] warning: --distributed requested but "
            f"torch.distributed.init_process_group failed ({e}); "
            "continuing single-process\n")
        return
    devices = local_devices()
    if devices:
        torch.cuda.set_device(devices[0])


def process_count() -> int:
    return tdist.get_world_size() if tdist.is_initialized() else 1


def process_index() -> int:
    return tdist.get_rank() if tdist.is_initialized() else 0


def is_active() -> bool:
    return process_count() > 1


def shard_range(n: int, index: int | None = None,
                count: int | None = None) -> tuple[int, int]:
    """Contiguous [lo, hi) shard of n items for this process (balanced to
    within one item)."""
    p = process_count() if count is None else count
    i = process_index() if index is None else index
    base, rem = divmod(n, p)
    lo = i * base + min(i, rem)
    return lo, lo + base + (1 if i < rem else 0)


def local_devices() -> tuple[torch.device, ...]:
    """The CUDA devices this process owns (the reference's
    jax.local_devices()); () without a GPU. Under torchrun (LOCAL_RANK and
    LOCAL_WORLD_SIZE set) local rank i owns device i % count when there
    are fewer GPUs than local ranks, else its shard_range slice of the
    visible GPUs; otherwise every visible GPU."""
    if not torch.cuda.is_available():
        return ()
    count = torch.cuda.device_count()
    local_rank = os.environ.get("LOCAL_RANK")
    local_size = os.environ.get("LOCAL_WORLD_SIZE")
    if local_rank is None or local_size is None:
        ids = range(count)
    elif count < int(local_size):
        ids = [int(local_rank) % count]
    else:
        ids = range(*shard_range(count, int(local_rank), int(local_size)))
    return tuple(torch.device("cuda", i) for i in ids)


def barrier() -> None:
    """Wait for every process of an active group (no-op otherwise)."""
    if is_active():
        tdist.barrier()


def shutdown(wait: bool = True) -> None:
    """Take the group down before the process exits: with `wait`, behind a
    barrier, so that no process leaves while another still talks to it;
    then destroy_process_group. A group left to the interpreter's exit is
    torn down after Python has gone, and there gloo can abort the process
    (SIGABRT, "terminate called without an active exception", after the
    process wrote its output) once a peer has exited first. An error path
    passes wait=False: its peers may never reach the barrier. Does nothing
    when no group is up."""
    if not tdist.is_initialized():
        return
    if wait and is_active():
        tdist.barrier()
    tdist.destroy_process_group()


def allgather_blob(local: np.ndarray) -> list[np.ndarray]:
    """All-gather one variable-length 1-D (or 2-D with fixed trailing dims)
    array per process; returns the per-process arrays in process order.
    The reference's algorithm: all-gather the row counts, then every
    process's rows padded to the largest count (collectives move equal
    shapes). The rows travel as bytes, so any dtype does."""
    local = np.ascontiguousarray(local)
    if not is_active():
        return [local]
    p = process_count()
    counts = [torch.zeros(1, dtype=torch.int64) for _ in range(p)]
    tdist.all_gather(counts, torch.tensor([local.shape[0]]))
    counts = [int(c) for c in counts]
    padded = np.zeros((max(counts),) + local.shape[1:], local.dtype)
    padded[: local.shape[0]] = local
    if not padded.size:  # every process holds no rows: nothing to move
        return [padded[:0] for _ in counts]
    blob = torch.from_numpy(padded.reshape(-1).view(np.uint8))
    parts = [torch.empty_like(blob) for _ in range(p)]
    tdist.all_gather(parts, blob)
    return [part.numpy().view(local.dtype).reshape(padded.shape)[:c]
            for part, c in zip(parts, counts)]


def _concat(items, dtype, trailing):
    if items:
        return np.concatenate([np.asarray(a, dtype).reshape((-1,) + trailing)
                               for a in items])
    return np.zeros((0,) + trailing, dtype)


def _split(blob, lens) -> list[np.ndarray]:
    out, off = [], 0
    for n in lens:
        out.append(blob[off : off + int(n)])
        off += int(n)
    return out


def allgather_ragged(items: list[np.ndarray], dtype,
                     trailing: tuple[int, ...] = ()) -> list[np.ndarray]:
    """All-gather a list of variable-length arrays (this process's shard of
    a global item list). Returns the concatenated global list, ordered by
    process then local index. Each item keeps its own length via a
    per-process counts vector."""
    blob = _concat(items, dtype, trailing)
    lens = np.array([len(a) for a in items], np.int64)
    out: list[np.ndarray] = []
    for b, ls in zip(allgather_blob(blob), allgather_blob(lens)):
        out += _split(b, ls)
    return out


def gather_ragged_to0(items: list[np.ndarray], dtype,
                      trailing: tuple[int, ...] = ()) -> list[np.ndarray]:
    """Gather a list of variable-length arrays to rank 0 ONLY: the global
    item list, in process order, on rank 0 and [] elsewhere. Consensus
    output is only ever stitched on rank 0, so the other ranks need none
    of it. Each process packs its item count, the items' lengths and
    their bytes into one blob; the processes all-gather the blob sizes
    (one int64 each: every blob is padded to the largest), then rank 0
    alone receives the padded blobs (torch.distributed.gather, which gloo
    has; the reference posts parts to jax's key-value store because jax
    has no gather-to-one). Collectives run in call order, so repeated
    calls on one group never collide. Single-process: allgather_ragged's
    result, every item in order."""
    if not is_active():
        return allgather_ragged(items, dtype, trailing)
    it = np.dtype(dtype)
    lens = np.array([len(a) for a in items], np.int64)
    raw = np.concatenate([np.array([len(lens)], np.int64).view(np.uint8),
                          lens.view(np.uint8),
                          _concat(items, it, trailing).reshape(-1)
                          .view(np.uint8)])
    root = process_index() == 0
    p = process_count()
    size = torch.tensor([raw.size])
    sizes = [torch.zeros(1, dtype=torch.int64) for _ in range(p)]
    tdist.all_gather(sizes, size)
    sizes = [int(s) for s in sizes]
    padded = torch.zeros(max(sizes), dtype=torch.uint8)
    padded[: raw.size] = torch.from_numpy(raw)
    parts = [torch.empty_like(padded) for _ in range(p)] if root else None
    tdist.gather(padded, parts, dst=0)
    if not root:
        return []
    out: list[np.ndarray] = []
    for part, n in zip(parts, sizes):
        b = part.numpy()[:n]
        k = int(b[:8].view(np.int64)[0])
        ls = b[8 : 8 + 8 * k].view(np.int64)
        flat = b[8 + 8 * k :].view(it).reshape((-1,) + trailing)
        out += _split(flat, ls)
    return out


def gather_blob_to0(local: np.ndarray) -> list[np.ndarray]:
    """gather_ragged_to0 for a single array per process: returns the
    per-process arrays in process order on rank 0, [] elsewhere."""
    local = np.ascontiguousarray(local)
    return gather_ragged_to0([local], local.dtype, tuple(local.shape[1:]))

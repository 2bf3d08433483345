"""Multi-GPU scale-out: window/overlap batches split over the devices of a
"mesh". Port of racon_tpu/parallel/mesh.py.

racon's only parallelism is one process's thread pool plus its multi-GPU
batch queues (src/cuda/cudapolisher.cpp:165-180). Here the unit of
distribution is the device batch itself: packed alignment items (window
layers or overlap slices). They are embarrassingly parallel, so a batch
splits into contiguous shards, one a device, each launched on its own
device with the single-device kernels; there is no communication
between devices. A mesh is a tuple of torch.devices (the reference's
1-D jax Mesh over axis "win"); the same device may appear more than once.

Across processes (parallel/dist.py) the mesh spans each process's own
local_devices() only: work is already sharded per process, and each
process splits its shard over its own GPUs.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..ops.batch import to_device, upload
from ..ops.myers_kernel import myers_sweep, myers_walk
from ..ops.nw_kernel import WALKS, gather_sweep_walk, nw_sweep
from . import dist


def distributed_init(**kwargs) -> None:
    """Multi-process entry (dist.initialize) before any device use."""
    dist.initialize(**kwargs)


def window_mesh(devices=None) -> tuple[torch.device, ...]:
    """A mesh over the given devices (names or torch.devices), by default
    this process's local_devices()."""
    if devices is None:
        devices = dist.local_devices()
    return tuple(torch.device(d) for d in devices)


_active_mesh_cache: list = []


def set_active_mesh(mesh) -> None:
    """Pin the stage-dispatch mesh of this process (None: no mesh), in
    place of the one active_mesh() derives; the tests pin CPU devices."""
    _active_mesh_cache.clear()
    _active_mesh_cache.append(None if mesh is None else window_mesh(mesh))


def clear_active_mesh() -> None:
    """Drop the pinned or derived mesh, so the next active_mesh()
    derives it again."""
    _active_mesh_cache.clear()


def active_mesh() -> tuple[torch.device, ...] | None:
    """The mesh the stages split their batches over: this process's
    local_devices() when there is more than one, None with one device or
    none. RACON_TPU_MESH=0 disables it. Derived once and kept until
    clear_active_mesh()."""
    if _active_mesh_cache:
        return _active_mesh_cache[0]
    mesh = None
    if os.environ.get("RACON_TPU_MESH", "1") != "0":
        devices = dist.local_devices()
        if len(devices) > 1:
            mesh = window_mesh(devices)
    _active_mesh_cache.append(mesh)
    return mesh


def shards(mesh, B: int) -> list[tuple[torch.device, int, int]]:
    """(device, lo, hi) of each shard of a B-item batch that holds items:
    contiguous spans balanced to within one item (dist.shard_range), in
    mesh order, with no padding; B < len(mesh) leaves devices idle. An
    empty batch is one empty shard on the first device."""
    out = [(dev, *dist.shard_range(B, i, len(mesh)))
           for i, dev in enumerate(mesh)]
    return [s for s in out if s[2] > s[1]] or [(mesh[0], 0, 0)]


def sharded_align_walk(mesh, q4, t4, dcb, m, n, *, m_cap, n_cap, w_band,
                       match, mismatch, gap, fmt, max_steps=None):
    """The stages' fused sweep + walk with the batch split over the mesh:
    each shard of the packed numpy batch goes up to its device and its
    kernels are launched there, on that device's stream, before the host
    waits on any shard, so the devices run at once. fmt "rle", "rows" or
    "packed2" runs the scored sweep and that walk (packed2 with a budget
    of max_steps, by default walk_steps'), "myers" the Myers sweep and
    walk (dcb unused: unit deletion costs are that route's contract; the
    "rows" payload, zero scores). Returns (payloads, scores): one tensor
    per shard, on its device, in shard order."""
    payloads, scores = [], []
    geo = dict(m_cap=m_cap, n_cap=n_cap, w_band=w_band)
    for dev, lo, hi in shards(mesh, len(q4)):
        b = to_device(q4[lo:hi], t4[lo:hi],
                      None if fmt == "myers" else dcb[lo:hi], m[lo:hi],
                      n[lo:hi], m_cap=m_cap, n_cap=n_cap, device=dev)
        if fmt == "myers":
            planes = myers_sweep(b.q4, b.t4, **geo)
            payload = myers_walk(planes, b.m, b.n, **geo)
            score = torch.zeros_like(b.m)
        else:
            moves, score = nw_sweep(b.q4, b.t4, b.dcb, match=match,
                                    mismatch=mismatch, gap=gap, **geo)
            extra = {} if max_steps is None else dict(max_steps=max_steps)
            payload = WALKS[fmt](moves, b.m, b.n, **geo, **extra)
        payloads.append(payload)
        scores.append(score)
    return payloads, scores


def sharded_align_walk_gather(mesh, qblob, tblob, dcblob, meta, *, m_cap,
                              n_cap, w_band, match, mismatch, gap, fmt):
    """The device-gather form of sharded_align_walk (racon_tpu's
    sharded_align_walk_gather): the word blobs are already on every
    distinct device of the mesh ({torch.device: tensor}, copied once each
    by ops/gather.put_blob) and only the (B, 4) numpy meta rows are split;
    each shard's meta goes up to its device, where its rows are gathered,
    swept and walked (nw_kernel.gather_sweep_walk), all shards launched
    before the host waits on any. Returns (payloads, scores): one tensor
    per shard, on its device, in shard order."""
    payloads, scores = [], []
    for dev, lo, hi in shards(mesh, len(meta)):
        payload, score = gather_sweep_walk(
            qblob[dev], tblob[dev], dcblob[dev],
            upload(meta[lo:hi], np.int32, dev), m_cap=m_cap, n_cap=n_cap,
            w_band=w_band, match=match, mismatch=mismatch, gap=gap, fmt=fmt)
        payloads.append(payload)
        scores.append(score)
    return payloads, scores


def sharded_nw_band_batch(mesh, q4, t4, dcb, *, m_cap, n_cap, w_band, match,
                          mismatch, gap):
    """The scored sweep alone with the batch split over the mesh: (moves,
    scores), one tensor per shard, on its device, in shard order."""
    moves, scores = [], []
    lens = np.zeros(len(q4), np.int32)  # the sweep reads no lengths
    for dev, lo, hi in shards(mesh, len(q4)):
        b = to_device(q4[lo:hi], t4[lo:hi], dcb[lo:hi], lens[lo:hi],
                      lens[lo:hi], m_cap=m_cap, n_cap=n_cap, device=dev)
        mv, score = nw_sweep(b.q4, b.t4, b.dcb, m_cap=m_cap, n_cap=n_cap,
                             w_band=w_band, match=match, mismatch=mismatch,
                             gap=gap)
        moves.append(mv)
        scores.append(score)
    return moves, scores


def polish_step_sharded(mesh, *, m_cap, n_cap, w_band, match, mismatch,
                        gap):
    """The whole device side of a refinement round (sweep + traceback
    walk), sharded: a function (q4, t4, dcb, m, n) -> (payloads, scores)
    per shard, the payload the packed2 step stream of at most m_cap +
    n_cap steps and the escape flag (the reference's walk_moves_device at
    max_steps = m_cap + n_cap, packed). Merge and stitching stay on the
    host."""

    def step(q4, t4, dcb, m, n):
        return sharded_align_walk(
            mesh, q4, t4, dcb, m, n, m_cap=m_cap, n_cap=n_cap,
            w_band=w_band, match=match, mismatch=mismatch, gap=gap,
            fmt="packed2", max_steps=m_cap + n_cap)

    return step

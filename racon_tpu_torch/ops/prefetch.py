"""Device->host payload prefetch shared by the two stages. Port of
racon_tpu/ops/prefetch.py.

A stage launches every chunk of a round (or a queue of chunks) before it
reads any payload back. A blocking `payload.cpu()` at drain time is
queued behind every chunk launched since, so the first read of a round
waits for the round's last kernel. `submit` instead queues the payload's
copy into page-locked host memory on the stream right after the chunk's
own launches, and records an event behind it; `resolve` waits on that
event only. The copy engine does the work the reference's worker threads
did, so no thread is started and none can block interpreter exit.

On a mesh (parallel/mesh.py) a chunk's payload is a list of shards, one
tensor per device: each shard's copy and event go on its own device's
stream, and `resolve` waits on each shard's own event and joins the
shards on the host in shard order.

RACON_TPU_FETCH_THREADS keeps the reference's knob and its meaning: 0
fetches inline at drain time (blocking), a positive value (default 4) or
a malformed one prefetches. On a CPU tensor both calls are plain
`.numpy()`: the CPU build has no pinned allocator and nothing to wait on.
"""

from __future__ import annotations

import os

import numpy as np
import torch


class Fetch:
    """A started fetch: the host copy and, on a CUDA device, the event
    after which its bytes are valid."""

    __slots__ = ("host", "event")

    def __init__(self, host, event):
        self.host = host
        self.event = event


def enabled() -> bool:
    """Whether RACON_TPU_FETCH_THREADS asks for prefetch (read at call
    time, as the reference does)."""
    try:
        return int(os.environ.get("RACON_TPU_FETCH_THREADS", 4)) > 0
    except ValueError:
        return True


def _submit_one(payload: torch.Tensor) -> Fetch:
    if payload.device.type == "cpu":
        return Fetch(payload.numpy(), None)
    # the copy runs on the payload device's current stream; the event must
    # be recorded there too, not on the current device's
    with torch.cuda.device(payload.device):
        host = torch.empty(payload.shape, dtype=payload.dtype,
                           pin_memory=True)
        host.copy_(payload, non_blocking=True)
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(payload.device))
    return Fetch(host, event)


def _resolve_one(fetch: Fetch) -> np.ndarray:
    if fetch.event is None:
        return fetch.host
    fetch.event.synchronize()
    return fetch.host.numpy()


def submit(payload):
    """Start the host copy of a just-launched payload (a tensor, or a
    mesh's list of shards): a Fetch (a list of them, one a shard) for
    resolve(), or None when prefetch is off (resolve then fetches
    inline)."""
    if not enabled():
        return None
    if isinstance(payload, list):
        return [_submit_one(p) for p in payload]
    return _submit_one(payload)


def resolve(payload, fetch) -> np.ndarray:
    """The host copy of a launched payload as numpy, the shards of a mesh
    joined in shard order: the prefetched bytes once their copy has
    completed, else a blocking inline fetch. The only reader of a Fetch:
    its host tensor holds stale bytes until the event has passed."""
    if isinstance(payload, list):
        if fetch is None:
            parts = [p.cpu().numpy() for p in payload]
        else:
            parts = [_resolve_one(f) for f in fetch]
        return np.concatenate(parts)
    if fetch is None:
        return payload.cpu().numpy()
    return _resolve_one(fetch)

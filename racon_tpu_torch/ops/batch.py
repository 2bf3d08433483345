"""Carry-across of the stages' packed numpy batches into device tensors.

The system has no learned weights: its state is numpy (SequenceStore,
OverlapTable, WindowSet) and the only thing that crosses to the device is
the per-chunk packed uplink the native packers build
(bindings.pack_rows_nib / pack_rows_bits, the layout of
racon_tpu/ops/nw_kernel.py pack_codes4 and pack_delbits):

  q4  (B, m_cap // 2) uint8  query codes, two per byte (low nibble first)
  t4  (B, n_cap // 2) uint8  target codes, same packing
  dcb (B, n_cap // 8) uint8  deletion-cost bitmask, little-endian bits;
                             bit set = the column costs `gap`, clear = free
  m, n (B,)           int32  real query / target lengths

`to_device` checks that layout once and moves it; the stages and the tests
both go through it. On a CUDA device each array goes up from page-locked
memory without blocking the host: a pageable copy would hold the host
until the stream drained, so packing the next chunk (or another cohort's
round) could never overlap the kernels already queued.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


@dataclass
class PackedBatch:
    q4: torch.Tensor
    t4: torch.Tensor
    dcb: torch.Tensor | None
    m: torch.Tensor
    n: torch.Tensor


def check_packed(q4, t4, dcb, m, n, *, m_cap: int, n_cap: int) -> None:
    """Raise ValueError unless the numpy arrays follow the packed-uplink
    layout above (dcb may be None: the Myers path has uniform deletion
    costs)."""
    B = q4.shape[0]
    want = [("q4", q4, (B, m_cap // 2)), ("t4", t4, (B, n_cap // 2))]
    if dcb is not None:
        want.append(("dcb", dcb, (B, n_cap // 8)))
    if m_cap % 16 or n_cap % 16:
        raise ValueError(f"caps must be multiples of 16: {m_cap}, {n_cap}")
    for name, arr, shape in want:
        if tuple(arr.shape) != shape:
            raise ValueError(f"{name} shape {tuple(arr.shape)} != {shape}")
        if arr.dtype != np.uint8:
            raise ValueError(f"{name} must be uint8, got {arr.dtype}")
    for name, arr, cap in (("m", m, m_cap), ("n", n, n_cap)):
        if np.shape(arr) != (B,):
            raise ValueError(f"{name} shape {np.shape(arr)} != {(B,)}")
        if B and (np.min(arr) < 0 or np.max(arr) > cap):
            raise ValueError(f"{name} outside [0, {cap}]")


def upload(arr, dtype, device) -> torch.Tensor:
    """A numpy array as a contiguous `dtype` tensor on `device`."""
    t = torch.from_numpy(np.ascontiguousarray(arr, dtype=dtype))
    if device.type != "cuda":
        return t.to(device)
    # pin_memory() copies into a block of PyTorch's caching host allocator,
    # so the caller's numpy array is free once it returns; the allocator
    # records an event on the async copy and reuses the block only after it
    return t.pin_memory().to(device, non_blocking=True)


def to_device(q4, t4, dcb, m, n, *, m_cap: int, n_cap: int,
              device) -> PackedBatch:
    """The stage's packed numpy batch as contiguous tensors on `device`."""
    check_packed(q4, t4, dcb, m, n, m_cap=m_cap, n_cap=n_cap)
    device = torch.device(device)
    return PackedBatch(
        q4=upload(q4, np.uint8, device),
        t4=upload(t4, np.uint8, device),
        dcb=None if dcb is None else upload(dcb, np.uint8, device),
        m=upload(m, np.int32, device),
        n=upload(n, np.int32, device))


def unpack_codes(x4: torch.Tensor, cap: int) -> torch.Tensor:
    """(B, cap // 2) uint8 nibbles -> (B, cap) int32 codes."""
    x = x4.to(torch.int32)
    return torch.stack([x & 0xF, x >> 4], dim=-1).reshape(x4.shape[0], cap)


def unpack_bits(b8: torch.Tensor, cap: int) -> torch.Tensor:
    """(B, cap // 8) uint8 little-endian bitmask -> (B, cap) int32 0/1."""
    sh = torch.arange(8, dtype=torch.int32, device=b8.device)
    bits = (b8.to(torch.int32)[:, :, None] >> sh) & 1
    return bits.reshape(b8.shape[0], cap)

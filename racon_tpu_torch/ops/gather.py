"""Device-side row gather of the consensus stage's gather route (J6, under
RACON_TPU_DEVGATHER=1). Port of the device-gather form of
racon_tpu/ops/nw_kernel.py (pack_codes4_flat, pack_bits_flat and the row
gathers _gather_nib_cols / _gather_bit_cols).

In place of the host packing each chunk's rows (bindings.pack_rows_nib /
pack_rows_bits), the stage uploads flat blobs once -- a cohort's layer
codes, a pass's backbone codes and deletion-cost bits -- and for each
chunk only the items' meta rows; `pack_gather` cuts the packed rows out
of the blobs on the device, byte for byte what the host packers write,
so the sweep and walks run unchanged.

Layouts:
  code blob  (L8,) int32   little-endian words of nibble codes: element
                           e in word e >> 3 at bits 4 (e & 7)
  bit blob   (L32,) int32  little-endian words of deletion-cost bits:
                           element e in word e >> 5 at bit e & 31 (set =
                           the column costs `gap`); indexed by word, not
                           by byte (the reference's fault C1)
  meta       (B, 4) int32  [q_start, m, t_start, n] per item: element
                           indices into the blobs and the row lengths
  q4 (B, m_cap // 2), t4 (B, n_cap // 2), dcb (B, n_cap // 8) uint8
                           the packed rows of ops/batch.py: PAD_CODE past
                           m or n, deletion-cost bits set past n

On a CUDA tensor `pack_gather` launches kernels/csrc/pack_gather.cu and
counts it as "pack_gather"; on a CPU tensor it runs pack_gather_plain;
any other device raises.
"""

from __future__ import annotations

import numpy as np
import torch

from ..kernels import LAUNCHES
from .batch import upload
from .geometry import PAD_CODE

_M32 = 0xFFFFFFFF
MAX_BLOB_ELEMS = 2 ** 31  # int32 element indices of the meta rows


def pack_codes4_flat(codes8: np.ndarray) -> np.ndarray:
    """(L,) int8 codes -> (ceil(L/2),) uint8 nibble-packed flat blob, low
    nibble first (racon_tpu's pack_codes4_flat)."""
    x = np.asarray(codes8).view(np.uint8)
    if len(x) % 2:
        x = np.concatenate([x, np.full(1, PAD_CODE, np.uint8)])
    return (x[0::2] | (x[1::2] << 4)).astype(np.uint8)


def pack_bits_flat(mask: np.ndarray) -> np.ndarray:
    """(L,) bool/int -> (ceil(L/8),) uint8 little-endian bitmask blob
    (racon_tpu's pack_bits_flat)."""
    return np.packbits(np.asarray(mask) != 0, bitorder="little")


def blob_words(blob8: np.ndarray, pad: int) -> np.ndarray:
    """A uint8 blob as little-endian int32 words, its tail padded to a
    whole word with the byte `pad` (0x55: PAD codes; 0xFF: set bits)."""
    tail = -len(blob8) % 4
    if tail:
        blob8 = np.concatenate([blob8, np.full(tail, pad, np.uint8)])
    return np.ascontiguousarray(blob8).view("<i4")


def code_words(codes8: np.ndarray) -> np.ndarray:
    """(L,) int8 codes -> the code blob's int32 words."""
    return blob_words(pack_codes4_flat(codes8), 0x55)


def bit_words(mask: np.ndarray) -> np.ndarray:
    """(L,) bool/int deletion-cost mask -> the bit blob's int32 words."""
    return blob_words(pack_bits_flat(mask), 0xFF)


def put_blob(words: np.ndarray, devices) -> dict:
    """The word blob on each distinct device of `devices` (one, or a
    mesh's), copied once to each, from page-locked memory on a GPU:
    {torch.device: (L,) int32 tensor}."""
    return {dev: upload(words, np.int32, dev)
            for dev in dict.fromkeys(torch.device(d) for d in devices)}


def check_meta(meta: np.ndarray, q_words: int, t_words: int, *, m_cap: int,
               n_cap: int) -> None:
    """Raise ValueError unless meta is (B, 4) with every row inside the
    caps and its blobs (q_words / t_words: the code blobs' word counts;
    the bit blob holds the target's elements too)."""
    if meta.ndim != 2 or meta.shape[1] != 4:
        raise ValueError(f"meta shape {meta.shape} != (B, 4)")
    if not len(meta):
        return
    qs, m, ts, n = (meta[:, c].astype(np.int64) for c in range(4))
    if (qs.min() < 0 or ts.min() < 0 or m.min() < 0 or n.min() < 0
            or m.max() > m_cap or n.max() > n_cap):
        raise ValueError("meta rows outside their caps")
    if (qs + m).max() > 8 * q_words or (ts + n).max() > 8 * t_words:
        raise ValueError("meta rows run past their blobs")


def pack_gather(qblob, tblob, dcblob, meta, *, m_cap, n_cap):
    """Code blobs qblob / tblob and bit blob dcblob (int32 words), meta
    (B, 4) int32, all on one device -> (q4, t4, dcb) uint8 there, the
    packed rows of each item (module docstring). Replaces the row gathers
    of racon_tpu's gather cores (_gather_nib_cols, _gather_bit_cols)."""
    if meta.device.type == "cpu":
        return pack_gather_plain(qblob, tblob, dcblob, meta, m_cap=m_cap,
                                 n_cap=n_cap)
    if meta.device.type != "cuda":
        raise ValueError(f"unsupported device {meta.device}")
    from ..kernels.build import kernels

    B = meta.shape[0]
    out = [torch.empty((B, w), dtype=torch.uint8, device=meta.device)
           for w in (m_cap // 2, n_cap // 2, n_cap // 8)]
    kernels().pack_gather(qblob, tblob, dcblob, meta, *out, m_cap, n_cap)
    LAUNCHES["pack_gather"] += 1
    return tuple(out)


def _gather_elems(words, start, length, cap, per_word, fill):
    """(B, cap) int64 elements start[b] + c of a word blob of `per_word`
    elements a word (8 nibbles or 32 bits) for c < length[b], `fill` past
    it."""
    w = torch.cat([words.to(torch.int64) & _M32,
                   torch.zeros(1, dtype=torch.int64)])
    width = 32 // per_word
    pos = torch.arange(cap, dtype=torch.int64)
    idx = start.to(torch.int64)[:, None] + pos
    valid = pos < length.to(torch.int64)[:, None]
    wi = torch.where(valid, idx // per_word, 0).clamp(max=len(w) - 1)
    el = (w[wi] >> (width * (idx % per_word))) & ((1 << width) - 1)
    return torch.where(valid, el, fill)


def pack_gather_plain(qblob, tblob, dcblob, meta, *, m_cap, n_cap):
    """Plain PyTorch version of pack_gather on CPU tensors: each row's
    elements read one by one from their words, then packed as the host
    packers pack them."""
    if meta.device.type != "cpu":
        raise ValueError("pack_gather_plain takes CPU tensors")
    B = meta.shape[0]
    qs, m, ts, n = meta.unbind(1)
    q = _gather_elems(qblob, qs, m, m_cap, 8, PAD_CODE)
    t = _gather_elems(tblob, ts, n, n_cap, 8, PAD_CODE)
    d = _gather_elems(dcblob, ts, n, n_cap, 32, 1)
    bits = torch.arange(8, dtype=torch.int64)
    return ((q[:, 0::2] | (q[:, 1::2] << 4)).to(torch.uint8),
            (t[:, 0::2] | (t[:, 1::2] << 4)).to(torch.uint8),
            (d.reshape(B, n_cap // 8, 8) << bits).sum(-1).to(torch.uint8))

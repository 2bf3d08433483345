"""Band geometry, payload sizes and base codes shared by the port's kernels
and stages: jax-free ports of the numpy helpers that live inside
racon_tpu/ops/nw_kernel.py and racon_tpu/ops/myers_kernel.py.

Every value here must equal the reference's, because payload formats and
budgets are decoded by the shared native runtime
(racon_tpu/native/src/align.cpp) and compared byte for byte in the tests.
"""

from __future__ import annotations

import numpy as np

PAD_CODE = 5              # nw_kernel.py:43; matches itself, rejects bases
NEG = -(10 ** 5)          # nw_kernel.py:44; forbids pad-vs-real pairing
SCAN_FILL = 2 * NEG       # fill of the scored sweep's max-plus prefix scan
PACK = 16                 # query rows per int32 move word (nw_kernel._PACK)
NW_CODES = 6              # ACGTN + PAD planes of the Myers Peq mask

# RLE event bytes (nw_kernel.py:1226-1228); 1..16 = diagonal run length
RLE_SKIP = 0
RLE_UP = 201
RLE_LEFT = 202

# rows-payload record ops (nw_kernel.py:1887-1888)
REC_DIAG = 1
REC_UP = 2

_CODE = np.full(256, 4, dtype=np.uint8)  # anything unusual -> N
for _i, _b in enumerate(b"ACGTN"):
    _CODE[_b] = _i


def encode(seq: np.ndarray) -> np.ndarray:
    """Bytes -> base codes 0..4 (ACGTN; anything else is N)."""
    return _CODE[seq]


def band_dlo(m_cap: int, n_cap: int, w_band: int) -> int:
    """j = i + dlo + k for band lane k (nw_kernel.py:57-59)."""
    return n_cap - m_cap - w_band // 2


def _round4(x: int) -> int:
    return -(-x // 4) * 4


def walk_steps(m_cap: int, n_cap: int, w_band: int) -> int:
    """Step budget of the 2-bit op stream (nw_kernel.py:251-256)."""
    return min(_round4(m_cap + 2 * w_band), _round4(m_cap + n_cap))


def rle_events(m_cap: int, n_cap: int, w_band: int) -> int:
    """Event budget of the RLE walk (nw_kernel.py:1232-1237); walks that
    need more are flagged escaped and realigned on the host."""
    return max(walk_steps(m_cap, n_cap, w_band) // 4, 64)


def rows_payload_width(m_cap: int) -> int:
    """Rows payload bytes per item: one record per query row, the
    final-deletions byte and the escape flag (nw_kernel.py:1891-1894)."""
    return m_cap + 2


def scan_span(w_band: int) -> int:
    """Reach of the reference's log-step max-plus scan: steps 1, 2, 4, ...
    below W cover 2^ceil(log2 W) lanes. Lane k's result includes the
    scan's fill value exactly when k <= span - 2 (see nw_kernel
    _nw_band_kernel_t8: lanes below each shift read the fill)."""
    s = 1
    while s < w_band:
        s *= 2
    return s


def guard_bits(w_band: int) -> int:
    """Zero-bit guard on each side of the Peq mask (myers_kernel.py:61)."""
    return w_band // 2 + 32


def peq_words(n_cap: int, w_band: int) -> int:
    """32-bit words per Peq plane, guards included (myers_kernel.py:67)."""
    return (n_cap + 2 * guard_bits(w_band)) // 32


def sweep_fits(m_cap: int, n_cap: int, w_band: int) -> bool:
    """Shapes the scored sweep kernel takes: one thread per band lane, so
    W <= 1024 and a multiple of 32, and the t8 regime dlo <= 0. Wider
    tiers (the reference's lane-major kernel, nw_kernel.py:186) are
    aligned on the host."""
    return (w_band % 32 == 0 and w_band <= 1024 and m_cap % 16 == 0
            and n_cap % 32 == 0 and band_dlo(m_cap, n_cap, w_band) <= 0)


def myers_fits(m_cap: int, n_cap: int, w_band: int) -> bool:
    """Shapes the Myers kernels take: equal caps (the align-stage
    contract), W a multiple of 32 up to 4096, m_cap a multiple of 32, and
    one item's Peq mask (6 planes) within 48 KB of shared memory. The
    reference's VMEM model (myers_kernel.py:404-432) has no counterpart
    here."""
    return (m_cap == n_cap and w_band % 32 == 0 and w_band <= 4096
            and m_cap % 32 == 0 and band_dlo(m_cap, n_cap, w_band) <= 0
            and 6 * 4 * peq_words(n_cap, w_band) <= 48 * 1024)

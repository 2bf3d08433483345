"""Host traceback walk over the scored sweep's packed move planes: a copy
of racon_tpu/ops/nw_walk.py, the numpy oracle of the port's walk tests.

The production path walks on the device (ops/nw_kernel.py: rle_walk,
rows_walk, packed_walk) and decodes natively. Pads are skipped: an op is
recorded only when it consumes a real character."""

from __future__ import annotations

import numpy as np

from ..core.breakpoints import OP_DEL, OP_INS, OP_MATCH
from .geometry import PACK, band_dlo


def walk_moves(moves: np.ndarray, m: int, n: int, m_cap: int, n_cap: int,
               w_band: int) -> np.ndarray:
    """moves: (m_cap // 16, W) int32 packed planes of one item (2 bits a
    row: 0 diagonal, 1 up, 2 left, 3 invalid). Returns ops (k, 2) int32
    as (op, run) pairs from the start of the alignment."""
    dlo = band_dlo(m_cap, n_cap, w_band)
    i, j = m_cap, n_cap
    rev: list[list[int]] = []

    def push(op):
        if rev and rev[-1][0] == op:
            rev[-1][1] += 1
        else:
            rev.append([op, 1])

    while i > 0 or j > 0:
        if i == 0:
            mv = 2  # row 0: all deletions
        elif j == 0:
            mv = 1  # column 0: all insertions
        else:
            k = j - i - dlo
            if not 0 <= k < w_band:
                raise ValueError(f"path left the band at ({i},{j})")
            word = int(moves[(i - 1) // PACK, k])
            mv = (word >> (2 * ((i - 1) % PACK))) & 3
            if mv == 3:
                raise ValueError(f"invalid move on path at ({i},{j})")
        if mv == 0:
            if i <= m and j <= n:
                push(OP_MATCH)
            i -= 1
            j -= 1
        elif mv == 1:
            if i <= m:
                push(OP_INS)
            i -= 1
        else:
            if j <= n:
                push(OP_DEL)
            j -= 1
    rev.reverse()
    return np.asarray(rev, dtype=np.int32).reshape(-1, 2)

"""Window breaking points.

An overlap's alignment path is cut at target-window boundaries; for every
window the (first-match, last-match) target/query coordinates are recorded.
Semantics mirror Overlap::find_breaking_points_from_cigar
(reference: src/overlap.cpp:226-292). Output rows are
[t_first, q_first, t_last_excl, q_last_excl] (the reference stores the same
as two (t,q) pairs, with the last pair exclusive).

Three producers exist for the alignment path itself:
  - SAM input ships a CIGAR -> walked directly here
  - the TPU banded-NW kernel emits boundary registers (ops/nw_kernel.py)
  - the native C++ aligner emits op lists (native/src/align.cpp)
This module holds the pure-Python walk used for SAM cigars and as the oracle.
"""

from __future__ import annotations

import re

import numpy as np

_CIGAR_RE = re.compile(rb"(\d+)([MIDNSHP=X])")

# compact op codes used across python/native/device paths
OP_MATCH = 0  # M / = / X : consumes query and target
OP_INS = 1    # I         : consumes query
OP_DEL = 2    # D / N     : consumes target
OP_CLIP = 3   # S / H / P : consumed nothing we track here

_OP_CODE = {
    b"M": OP_MATCH, b"=": OP_MATCH, b"X": OP_MATCH,
    b"I": OP_INS,
    b"D": OP_DEL, b"N": OP_DEL,
    b"S": OP_CLIP, b"H": OP_CLIP, b"P": OP_CLIP,
}


def cigar_to_ops(cigar: bytes) -> np.ndarray:
    """CIGAR string -> (n, 2) int32 array of (op_code, run_length)."""
    items = _CIGAR_RE.findall(cigar)
    out = np.empty((len(items), 2), dtype=np.int32)
    for i, (n, op) in enumerate(items):
        out[i, 0] = _OP_CODE[op]
        out[i, 1] = int(n)
    return out


def breaking_points_from_ops(ops: np.ndarray, strand: bool, q_begin: int,
                             q_end: int, q_length: int, t_begin: int,
                             t_end: int, window_length: int) -> np.ndarray:
    """Walk an op list, emitting per-window first/last match coordinates."""
    window_ends = []
    for i in range(0, int(t_end), window_length):
        if i > t_begin:
            window_ends.append(i - 1)
    window_ends.append(int(t_end) - 1)

    out = []
    w = 0
    found = False
    fm_t = fm_q = lm_t = lm_q = 0
    q_ptr = (q_length - q_end if strand else q_begin) - 1
    t_ptr = t_begin - 1

    for k in range(len(ops)):
        op, num = int(ops[k, 0]), int(ops[k, 1])
        if op == OP_MATCH:
            for _ in range(num):
                q_ptr += 1
                t_ptr += 1
                if not found:
                    found = True
                    fm_t, fm_q = t_ptr, q_ptr
                lm_t, lm_q = t_ptr + 1, q_ptr + 1
                if t_ptr == window_ends[w]:
                    if found:
                        out.append((fm_t, fm_q, lm_t, lm_q))
                    found = False
                    w += 1
        elif op == OP_INS:
            q_ptr += num
        elif op == OP_DEL:
            for _ in range(num):
                t_ptr += 1
                if t_ptr == window_ends[w]:
                    if found:
                        out.append((fm_t, fm_q, lm_t, lm_q))
                    found = False
                    w += 1
    return np.asarray(out, dtype=np.int64).reshape(-1, 4)


def breaking_points_from_cigar(cigar: bytes, strand: bool, q_begin: int,
                               q_end: int, q_length: int, t_begin: int,
                               t_end: int, window_length: int) -> np.ndarray:
    return breaking_points_from_ops(
        cigar_to_ops(cigar), strand, q_begin, q_end, q_length, t_begin, t_end,
        window_length)

"""Overlap alignment and breaking points, in plain Python and numpy.

- `edit_ops(q, t)`: the global edit-distance alignment of racon's overlap
  step (edlib in NW mode) as an op list, with the traceback preference of
  racon_tpu_torch/ops/nw_host.py at scores (0, -1, -1): DIAG, then UP
  (consume query), then LEFT (consume target). The matrix is computed by
  Myers' bit-vector recurrence on Python integers (one integer a column),
  and the traceback reads each cell's distance from those columns, so the
  path is that of the full O(mn) matrix without holding it.
- `breaking_points_from_ops`, `cigar_to_ops`, `sam_accounting`: frozen
  copies of racon_tpu_torch/core/breakpoints.py's walk and of the SAM
  coordinate arithmetic of racon_tpu_torch/io/overlaps_io.py (racon's
  src/overlap.cpp:44-108, 226-292).
"""

from __future__ import annotations

import re

import numpy as np

OP_MATCH = 0
OP_INS = 1
OP_DEL = 2
OP_CLIP = 3


def _columns(q: bytes, t: bytes):
    """Myers/Hyyro columns of D (D[i][j] = edit distance of q[:i] and
    t[:j], D[0][j] = j, D[i][0] = i): for each j, the bits of the +1 and
    the -1 vertical steps D[i][j] - D[i-1][j], bit i-1 for row i."""
    m = len(q)
    mask = (1 << m) - 1
    peq: dict[int, int] = {}
    for c in set(q):
        bits = np.frombuffer(q, np.uint8) == c
        peq[c] = int.from_bytes(np.packbits(bits, bitorder="little")
                                .tobytes(), "little")
    pv, mv = mask, 0
    cols_p = [pv]
    cols_m = [mv]
    for c in t:
        eq = peq.get(c, 0)
        xv = eq | mv
        xh = (((eq & pv) + pv) ^ pv) | eq
        ph = mv | (~(xh | pv) & mask)
        mh = pv & xh
        ph = ((ph << 1) | 1) & mask
        mh = (mh << 1) & mask
        pv = mh | (~(xv | ph) & mask)
        mv = ph & xv
        cols_p.append(pv)
        cols_m.append(mv)
    return cols_p, cols_m


def edit_distance(q: bytes, t: bytes) -> int:
    """Exact edit distance of q and t."""
    if not q or not t:
        return len(q) + len(t)
    cols_p, cols_m = _columns(q, t)
    return len(t) + cols_p[-1].bit_count() - cols_m[-1].bit_count()


def edit_ops(q: bytes, t: bytes) -> np.ndarray:
    """Global edit-distance alignment of q (rows) against t (columns) as
    (op, run) rows, traced back from (m, n) preferring DIAG, then UP,
    then LEFT among the moves that keep the distance optimal."""
    m, n = len(q), len(t)
    ops: list[list[int]] = []

    def push(op):
        if ops and ops[-1][0] == op:
            ops[-1][1] += 1
        else:
            ops.append([op, 1])

    if m and n:
        cols_p, cols_m = _columns(q, t)
    i, j = m, n
    d = (n + cols_p[n].bit_count() - cols_m[n].bit_count()) if m and n \
        else m + n
    while i > 0 or j > 0:
        if i > 0 and j > 0:
            low = (1 << (i - 1)) - 1
            d_diag = (j - 1 + (cols_p[j - 1] & low).bit_count()
                      - (cols_m[j - 1] & low).bit_count())
            if d == d_diag + (q[i - 1] != t[j - 1]):
                push(OP_MATCH)
                i -= 1
                j -= 1
                d = d_diag
                continue
            step = (cols_p[j] >> (i - 1) & 1) - (cols_m[j] >> (i - 1) & 1)
            if step == 1:  # D[i-1][j] + 1 == D[i][j]
                push(OP_INS)
                i -= 1
                d -= 1
                continue
            push(OP_DEL)
            j -= 1
            d -= 1
        elif i > 0:
            push(OP_INS)
            i -= 1
            d -= 1
        else:
            push(OP_DEL)
            j -= 1
            d -= 1
    ops.reverse()
    return np.asarray(ops, np.int64).reshape(-1, 2)


_CIGAR_RE = re.compile(rb"(\d+)([MIDNSHP=X])")
_OP_CODE = {b"M": OP_MATCH, b"=": OP_MATCH, b"X": OP_MATCH, b"I": OP_INS,
            b"D": OP_DEL, b"N": OP_DEL, b"S": OP_CLIP, b"H": OP_CLIP,
            b"P": OP_CLIP}


def cigar_to_ops(cigar: bytes) -> np.ndarray:
    items = _CIGAR_RE.findall(cigar)
    return np.asarray([(_OP_CODE[op], int(k)) for k, op in items],
                      np.int64).reshape(-1, 2)


def sam_accounting(cigar: bytes, strand: bool, t_begin: int):
    """(q_begin, q_end, q_length, t_end, length, error) of a SAM record."""
    ops = _CIGAR_RE.findall(cigar)
    q_begin = 0
    for k, op in ops:
        if op in (b"S", b"H"):
            q_begin = int(ops[0][0])
            break
        if op in (b"M", b"=", b"I", b"D", b"N", b"P", b"X"):
            break
    q_aln = q_clip = t_aln = 0
    for k, op in ops:
        k = int(k)
        if op in (b"M", b"=", b"X"):
            q_aln += k
            t_aln += k
        elif op == b"I":
            q_aln += k
        elif op in (b"D", b"N"):
            t_aln += k
        elif op in (b"S", b"H"):
            q_clip += k
    q_end = q_begin + q_aln
    q_length = q_clip + q_aln
    if strand:
        q_begin, q_end = q_length - q_end, q_length - q_begin
    length = max(q_aln, t_aln)
    error = 1.0 - min(q_aln, t_aln) / length if length else 1.0
    return q_begin, q_end, q_length, t_begin + t_aln, length, error


def breaking_points_from_ops(ops, strand, q_begin, q_end, q_length, t_begin,
                             t_end, window_length) -> np.ndarray:
    """Per target window crossed, [t_first, q_first, t_last_excl,
    q_last_excl] of the path's first and last match in it."""
    window_ends = [i - 1 for i in range(0, int(t_end), window_length)
                   if i > t_begin]
    window_ends.append(int(t_end) - 1)
    out = []
    w = 0
    found = False
    fm_t = fm_q = lm_t = lm_q = 0
    q_ptr = (q_length - q_end if strand else q_begin) - 1
    t_ptr = t_begin - 1
    for op, num in ops:
        op, num = int(op), int(num)
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
    return np.asarray(out, np.int64).reshape(-1, 4)

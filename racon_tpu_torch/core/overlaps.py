"""OverlapTable: structure-of-arrays overlap/alignment records plus the
reference-exact semantic transforms:

  - error()      = 1 - min(q_span, t_span)/max(q_span, t_span)
                                         (reference: src/overlap.cpp:24-26)
  - transmute()  name/file-order ids -> internal sequence indices with length
                 cross-checks          (reference: src/overlap.cpp:129-177)
  - filtering    error > threshold, self-overlap removal, and in contig (kC)
                 mode keep-longest-per-consecutive-query-run
                                         (reference: src/polisher.cpp:284-355)
"""

from __future__ import annotations

import numpy as np

from ..errors import RaconError
from .store import SequenceStore


class OverlapTable:
    """Columnar overlap records. Name columns are python lists (empty bytes for
    id-based formats); cigars only for SAM input."""

    def __init__(self):
        self.q_names: list[bytes] = []
        self.t_names: list[bytes] = []
        self.cigars: list[bytes] = []  # b"" when absent
        self.q_id = _i8()
        self.q_begin = _i8()
        self.q_end = _i8()
        self.q_length = _i8()
        self.t_id = _i8()
        self.t_begin = _i8()
        self.t_end = _i8()
        self.t_length = _i8()
        self.strand = np.zeros(0, dtype=bool)
        self.is_valid = np.zeros(0, dtype=bool)
        self.error = np.zeros(0, dtype=np.float64)
        self.length = _i8()

    def __len__(self) -> int:
        return len(self.q_id)

    def finalize_from_lists(self, cols: dict) -> None:
        n = len(cols["q_begin"])
        self.q_names = cols.get("q_names", [b""] * n)
        self.t_names = cols.get("t_names", [b""] * n)
        self.cigars = cols.get("cigars", [b""] * n)
        for key in ("q_id", "q_begin", "q_end", "q_length",
                    "t_id", "t_begin", "t_end", "t_length", "length"):
            setattr(self, key, np.asarray(cols.get(key, [0] * n), dtype=np.int64))
        self.strand = np.asarray(cols["strand"], dtype=bool)
        self.is_valid = np.asarray(cols.get("is_valid", [True] * n), dtype=bool)
        self.error = np.asarray(cols["error"], dtype=np.float64)

    # ------------------------------------------------------------------ #

    def transmute(self, sequences: SequenceStore, name_to_id: dict,
                  id_to_id: dict) -> None:
        """Map names / file-order ids to internal indices; verify lengths.

        Mirrors Overlap::transmute (src/overlap.cpp:129-177): unknown names or
        ids invalidate the record; length mismatches are fatal; t_length is
        overwritten from the store (SAM has no target length column).
        """
        n = len(self)
        seq_len = sequences.lengths()
        for i in range(n):
            if not self.is_valid[i]:
                continue
            qn = self.q_names[i]
            if qn:
                qid = name_to_id.get(qn + b"q")
            else:
                qid = id_to_id.get(int(self.q_id[i]) << 1 | 0)
            if qid is None:
                self.is_valid[i] = False
                continue
            self.q_id[i] = qid
            if self.q_length[i] != seq_len[qid]:
                raise RaconError(
                    "[racon::Overlap::transmute] error: unequal lengths in "
                    "sequence and overlap file for sequence %s!"
                    % sequences.name(qid).decode())
            tn = self.t_names[i]
            if tn:
                tid = name_to_id.get(tn + b"t")
            else:
                tid = id_to_id.get(int(self.t_id[i]) << 1 | 1)
            if tid is None:
                self.is_valid[i] = False
                continue
            self.t_id[i] = tid
            if self.t_length[i] != 0 and self.t_length[i] != seq_len[tid]:
                raise RaconError(
                    "[racon::Overlap::transmute] error: unequal lengths in "
                    "target and overlap file for target %s!"
                    % sequences.name(tid).decode())
            self.t_length[i] = seq_len[tid]  # for SAM input

    def filter_invalid(self, error_threshold: float, keep_longest_per_query: bool) -> np.ndarray:
        """Return boolean keep-mask applying the reference filter rules.

        Records already !is_valid are dropped. Then per *consecutive run* of
        equal q_id (file order), drop error>threshold and self-overlaps; in
        contig mode additionally keep only the longest overlap of each run
        (ties resolved exactly like the reference's pairwise scan, where a tie
        drops the earlier record: src/polisher.cpp:294-306).
        """
        n = len(self)
        bad = (self.error > error_threshold) | (self.q_id == self.t_id)
        keep = self.is_valid & ~bad
        if keep_longest_per_query and n:
            # runs of equal q_id among records valid after transmute; the
            # sequential scan is the reference's exactly, in which a
            # not-yet-reached bad record still competes for "longest"
            valid_idx = np.flatnonzero(self.is_valid)
            if len(valid_idx):
                qv = self.q_id[valid_idx]
                run_starts = np.flatnonzero(np.r_[True, qv[1:] != qv[:-1]])
                run_ends = np.r_[run_starts[1:], len(qv)]
                for s, e in zip(run_starts, run_ends):
                    run = valid_idx[s:e]
                    keep[run] &= _kc_scan(self.length[run], bad[run])
        return keep

    def compact(self, keep: np.ndarray) -> None:
        idx = np.flatnonzero(keep)
        self.q_names = [self.q_names[i] for i in idx]
        self.t_names = [self.t_names[i] for i in idx]
        self.cigars = [self.cigars[i] for i in idx]
        for key in ("q_id", "q_begin", "q_end", "q_length", "t_id", "t_begin",
                    "t_end", "t_length", "length", "strand", "is_valid", "error"):
            setattr(self, key, getattr(self, key)[idx])

    def split_at(self, cut: int) -> tuple["OverlapTable", "OverlapTable"]:
        """(rows [0, cut), rows [cut, n)) — for chunk-boundary run carry."""
        a, b = OverlapTable(), OverlapTable()
        for t, lo, hi in ((a, 0, cut), (b, cut, len(self))):
            t.q_names = self.q_names[lo:hi]
            t.t_names = self.t_names[lo:hi]
            t.cigars = self.cigars[lo:hi]
            for key in ("q_id", "q_begin", "q_end", "q_length", "t_id",
                        "t_begin", "t_end", "t_length", "length", "strand",
                        "is_valid", "error"):
                setattr(t, key, getattr(self, key)[lo:hi])
        return a, b

    @classmethod
    def concat(cls, tables: list["OverlapTable"]) -> "OverlapTable":
        t = cls()
        if not tables:
            return t
        t.q_names = [n for tb in tables for n in tb.q_names]
        t.t_names = [n for tb in tables for n in tb.t_names]
        t.cigars = [c for tb in tables for c in tb.cigars]
        for key in ("q_id", "q_begin", "q_end", "q_length", "t_id", "t_begin",
                    "t_end", "t_length", "length", "strand", "is_valid",
                    "error"):
            setattr(t, key,
                    np.concatenate([getattr(tb, key) for tb in tables]))
        return t

    def trailing_run_start(self) -> int:
        """Row index where the last consecutive q_id run (over transmute-valid
        records) begins — everything from here may continue into the next
        parse chunk and must be carried forward (the reference defers the
        open run via its c/l bookkeeping, src/polisher.cpp:315-353)."""
        vi = np.flatnonzero(self.is_valid)
        if not len(vi):
            return len(self)
        qv = self.q_id[vi]
        changes = np.flatnonzero(qv != qv[-1])
        cut_v = int(changes[-1]) + 1 if len(changes) else 0
        return int(vi[cut_v])


def _kc_scan(lengths: np.ndarray, bad: np.ndarray) -> np.ndarray:
    """The reference's sequential run scan (src/polisher.cpp:284-308): walk
    records in order; a bad (error/self) record is dropped when reached but
    competes in earlier records' longest-scans until then; the champion is
    the record that out-lengths every still-alive later record (strictly —
    a tie kills the earlier one)."""
    n = len(lengths)
    alive = np.ones(n, bool)
    keep = np.zeros(n, bool)
    for i in range(n):
        if not alive[i]:
            continue
        if bad[i]:
            alive[i] = False
            continue
        won = True
        for j in range(i + 1, n):
            if not alive[j]:
                continue
            if lengths[i] > lengths[j]:
                alive[j] = False
            else:
                alive[i] = False
                won = False
                break
        if won:
            keep[i] = True
    return keep


def _i8():
    return np.zeros(0, dtype=np.int64)


def span_error(q_begin, q_end, t_begin, t_end):
    """error = 1 - min(span)/max(span) (reference: src/overlap.cpp:24-26)."""
    qs = np.asarray(q_end) - np.asarray(q_begin)
    ts = np.asarray(t_end) - np.asarray(t_begin)
    mx = np.maximum(qs, ts)
    return 1.0 - np.minimum(qs, ts) / mx.astype(np.float64)

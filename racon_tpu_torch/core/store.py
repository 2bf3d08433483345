"""SequenceStore: structure-of-arrays sequence container.

The reference keeps one heap object per sequence (src/sequence.{hpp,cpp});
here everything lives in two contiguous uint8 blobs (bases, qualities) with
offset tables, so window/layer extraction is zero-copy numpy slicing and the
whole store can be handed to native code or packed for the device without
per-record marshalling.
"""

from __future__ import annotations

import numpy as np

# reverse-complement lookup for ascii bases; non-ACGT maps to itself
_RC = np.arange(256, dtype=np.uint8)
for a, b in ((ord("A"), ord("T")), (ord("C"), ord("G"))):
    _RC[a], _RC[b] = b, a


class SequenceStoreBuilder:
    def __init__(self):
        self.names: list[bytes] = []
        self._data_parts: list[bytes] = []
        self._qual_parts: list[bytes] = []

    def add(self, name: bytes, data: bytes, quality: bytes) -> int:
        self.names.append(name)
        self._data_parts.append(data)
        self._qual_parts.append(quality)
        return len(self.names) - 1

    def __len__(self) -> int:
        return len(self.names)

    def finish(self) -> "SequenceStore":
        n = len(self.names)
        data_off = np.zeros(n + 1, dtype=np.int64)
        qual_off = np.zeros(n + 1, dtype=np.int64)
        for i in range(n):
            data_off[i + 1] = data_off[i] + len(self._data_parts[i])
            qual_off[i + 1] = qual_off[i] + len(self._qual_parts[i])
        blob = np.frombuffer(b"".join(self._data_parts), dtype=np.uint8)
        qual = np.frombuffer(b"".join(self._qual_parts), dtype=np.uint8)
        return SequenceStore(list(self.names), blob, data_off, qual, qual_off)


def merge_stores(targets: "SequenceStore", reads: "SequenceStore",
                 keep_read: np.ndarray) -> "SequenceStore":
    """Targets first, then the reads with keep_read[i] True (duplicates of
    targets are dropped by the caller; see polisher ingest)."""
    idx = np.flatnonzero(keep_read)
    names = list(targets.names) + [reads.names[i] for i in idx]
    parts = [targets.blob]
    qparts = [targets.qual_blob]
    n_t = len(targets)
    data_off = np.zeros(len(names) + 1, dtype=np.int64)
    qual_off = np.zeros(len(names) + 1, dtype=np.int64)
    data_off[: n_t + 1] = targets.data_off
    qual_off[: n_t + 1] = targets.qual_off
    rlen = reads.lengths()[idx]
    rqlen = np.diff(reads.qual_off)[idx]
    data_off[n_t + 1 :] = targets.data_off[-1] + np.cumsum(rlen)
    qual_off[n_t + 1 :] = targets.qual_off[-1] + np.cumsum(rqlen)
    for i in idx:
        parts.append(reads.data(int(i)))
        qparts.append(reads.quality(int(i)))
    blob = np.concatenate(parts) if parts else np.zeros(0, np.uint8)
    qual = np.concatenate(qparts) if qparts else np.zeros(0, np.uint8)
    return SequenceStore(names, blob, data_off, qual, qual_off)


class SequenceStore:
    @classmethod
    def from_parts(cls, names, blob, data_off, qual_blob, qual_off):
        return cls(names, np.asarray(blob, np.uint8),
                   np.asarray(data_off, np.int64),
                   np.asarray(qual_blob, np.uint8),
                   np.asarray(qual_off, np.int64))

    def __init__(self, names, blob, data_off, qual_blob, qual_off):
        self.names: list[bytes] = names
        self.blob: np.ndarray = blob
        self.data_off: np.ndarray = data_off
        self.qual_blob: np.ndarray = qual_blob
        self.qual_off: np.ndarray = qual_off
        # lazily-populated reverse complements / reversed qualities, keyed by id
        self._rc: dict[int, np.ndarray] = {}
        self._rq: dict[int, np.ndarray] = {}

    def __len__(self) -> int:
        return len(self.names)

    def name(self, i: int) -> bytes:
        return self.names[i]

    def length(self, i: int) -> int:
        return int(self.data_off[i + 1] - self.data_off[i])

    def lengths(self) -> np.ndarray:
        return np.diff(self.data_off)

    def data(self, i: int) -> np.ndarray:
        return self.blob[self.data_off[i] : self.data_off[i + 1]]

    def quality(self, i: int) -> np.ndarray:
        """Quality slice; empty array when the record has no quality."""
        return self.qual_blob[self.qual_off[i] : self.qual_off[i + 1]]

    def has_quality(self, i: int) -> bool:
        return self.qual_off[i + 1] > self.qual_off[i]

    def total_length(self) -> int:
        return int(self.data_off[-1])

    def reverse_complement(self, i: int) -> np.ndarray:
        """Lazy reverse complement (reference: src/sequence.cpp:49-84)."""
        rc = self._rc.get(i)
        if rc is None:
            rc = _RC[self.data(i)][::-1].copy()
            self._rc[i] = rc
            self._rc_cat = None
        return rc

    def reverse_quality(self, i: int) -> np.ndarray:
        rq = self._rq.get(i)
        if rq is None:
            rq = self.quality(i)[::-1].copy()
            self._rq[i] = rq
            self._rq_cat = None
        return rq

    def prepare_reverse(self, ids) -> None:
        for i in ids:
            self.reverse_complement(int(i))
            if self.has_quality(int(i)):
                self.reverse_quality(int(i))
        self._rc_cat = None
        self._rq_cat = None

    _rc_cat = None
    _rq_cat = None

    def _cat_arrays(self, by_id: dict):
        """(blob, start_by_id) concatenated view of a per-id array dict;
        start_by_id[i] is -1 for ids without an entry."""
        starts = np.full(len(self.names), -1, np.int64)
        parts = []
        off = 0
        for i in sorted(by_id):
            starts[i] = off
            parts.append(by_id[i])
            off += len(by_id[i])
        blob = np.concatenate(parts) if parts else np.zeros(0, np.uint8)
        return blob, starts

    def rc_arrays(self):
        """(blob, start_by_id) view of all prepared reverse complements —
        enables vectorized gathers over reverse-strand layers."""
        if self._rc_cat is None:
            self._rc_cat = self._cat_arrays(self._rc)
        return self._rc_cat

    def rq_arrays(self):
        """(blob, start_by_id) of prepared reversed qualities."""
        if self._rq_cat is None:
            self._rq_cat = self._cat_arrays(self._rq)
        return self._rq_cat

"""Window construction, layer assignment, and consensus stitching.

Targets are sliced into window_length-bp windows; each surviving overlap
contributes one layer per window it crosses (cut at breaking points), subject
to the minimum-span and average-quality filters
(reference: src/polisher.cpp:384-457). Windows are the unit of batched device
work; layers are stored columnar (SoA) and materialized into padded device
batches only at pack time.
"""

from __future__ import annotations


import numpy as np

from ..errors import RaconError
from .store import SequenceStore

WINDOW_TYPE_NGS = 0  # short reads: no consensus trimming
WINDOW_TYPE_TGS = 1  # long reads: trim low-coverage window ends


class WindowSet:
    """All windows of all targets plus their layers, columnar."""

    def __init__(self, sequences: SequenceStore, targets_size: int,
                 window_length: int, window_type: int):
        self.sequences = sequences
        self.window_length = window_length
        self.window_type = window_type
        self.targets_size = targets_size

        # per-target window ranges (reference: id_to_first_window_id)
        tlens = sequences.lengths()[:targets_size]
        # reference emits ceil(len/w) windows (loop j=0; j<len; j+=w);
        # a zero-length target therefore gets zero windows
        counts = -(-tlens // window_length)
        self.first_window_id = np.zeros(targets_size + 1, dtype=np.int64)
        np.cumsum(counts, out=self.first_window_id[1:])
        self.num_windows = int(self.first_window_id[-1])

        # per-window backbone: owning target, start offset, length, rank
        win_tid = np.repeat(np.arange(targets_size, dtype=np.int64), counts)
        rank = np.arange(self.num_windows, dtype=np.int64) - \
            self.first_window_id[win_tid]
        self.win_target = win_tid
        self.win_rank = rank
        self.win_start = rank * window_length
        self.win_len = np.minimum(
            tlens[win_tid] - self.win_start, window_length).astype(np.int64)

        # layers (SoA, grown in python lists then frozen)
        self._lay_win: list[int] = []
        self._lay_qid: list[int] = []
        self._lay_strand: list[bool] = []
        self._lay_qbegin: list[int] = []
        self._lay_qlen: list[int] = []
        self._lay_begin: list[int] = []
        self._lay_end: list[int] = []
        self.frozen = False

    # -- layer assignment -------------------------------------------------- #

    def add_layer(self, window_id: int, q_id: int, strand: bool, q_begin: int,
                  q_len: int, begin: int, end: int) -> None:
        """Register one layer. Validation mirrors Window::add_layer
        (reference: src/window.cpp:42-63)."""
        if q_len == 0 or begin == end:
            return
        backbone_len = int(self.win_len[window_id])
        if begin >= end or begin > backbone_len or end > backbone_len:
            raise RaconError(
                "[racon::Window::add_layer] error: layer begin and end "
                "positions are invalid!")
        self._lay_win.append(window_id)
        self._lay_qid.append(q_id)
        self._lay_strand.append(strand)
        self._lay_qbegin.append(q_begin)
        self._lay_qlen.append(q_len)
        self._lay_begin.append(begin)
        self._lay_end.append(end)

    def assign_overlap(self, breaking_points: np.ndarray, q_id: int, t_id: int,
                       strand: bool, quality_threshold: float) -> None:
        """Cut one overlap into window layers
        (reference: src/polisher.cpp:403-457)."""
        w = self.window_length
        seqs = self.sequences
        has_q = seqs.has_quality(q_id)
        if has_q:
            qual = seqs.reverse_quality(q_id) if strand else seqs.quality(q_id)
        for t_fm, q_fm, t_lm, q_lm in breaking_points:
            if q_lm - q_fm < 0.02 * w:
                continue
            if has_q:
                avg = float(np.mean(qual[q_fm:q_lm])) - 33.0
                if avg < quality_threshold:
                    continue
            window_id = int(self.first_window_id[t_id] + t_fm // w)
            window_start = (t_fm // w) * w
            self.add_layer(window_id, q_id, strand, int(q_fm),
                           int(q_lm - q_fm), int(t_fm - window_start),
                           int(t_lm - window_start - 1))

    def freeze(self) -> None:
        self.lay_win = np.asarray(self._lay_win, dtype=np.int64)
        self.lay_qid = np.asarray(self._lay_qid, dtype=np.int64)
        self.lay_strand = np.asarray(self._lay_strand, dtype=bool)
        self.lay_qbegin = np.asarray(self._lay_qbegin, dtype=np.int64)
        self.lay_qlen = np.asarray(self._lay_qlen, dtype=np.int64)
        self.lay_begin = np.asarray(self._lay_begin, dtype=np.int64)
        self.lay_end = np.asarray(self._lay_end, dtype=np.int64)
        # layer order per window: by begin position, stable
        order = np.lexsort((np.arange(len(self.lay_win)), self.lay_begin,
                            self.lay_win))
        for name in ("lay_win", "lay_qid", "lay_strand", "lay_qbegin",
                     "lay_qlen", "lay_begin", "lay_end"):
            setattr(self, name, getattr(self, name)[order])
        # CSR index window -> layer range
        self.win_layer_off = np.zeros(self.num_windows + 1, dtype=np.int64)
        np.add.at(self.win_layer_off[1:], self.lay_win, 1)
        np.cumsum(self.win_layer_off, out=self.win_layer_off)
        self.frozen = True

    # -- accessors ---------------------------------------------------------- #

    def backbone(self, window_id: int) -> np.ndarray:
        t = int(self.win_target[window_id])
        s = int(self.win_start[window_id])
        return self.sequences.data(t)[s : s + int(self.win_len[window_id])]

    def backbone_quality(self, window_id: int) -> np.ndarray | None:
        """Target quality slice, or None when the target has no quality (the
        reference substitutes '!'-weights, i.e. zero weights)."""
        t = int(self.win_target[window_id])
        if not self.sequences.has_quality(t):
            return None
        s = int(self.win_start[window_id])
        return self.sequences.quality(t)[s : s + int(self.win_len[window_id])]

    def n_layers(self, window_id: int) -> int:
        return int(self.win_layer_off[window_id + 1] -
                   self.win_layer_off[window_id])

    def layer_indices(self, window_id: int) -> np.ndarray:
        return np.arange(self.win_layer_off[window_id],
                         self.win_layer_off[window_id + 1])

    def layer_data(self, layer_idx: int) -> np.ndarray:
        q = int(self.lay_qid[layer_idx])
        b = int(self.lay_qbegin[layer_idx])
        ln = int(self.lay_qlen[layer_idx])
        src = (self.sequences.reverse_complement(q) if self.lay_strand[layer_idx]
               else self.sequences.data(q))
        return src[b : b + ln]

    def layer_quality(self, layer_idx: int) -> np.ndarray | None:
        q = int(self.lay_qid[layer_idx])
        if not self.sequences.has_quality(q):
            return None
        b = int(self.lay_qbegin[layer_idx])
        ln = int(self.lay_qlen[layer_idx])
        src = (self.sequences.reverse_quality(q) if self.lay_strand[layer_idx]
               else self.sequences.quality(q))
        return src[b : b + ln]

    def shard(self, lo: int, hi: int) -> "WindowSet":
        """Re-based view of windows [lo, hi) — the per-process work shard
        for multi-host runs (parallel/dist.py). Window/layer arrays are
        sliced and the layer CSR rebased; the sequence store is shared.
        Every consensus-stage backend consumes the shard as a normal
        WindowSet; stitching uses the full set on process 0."""
        assert self.frozen and 0 <= lo <= hi <= self.num_windows
        ws = WindowSet.__new__(WindowSet)
        ws.sequences = self.sequences
        ws.window_length = self.window_length
        ws.window_type = self.window_type
        ws.targets_size = self.targets_size
        ws.num_windows = hi - lo
        ws.first_window_id = None  # pre-freeze only (assign_overlap)
        for name in ("win_target", "win_rank", "win_start", "win_len"):
            setattr(ws, name, getattr(self, name)[lo:hi])
        l0, l1 = int(self.win_layer_off[lo]), int(self.win_layer_off[hi])
        for name in ("lay_win", "lay_qid", "lay_strand", "lay_qbegin",
                     "lay_qlen", "lay_begin", "lay_end"):
            setattr(ws, name, getattr(self, name)[l0:l1])
        ws.lay_win = ws.lay_win - lo
        ws.win_layer_off = self.win_layer_off[lo : hi + 1] - l0
        ws.frozen = True
        return ws


def stitch(window_consensus: list[bytes], window_polished: list[bool],
           windows: WindowSet, sequences: SequenceStore,
           targets_coverages: np.ndarray, polisher_type_is_f: bool,
           drop_unpolished: bool) -> list[tuple[bytes, bytes]]:
    """Concatenate window consensuses per target and emit tagged records
    (reference: src/polisher.cpp:506-532). Returns (name, data) pairs."""
    out: list[tuple[bytes, bytes]] = []
    parts: list[bytes] = []
    num_polished = 0
    for i in range(windows.num_windows):
        num_polished += 1 if window_polished[i] else 0
        parts.append(window_consensus[i])
        last = (i == windows.num_windows - 1 or windows.win_rank[i + 1] == 0)
        if last:
            polished_ratio = num_polished / float(windows.win_rank[i] + 1)
            if not drop_unpolished or polished_ratio > 0:
                data = b"".join(parts)
                tid = int(windows.win_target[i])
                tags = b"r" if polisher_type_is_f else b""
                tags += b" LN:i:%d" % len(data)
                tags += b" RC:i:%d" % int(targets_coverages[tid])
                tags += b" XC:f:%f" % polished_ratio
                out.append((sequences.name(tid) + tags, data))
            num_polished = 0
            parts = []
    return out

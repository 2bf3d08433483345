"""Native alignment stage: batched banded edit-distance NW + breaking-point
walk in C++ across a thread pool (the reference's
Polisher::find_overlap_breaking_points role, src/polisher.cpp:462-484)."""

from __future__ import annotations

import numpy as np

from . import bindings


class NativeAlignStage:
    def __init__(self, cfg):
        self.cfg = cfg

    def breaking_points(self, overlaps, indices, sequences, window_length,
                        logger) -> list[np.ndarray]:
        n = len(indices)
        q_parts = []
        t_parts = []
        qoff = np.zeros(n + 1, np.int64)
        toff = np.zeros(n + 1, np.int64)
        strand = np.zeros(n, np.uint8)
        cols = {k: np.zeros(n, np.int64)
                for k in ("q_begin", "q_end", "q_length", "t_begin", "t_end")}
        for k, i in enumerate(indices):
            qid = int(overlaps.q_id[i])
            s = bool(overlaps.strand[i])
            qb, qe = int(overlaps.q_begin[i]), int(overlaps.q_end[i])
            qlen = int(overlaps.q_length[i])
            tb, te = int(overlaps.t_begin[i]), int(overlaps.t_end[i])
            if s:
                src = sequences.reverse_complement(qid)
                q = src[qlen - qe : qlen - qb]
            else:
                q = sequences.data(qid)[qb:qe]
            t = sequences.data(int(overlaps.t_id[i]))[tb:te]
            q_parts.append(q)
            t_parts.append(t)
            qoff[k + 1] = qoff[k] + len(q)
            toff[k + 1] = toff[k] + len(t)
            strand[k] = 1 if s else 0
            cols["q_begin"][k] = qb
            cols["q_end"][k] = qe
            cols["q_length"][k] = qlen
            cols["t_begin"][k] = tb
            cols["t_end"][k] = te
        qblob = np.concatenate(q_parts) if q_parts else np.zeros(0, np.uint8)
        tblob = np.concatenate(t_parts) if t_parts else np.zeros(0, np.uint8)
        quads, out_off, counts = bindings.breaking_points_batch(
            qblob, qoff, tblob, toff, strand, cols["q_begin"], cols["q_end"],
            cols["q_length"], cols["t_begin"], cols["t_end"], window_length,
            self.cfg.num_threads)
        out = []
        for k in range(n):
            o = int(out_off[k])
            out.append(quads[o : o + int(counts[k])].copy())
        for _ in range(20):
            logger.bar("[racon::Polisher::initialize] aligning overlaps")
        return out

"""Overlap-alignment stage on a CUDA device: breaking points through the
Myers sweep and walk kernels. Port of racon_tpu/ops/align_stage_tpu.py.

Overlap (query-slice, target-slice) pairs are bucketed by length into the
canonical equal-cap tiers, aligned on the device with edit-distance
semantics (ops/myers_kernel.align_walk_myers_padded: the "rows" payload at
every tier), decoded by the shared native runtime, and cut at window
boundaries natively. Items beyond the last tier or escaping the band are
aligned by the host C++ aligner, as in the reference.

Left out of the port, each for a reason recorded in ROADMAP.md:
`small_batch_to_host` (keyed on the JAX prewarm state) and the slow-link
branch of `myers_tier_fmt` (every tier runs Myers with "rows" here).
"""

from __future__ import annotations

from collections import deque

import numpy as np
import torch

from racon_tpu.native import bindings

from .consensus_stage import chunk_size, chunk_spans
from .geometry import PAD_CODE, encode, rows_payload_width
from .myers_kernel import align_walk_myers_padded

# canonical (cap, band) tiers, the reference's (align_stage_tpu.py:32-33);
# items beyond the last tier go to the host
_TIERS = ((2560, 512), (10240, 1024), (40960, 1024), (10240, 4096),
          (40960, 4096))

# chunks launched ahead of the one being decoded, so the device computes
# while the host decodes (the reference bounded this by 4 GB of HBM)
_MAX_QUEUED = 4


def _chunk_size(cap: int, band: int) -> int:
    return chunk_size(cap, band, 1024)


class TorchAlignStage:
    """breaking_points() on `device`: "cuda" launches the kernels; "cpu"
    runs their plain PyTorch versions (tests only)."""

    def __init__(self, cfg, device):
        self.cfg = cfg
        self.device = torch.device(device)
        self.stats = {"items": 0, "device_items": 0, "host_items": 0}

    def breaking_points(self, overlaps, indices, sequences, window_length,
                        logger) -> list[np.ndarray]:
        # the aligned slices in flat columnar form: reverse-strand queries
        # read the prepared revcomp blob, forward ones the store blob
        thr = self.cfg.num_threads
        idx = np.asarray(indices, np.int64)
        qid = np.asarray(overlaps.q_id)[idx]
        strand = np.asarray(overlaps.strand)[idx].astype(np.uint8)
        qb = np.asarray(overlaps.q_begin)[idx].astype(np.int64)
        qe = np.asarray(overlaps.q_end)[idx].astype(np.int64)
        qlen_full = np.asarray(overlaps.q_length)[idx].astype(np.int64)
        tb = np.asarray(overlaps.t_begin)[idx].astype(np.int64)
        te = np.asarray(overlaps.t_end)[idx].astype(np.int64)
        tid = np.asarray(overlaps.t_id)[idx]
        rc_blob, rc_start = sequences.rc_arrays()
        src = np.concatenate([sequences.blob, rc_blob])
        qstart = np.where(
            strand != 0,
            len(sequences.blob) + rc_start[qid] + qlen_full - qe,
            sequences.data_off[qid] + qb)
        mlen = qe - qb
        nlen = te - tb
        tstart = sequences.data_off[tid] + tb
        qblob_raw = bindings.gather_ranges(src, qstart, mlen, thr)
        tblob_raw = bindings.gather_ranges(sequences.blob, tstart, nlen, thr)
        qoff_all = np.zeros(len(idx) + 1, np.int64)
        np.cumsum(mlen, out=qoff_all[1:])
        toff_all = np.zeros(len(idx) + 1, np.int64)
        np.cumsum(nlen, out=toff_all[1:])
        qenc = encode(qblob_raw).astype(np.int8)
        tenc = encode(tblob_raw).astype(np.int8)

        # bucket by the canonical tiers; |n - m| must fit well within the
        # band. --band-width N sets a minimum device band.
        tiers = _TIERS
        if self.cfg.band_width > 0:
            tiers = (tuple(t for t in tiers if t[1] >= self.cfg.band_width)
                     or (tiers[-1],))
        tier_id = np.full(len(idx), -1, np.int64)
        for ti, (cap, band) in enumerate(tiers):
            ok = ((tier_id < 0) & (mlen <= cap) & (nlen <= cap)
                  & (np.abs(nlen - mlen) <= band // 2 - 64))
            tier_id[ok] = ti
        host: list[int] = list(np.flatnonzero(tier_id < 0))

        all_ops: list[np.ndarray | None] = [None] * len(idx)
        all_counts = np.zeros(len(idx), np.int64)
        pending: deque = deque()
        done = [0]

        def drain_one():
            sel, cap, payload = pending.popleft()
            payload = payload.cpu().numpy()
            escaped = payload[:, -1] != 0
            ops_flat, ops_off, counts = bindings.opstream_rows_to_ops_batch(
                payload, rows_payload_width(cap), mlen[sel], nlen[sel], thr)
            for bi, z in enumerate(sel):
                if escaped[bi]:
                    host.append(z)
                else:
                    o = int(ops_off[bi])
                    all_ops[z] = ops_flat[o : o + int(counts[bi])]
                    all_counts[z] = counts[bi]
            done[0] += len(sel) - int(escaped.sum())
            logger.bar_progress(
                "[racon::Polisher::initialize] aligning overlaps",
                done[0], len(idx))

        for ti, (cap, band) in enumerate(tiers):
            members = np.flatnonzero(tier_id == ti)
            # length-sorted chunks keep the walk's threads in near lockstep
            members = members[np.argsort(mlen[members], kind="stable")]
            for lo, hi in chunk_spans(len(members), _chunk_size(cap, band)):
                sel = members[lo:hi]
                while len(pending) >= _MAX_QUEUED:
                    drain_one()
                q4 = bindings.pack_rows_nib(qenc, qoff_all[sel],
                                            qoff_all[sel] + mlen[sel], cap,
                                            PAD_CODE, thr)
                t4 = bindings.pack_rows_nib(tenc, toff_all[sel],
                                            toff_all[sel] + nlen[sel], cap,
                                            PAD_CODE, thr)
                payload, _, _ = align_walk_myers_padded(
                    q4, t4, mlen[sel].astype(np.int32),
                    nlen[sel].astype(np.int32), m_cap=cap, n_cap=cap,
                    w_band=band, device=self.device)
                pending.append((sel, cap, payload))
                self.stats["device_items"] += len(sel)
        while pending:
            drain_one()

        if host:
            hz = np.asarray(host, np.int64)
            hm = mlen[hz]
            hn = nlen[hz]
            qoff = np.zeros(len(hz) + 1, np.int64)
            np.cumsum(hm, out=qoff[1:])
            toff = np.zeros(len(hz) + 1, np.int64)
            np.cumsum(hn, out=toff[1:])
            qblob = bindings.gather_ranges(qblob_raw, qoff_all[hz], hm, thr)
            tblob = bindings.gather_ranges(tblob_raw, toff_all[hz], hn, thr)
            ops_flat, ops_off, counts = bindings.align_batch(
                qblob, qoff, tblob, toff, 0, -1, -1, True, thr)
            for z2, z in enumerate(host):
                o = int(ops_off[z2])
                all_ops[z] = ops_flat[o : o + int(counts[z2])]
                all_counts[z] = counts[z2]
        self.stats["items"] += len(idx)
        self.stats["host_items"] += len(host)

        # op lists -> window breaking points (native walk)
        ops_off2 = np.zeros(len(idx) + 1, np.int64)
        for z in range(len(idx)):
            ops_off2[z + 1] = ops_off2[z] + len(all_ops[z])
        ops_blob = (np.concatenate(all_ops) if len(idx)
                    else np.zeros((0, 2), np.int32))
        quads, quad_off, qcounts = bindings.breaking_points_from_ops_batch(
            ops_blob, ops_off2[:-1], all_counts, strand, qb, qe, qlen_full,
            tb, te, window_length, thr)
        out = []
        for z in range(len(idx)):
            o = int(quad_off[z])
            out.append(quads[o : o + int(qcounts[z])].copy())
        logger.bar_progress("[racon::Polisher::initialize] aligning overlaps",
                            len(idx), len(idx))
        return out

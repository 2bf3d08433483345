"""Overlap-alignment stage on a CUDA device: breaking points through the
Myers sweep and walk kernels, or the scored sweep. Port of
racon_tpu/ops/align_stage_tpu.py.

Overlap (query-slice, target-slice) pairs are bucketed by length into the
canonical equal-cap tiers, aligned on the device with edit-distance
semantics, decoded by the port's native runtime, and cut at window
boundaries natively. A tier runs the Myers kernels
(ops/myers_kernel.align_walk_myers_padded: the "rows" payload) where
myers_fits holds; under RACON_TPU_MYERS=0 every tier runs the scored
route instead, as in the reference (align_stage_tpu.py:343-364): the
scored sweep at (match, mismatch, gap) = (0, -1, -1) with unit deletion
costs and the walk walk_fmt picks (rle or rows, as RACON_TPU_WALK says,
at W <= 1024; packed2 at the W = 4096 tiers). Items beyond the last tier
or escaping the band are aligned by the host C++ aligner, as in the
reference. On an active mesh (parallel/mesh.py) every chunk is split over
its devices and its payload comes back as per-shard tensors, which
ops/prefetch.resolve joins in shard order before the decode.

Left out of the port, each for a reason recorded in ROADMAP.md:
`small_batch_to_host` (keyed on the JAX prewarm state) and the slow-link
branch of `myers_tier_fmt`, the route that picks the "rle" payload by
itself (a Myers tier always runs with "rows" here). The "rle" payload
itself is ported: align_walk_myers_padded(fmt="rle").
"""

from __future__ import annotations

import os
from collections import defaultdict, deque

import numpy as np
import torch

from ..native import bindings

from . import prefetch
from .consensus_stage import chunk_size, chunk_spans
from .geometry import PAD_CODE, encode, myers_fits
from .myers_kernel import align_walk_myers_padded
from .nw_kernel import align_walk_padded, payload_decoder

# canonical (cap, band) tiers, the reference's (align_stage_tpu.py:32-33);
# items beyond the last tier go to the host
_TIERS = ((2560, 512), (10240, 1024), (40960, 1024), (10240, 4096),
          (40960, 4096))

# chunks launched ahead of the one being decoded, so the device computes
# while the host decodes (the reference bounded this by 4 GB of HBM); each
# payload's fetch starts right behind its chunk's launches (ops/prefetch)
_MAX_QUEUED = 4

# device bytes of one Myers chunk's DIAG/UP planes (freed once the walk has
# read them); the scored route keeps the consensus stage's move budget
_PLANES_BUDGET = 4 << 30
_MAX_ITEMS = 1024


def _chunk_size(cap: int, band: int, myers: bool) -> int:
    """Items per launch of a tier: on the Myers route as many as the
    planes budget allows (cap x 2 x band/8 bytes an item: 1024 at
    (10240,1024), 409 at (40960,1024) and (10240,4096)), on the scored
    route as many as the move-word budget allows; at most _MAX_ITEMS.
    The budgets are per chunk: on a mesh of k devices each holds 1/k."""
    if myers:
        per_item = cap * 2 * (band // 8)
        return max(16, min(_MAX_ITEMS, _PLANES_BUDGET // per_item))
    return chunk_size(cap, band, _MAX_ITEMS)


class TorchAlignStage:
    """breaking_points() on `device`: "cuda" launches the kernels; "cpu"
    runs their plain PyTorch versions (tests only)."""

    def __init__(self, cfg, device):
        self.cfg = cfg
        self.device = torch.device(device)
        # tier_items: items per (cap, band, route), route "myers" or
        # "scored/<walk format>"; -1 = beyond the tiers (host)
        self.stats = {"items": 0, "device_items": 0, "host_items": 0,
                      "tier_items": defaultdict(int)}

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
        if host:
            self.stats["tier_items"][-1] += len(host)

        all_ops: list[np.ndarray | None] = [None] * len(idx)
        all_counts = np.zeros(len(idx), np.int64)
        pending: deque = deque()
        done = [0]

        def drain_one():
            sel, cap, band, fmt, payload, fetch = pending.popleft()
            payload = prefetch.resolve(payload, fetch)
            escaped = payload[:, -1] != 0
            decode, codes, budget = payload_decoder(fmt, payload, cap, band)
            ops_flat, ops_off, counts = decode(codes, budget, mlen[sel],
                                               nlen[sel], thr)
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
            # RACON_TPU_MYERS=0 sends every tier to the scored route, read
            # at call time as the reference does (myers_kernel.py:414-415)
            myers = (os.environ.get("RACON_TPU_MYERS", "1") != "0"
                     and myers_fits(cap, cap, band))
            for lo, hi in chunk_spans(len(members),
                                      _chunk_size(cap, band, myers)):
                sel = members[lo:hi]
                while len(pending) >= _MAX_QUEUED:
                    drain_one()
                q4 = bindings.pack_rows_nib(qenc, qoff_all[sel],
                                            qoff_all[sel] + mlen[sel], cap,
                                            PAD_CODE, thr)
                t4 = bindings.pack_rows_nib(tenc, toff_all[sel],
                                            toff_all[sel] + nlen[sel], cap,
                                            PAD_CODE, thr)
                if myers:
                    payload, _, fmt = align_walk_myers_padded(
                        q4, t4, mlen[sel].astype(np.int32),
                        nlen[sel].astype(np.int32), m_cap=cap, n_cap=cap,
                        w_band=band, device=self.device)
                    route = "myers"
                else:
                    # unit deletion costs everywhere: an all-ones bitmask
                    dcb = np.full((len(sel), cap // 8), 0xFF, np.uint8)
                    payload, _, fmt = align_walk_padded(
                        q4, t4, dcb, mlen[sel].astype(np.int32),
                        nlen[sel].astype(np.int32), m_cap=cap, n_cap=cap,
                        w_band=band, match=0, mismatch=-1, gap=-1,
                        device=self.device)
                    route = "scored/" + fmt
                pending.append((sel, cap, band, fmt, payload,
                                prefetch.submit(payload)))
                self.stats["device_items"] += len(sel)
                self.stats["tier_items"][(cap, band, route)] += len(sel)
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

"""Consensus stage on a CUDA device: iterative star-POA around the scored
sweep and the RLE / rows / packed2 walk kernels. Port of
racon_tpu/ops/consensus_stage_tpu.py.

Per refinement pass every (window, layer) item is aligned to its window's
current backbone on the device (ops/nw_kernel.align_walk_padded: the
scored banded sweep plus the RLE walk, or the rows walk under
RACON_TPU_WALK=rows, or the packed2 walk at the W = 2048 tier); the
port's native runtime decodes the streams and merges them into the
per-window graphs (bindings.poa_round_batch), giving the
final consensus or the expanded backbone of the next pass. Items beyond
the tiers or escaping the band are realigned on the host thread pool, as
in the reference; a tier wider than the sweep kernel takes would be too
(counted as wide_host_items; none of the canonical tiers is).

Under RACON_TPU_DEVGATHER=1 the stage dispatches the device-gather form
(nw_kernel.align_walk_gather): each cohort's layer codes go up once as a
word blob, each pass's backbone codes and deletion-cost bits once, and a
chunk sends only its (B, 4) meta rows; the rows are gathered on the
device (ops/gather.py) in place of the host packers, so every payload is
byte for byte the dense route's. The default is the dense route, the
reference's choice on a locally attached device.

Left out of the port, each for a reason recorded in ROADMAP.md: the
cheapest-path router `_route` and its tunnel calibrations (the stage always
runs on the device), the padded-batch ladder and the gather form's blob
buckets (a kernel launch takes any batch size and blob length, so chunks
and blobs go up at their exact size), the link probe behind the gather
form's automatic choice, and the prewarm family.

On an active mesh (parallel/mesh.py) each chunk is split over its
devices, the shards launched on every device before the host waits on
any, and ops/prefetch.resolve joins the shards' payloads in shard order,
so the bytes do not depend on the mesh.

The host/device overlap is the reference's: the windows run in cohorts
(_auto_cohorts) whose rounds interleave, every chunk's payload fetch is
started right behind its launches (ops/prefetch.py) and waited for only
when the cohort's round completes, and the packed uploads go up from
page-locked memory without blocking the host (ops/batch.py). The host
phases are named in a torch.profiler trace ("racon::dispatch", "fetch",
"decode", "host_fallback", "poa_round") and timed into `prof`.
"""

from __future__ import annotations

import contextlib
import os
import sys
import time
from collections import defaultdict

import numpy as np
import torch

from ..native import bindings
from ..utils.phred import PHRED_OFFSET

from . import prefetch
from .gather import MAX_BLOB_ELEMS, bit_words, code_words, put_blob
from .geometry import PAD_CODE, encode, sweep_fits
from .nw_kernel import (align_walk_gather, align_walk_padded, gather_devices,
                        payload_decoder)

_MOVES_BUDGET = 1 << 30  # device bytes of one chunk's move words

# canonical (cap, band) tiers, the reference's (consensus_stage_tpu.py:100)
_TIERS = ((256, 128), (640, 128), (1280, 256), (1280, 512), (2560, 384),
          (2560, 768), (5120, 512), (5120, 1024), (10240, 768),
          (10240, 2048))


def chunk_size(cap: int, band: int, max_items: int) -> int:
    """Items per launch: as many as the move-word budget allows."""
    per_item = (cap // 16) * band * 4  # int32 move words
    return max(16, min(max_items, _MOVES_BUDGET // per_item))


def chunk_spans(k: int, step: int) -> list[tuple[int, int]]:
    """ceil(k / step) near-equal spans covering k items."""
    if k <= 0:
        return []
    size = -(-k // -(-k // step))
    return [(lo, min(k, lo + size)) for lo in range(0, k, size)]


def _round_up(x: int, a: int) -> int:
    return -(-x // a) * a


def _margin(w_band: int) -> int:
    return w_band // 2 - 32


def _concat_off(parts: list[np.ndarray]):
    """(blob, offsets) of a list of 1-D arrays."""
    off = np.zeros(len(parts) + 1, np.int64)
    lens = np.fromiter((len(p) for p in parts), np.int64, len(parts))
    np.cumsum(lens, out=off[1:])
    blob = np.concatenate(parts) if parts else np.zeros(0, np.uint8)
    return blob, off


def _flat_ranges(starts: np.ndarray, lens: np.ndarray) -> np.ndarray:
    """Flat index array covering [starts[i], starts[i] + lens[i]) per i."""
    total = int(lens.sum())
    if not total:
        return np.zeros(0, np.int64)
    ends = np.cumsum(lens)
    base = np.asarray(starts, np.int64) - (ends - lens)
    return np.repeat(base, lens) + np.arange(total, dtype=np.int64)


def bucket_tiers(mlen: np.ndarray, nlen: np.ndarray, tiers) -> np.ndarray:
    """Tier index per item, -1 for the host: the first tier that fits the
    lengths and the length mismatch, then small tiers (under 1024 items)
    folded into a compatible bigger used tier, exactly as the reference
    buckets (consensus_stage_tpu.py:617-642), so every item lands in the
    same band geometry as there."""
    tier_id = np.full(len(mlen), -1, np.int64)
    for ti, (cap, wb) in enumerate(tiers):
        ok = ((tier_id < 0) & (mlen <= cap) & (nlen <= cap)
              & (np.abs(nlen - mlen) <= _margin(wb)))
        tier_id[ok] = ti
    counts = np.bincount(tier_id[tier_id >= 0], minlength=len(tiers))
    for ti, (cap, wb) in enumerate(tiers):
        if not 0 < counts[ti] < 1024:
            continue
        for tj in range(ti + 1, len(tiers)):
            cj, wj = tiers[tj]
            if (cj >= cap and wj >= wb and counts[tj] > 0
                    and counts[ti] <= counts[tj]):
                tier_id[tier_id == ti] = tj
                counts[tj] += counts[ti]
                counts[ti] = 0
                break
    return tier_id


class TorchConsensusStage:
    """consensus_windows() on `device`: "cuda" launches the kernels; "cpu"
    runs their plain PyTorch versions (tests only)."""

    def __init__(self, cfg, device):
        self.cfg = cfg
        self.device = torch.device(device)
        self.prof = defaultdict(float)
        # per refinement pass: items per (cap, band) tier, -1 = host
        self.tier_items: list[dict] = []
        self.n_cohorts = 0  # cohorts of the last consensus_windows()
        self.n_windows = 0  # windows of the last consensus_windows()
        self.use_gather = False  # the last run's route: gather or dense
        self._ops_scratch = np.empty(0, np.int32)  # decode buffer

    def consensus_windows(self, windows, cfg, logger):
        from ..core.windows import WINDOW_TYPE_TGS

        self.prof = defaultdict(float)
        self.tier_items = []
        n_win = self.n_windows = windows.num_windows
        tgs = windows.window_type == WINDOW_TYPE_TGS

        # windows with < 2 layers pass through (reference: src/window.cpp)
        consensus: list[bytes | None] = [None] * n_win
        polished = [False] * n_win
        active = []
        for w in range(n_win):
            if windows.n_layers(w) < 2:
                consensus[w] = windows.backbone(w).tobytes()
            else:
                active.append(w)
        if not active:
            return [c or b"" for c in consensus], polished

        # the accelerator path caps layers per window like the reference's
        # GPU path (MAX_DEPTH_PER_WINDOW = 200)
        st = _StaticItems(windows, active,
                          depth_cap=max(1, cfg.max_window_depth))
        state = _RoundState(windows, active, cfg.gap)

        # ceiling on backbone expansion: the largest canonical tier any
        # pass could need for this window set
        needed = max(int(st.lay_len.max(initial=0)),
                     2 * state.max_backbone + 64, 256)
        for cap, _ in _TIERS:
            if needed <= cap:
                break
        else:
            cap = _round_up(needed, 1024)
        max_expand = cap

        passes = max(1, cfg.refine_passes)
        use_gather = self.use_gather = _will_use_gather()

        # cohort pipelining: the windows split into cohorts whose rounds
        # interleave, so one cohort's host decode and merge run while the
        # other cohorts' chunks are on the device; the gather form also
        # keeps each cohort's layer blob under RACON_TPU_GATHER_BLOB_ELEMS
        self.n_cohorts = self._auto_cohorts(
            len(active), passes,
            gather_elems=int(st.lay_off[-1]) if use_gather else 0)
        cohorts = []
        bounds = np.linspace(0, len(active), self.n_cohorts + 1).astype(int)
        for lo, hi in zip(bounds[:-1], bounds[1:]):
            part = active[lo:hi]  # never empty: n_cohorts <= len(active)
            if self.n_cohorts == 1:
                co = _Cohort(part, st, state)
            else:
                co = _Cohort(part, st.subset(np.arange(lo, hi)),
                             _RoundState(windows, part, cfg.gap))
            if use_gather:
                with self._span("dispatch"):
                    self._upload_layers(co)
            cohorts.append(co)

        def dispatch(co):
            with self._span("dispatch"):
                co.pending = self._round_dispatch(cfg, co, max_expand,
                                                  windows)

        total_units = len(active) * passes  # window-rounds, for progress
        done_units = 0
        for co in cohorts:
            dispatch(co)
        while any(co.pending is not None for co in cohorts):
            for co in cohorts:
                if co.pending is None:
                    continue
                final = co.pass_no == passes - 1
                retired = self._round_complete(co.pending, cfg, final, tgs,
                                               consensus, polished)
                co.pending = None
                co.pass_no += 1
                done_units += len(co.active)
                if retired:  # converged: their remaining rounds are done too
                    done_units += len(retired) * (passes - co.pass_no)
                logger.bar_progress(
                    "[racon::Polisher::polish] generating consensus",
                    done_units, total_units)
                if co.pass_no >= passes:
                    continue
                if retired:
                    # converged windows were finalized in-round; later
                    # rounds would reproduce their state bit for bit
                    keep_z = np.array([z for z, w in enumerate(co.active)
                                       if w not in retired], np.int64)
                    co.active = [co.active[z] for z in keep_z]
                    if co.active:
                        co.st = co.st.subset(keep_z)
                        co.state.subset(keep_z)
                if co.active:
                    dispatch(co)
        logger.bar_progress("[racon::Polisher::polish] generating consensus",
                            total_units, total_units)
        return [c if c is not None else b"" for c in consensus], polished

    def _auto_cohorts(self, n_active: int, passes: int,
                      gather_elems: int = 0) -> int:
        """Cohort count (the reference's _auto_cohorts without its link
        terms): 3 on a CUDA device when there are >= 256 windows and >= 2
        passes, else 1; where the gather form runs, raised so that each
        cohort's layer blob (gather_elems elements in all) stays under
        RACON_TPU_GATHER_BLOB_ELEMS (default 2^30, below the int32
        indices' 2^31); RACON_TPU_COHORTS forces; at most one cohort a
        window."""
        n_coh = 1
        if self.device.type == "cuda" and n_active >= 256 and passes >= 2:
            n_coh = 3
        if gather_elems:
            try:
                cap_e = int(os.environ.get("RACON_TPU_GATHER_BLOB_ELEMS",
                                           1 << 30))
            except ValueError:
                cap_e = 1 << 30
            n_coh = max(n_coh, -(-gather_elems // max(1, cap_e)))
        env_coh = os.environ.get("RACON_TPU_COHORTS")
        if env_coh:
            n_coh = int(env_coh)
        return max(1, min(n_coh, max(1, n_active)))

    def _upload_layers(self, co) -> None:
        """The gather form's per-cohort upload: the cohort's layer codes as
        one word blob on each device of its dispatch (the mesh's, or the
        stage's), addressed by offsets into this cohort's items
        (_StaticItems.rebase_dev), which retirement subsets carry along.
        A blob past the int32 indices' range leaves the cohort on the
        dense route, counted and logged."""
        co.st.rebase_dev()
        elems = int(co.st.lay_off[-1])
        if elems >= MAX_BLOB_ELEMS:
            self._dense_note(f"a cohort's layer blob of {elems} elements")
            return
        words = code_words(co.st.lay_codes)
        co.dev_q = put_blob(words, gather_devices(self.device))
        self.prof["gather_blob_bytes"] += words.nbytes * len(co.dev_q)

    @staticmethod
    def _dense_note(what: str) -> None:
        sys.stderr.write(f"[racon_tpu_torch::consensus] {what} passes the "
                         "gather form's 2^31 element indices: dense "
                         "route\n")

    @contextlib.contextmanager
    def _span(self, key: str):
        """Time a host phase into prof[key + "_s"] and name it in a
        torch.profiler trace ("racon::" + key)."""
        t0 = time.perf_counter()
        with torch.profiler.record_function("racon::" + key):
            yield
        self.prof[key + "_s"] += time.perf_counter() - t0

    # ------------------------------------------------------------------ #

    def _round_dispatch(self, cfg, co, max_expand, windows):
        """First half of a cohort's round: per-round state prep, tier
        bucketing and the device launches, each chunk's payload fetch
        started right behind its launches. Returns the context
        _round_complete consumes; in between, the device works while the
        host serves another cohort."""
        active, st, state = co.active, co.st, co.state
        thr = cfg.num_threads
        cur_enc = encode(state.cur).astype(np.int8)
        del8 = (state.dcost != 0).view(np.int8)  # bitmask: cost gap or free
        sb, se = bindings.project_spans(
            state.slots, state.off, st.item_wz,
            windows.lay_begin[st.item_li], windows.lay_end[st.item_li], thr)
        nlen = se - sb + 1
        mlen = st.lay_len
        t_start = state.off[st.item_wz] + sb
        t_end = state.off[st.item_wz] + se + 1

        tiers = [t for t in _TIERS if t[0] <= max_expand] or [_TIERS[0]]
        tier_id = bucket_tiers(mlen, nlen, tiers)
        ids, counts = np.unique(tier_id, return_counts=True)
        if len(self.tier_items) <= co.pass_no:
            self.tier_items.append(defaultdict(int))
        for t, c in zip(ids, counts):
            self.tier_items[co.pass_no][tiers[t] if t >= 0 else -1] += int(c)
        host_parts = [np.flatnonzero(tier_id < 0)]
        pending = []
        blobs = None
        if co.dev_q is not None:
            if len(state.cur) < MAX_BLOB_ELEMS:
                # the pass's blobs, once each, shared by every chunk
                devices = gather_devices(self.device)
                words = (code_words(cur_enc), bit_words(del8))
                blobs = (co.dev_q, *(put_blob(w, devices) for w in words))
                self.prof["gather_blob_bytes"] += sum(
                    w.nbytes for w in words) * len(blobs[1])
            else:
                self._dense_note(f"a pass's backbone blob of "
                                 f"{len(state.cur)} elements")
        for ti, (cap, w_band) in enumerate(tiers):
            idx = np.flatnonzero(tier_id == ti)
            if not len(idx):
                continue
            if not sweep_fits(cap, cap, w_band):
                # wider than the sweep kernel's band: host aligner
                host_parts.append(idx)
                self.prof["wide_host_items"] += len(idx)
                continue
            for lo, hi in chunk_spans(len(idx), chunk_size(cap, w_band,
                                                           8192)):
                sel = idx[lo:hi]
                sc = dict(m_cap=cap, n_cap=cap, w_band=w_band,
                          match=cfg.match, mismatch=cfg.mismatch, gap=cfg.gap,
                          device=self.device)
                if blobs is not None:
                    meta = np.stack([st.lay_start_dev[sel], mlen[sel],
                                     t_start[sel], nlen[sel]],
                                    axis=1).astype(np.int32)
                    payload, _, fmt = align_walk_gather(*blobs, meta, **sc)
                    self.prof["gather_items"] += len(sel)
                    self.prof["gather_meta_bytes"] += meta.nbytes
                else:
                    if self.use_gather:  # past the 2^31 guard
                        self.prof["gather_dense_chunks"] += 1
                    q4 = bindings.pack_rows_nib(
                        st.lay_codes, st.lay_off[sel],
                        st.lay_off[sel] + mlen[sel], cap, PAD_CODE, thr)
                    t4 = bindings.pack_rows_nib(cur_enc, t_start[sel],
                                                t_end[sel], cap, PAD_CODE,
                                                thr)
                    dcb = bindings.pack_rows_bits(del8, t_start[sel],
                                                  t_end[sel], cap, thr)
                    payload, _, fmt = align_walk_padded(
                        q4, t4, dcb, mlen[sel].astype(np.int32),
                        nlen[sel].astype(np.int32), **sc)
                pending.append((sel, cap, w_band, fmt, payload,
                                prefetch.submit(payload)))
                self.prof["device_items"] += len(sel)
        return dict(active=active, st=st, state=state, max_expand=max_expand,
                    sb=sb, t_start=t_start, mlen=mlen, nlen=nlen,
                    host_parts=host_parts, pending=pending)

    def _round_complete(self, ctx, cfg, final, tgs, consensus, polished):
        """Second half of a cohort's round: wait for and decode the
        payloads, realign escapes on the host, merge the round natively
        and replace the cohort's state. Returns the retired (converged)
        window ids."""
        gap = cfg.gap
        thr = cfg.num_threads
        active, st, state = ctx["active"], ctx["st"], ctx["state"]
        mlen, nlen = ctx["mlen"], ctx["nlen"]
        t_start = ctx["t_start"]
        host_parts = ctx["host_parts"]
        n_items = st.n_items
        lens = np.diff(state.off)

        # decode straight into the merge's padded per-item layout
        # (capacity m + n + 2 runs per item). The buffer is grow-only and
        # reused across rounds and cohorts (calls never overlap): a fresh
        # one per round re-pays the page faults of every page it touches.
        ops_off2 = np.zeros(n_items + 1, np.int64)
        np.cumsum(mlen + nlen + 2, out=ops_off2[1:])
        need = int(ops_off2[-1]) * 2
        if self._ops_scratch.size < need:
            self._ops_scratch = np.empty(need + need // 4, np.int32)
        ops_blob = self._ops_scratch[:need].reshape(-1, 2)
        cnt = np.zeros(n_items, np.int64)
        for sel, cap, w_band, fmt, payload, fetch in ctx["pending"]:
            with self._span("fetch"):  # the wait: the copy ran on its own
                payload = prefetch.resolve(payload, fetch)
            with self._span("decode"):
                escaped = payload[:, -1] != 0
                decode, codes, budget = payload_decoder(fmt, payload, cap,
                                                        w_band)
                _, _, counts = decode(codes, budget, mlen[sel], nlen[sel],
                                      thr, dst=ops_blob,
                                      dst_off=ops_off2[:-1][sel])
                host_parts.append(sel[escaped])  # band escape -> host
                cnt[sel[~escaped]] = counts[~escaped]
                self.prof["escaped_items"] += int(escaped.sum())

        # host alignment with per-column deletion costs
        with self._span("host_fallback"):
            host_idx = np.concatenate(host_parts)
            self.prof["host_items"] += len(host_idx)
            if len(host_idx):
                hm = mlen[host_idx]
                hn = nlen[host_idx]
                qoff = np.zeros(len(host_idx) + 1, np.int64)
                np.cumsum(hm, out=qoff[1:])
                toff = np.zeros(len(host_idx) + 1, np.int64)
                np.cumsum(hn, out=toff[1:])
                qblob = bindings.gather_ranges(
                    st.lay_blob, st.lay_off[host_idx], hm, thr)
                tsel = _flat_ranges(t_start[host_idx], hn)
                ops_flat, ops_off, counts = bindings.align_batch_percol(
                    qblob, qoff, state.cur[tsel], toff, state.dcost[tsel],
                    cfg.match, cfg.mismatch, gap, thr)
                cnt[host_idx] = counts
                bindings.gather_ranges(ops_flat, ops_off[:-1], counts, thr,
                                       dst=ops_blob,
                                       dst_off=ops_off2[:-1][host_idx])

        # merge round per window (native)
        with self._span("poa_round"):
            res = bindings.poa_round_batch(
                state.cur, state.off, state.w, st.item_off,
                st.lay_blob, st.lay_off, st.layw_blob,
                ctx["sb"].astype(np.int32), ops_blob, ops_off2,
                final, tgs, cfg.trim, gap, cfg.candidate_frac,
                cfg.candidate_min, ctx["max_expand"], st.win_id,
                st.win_rank, thr, 2 * lens + 512, with_final=not final,
                ops_cnt=cnt)
        return self._finish_round(res, final, active, state, lens, thr,
                                  consensus, polished)

    @staticmethod
    def _finish_round(res, final, active, state, lens, thr, consensus,
                      polished):
        """Emit finals, retire converged windows, replace the state."""
        out_blob, out_off, out_len, out_del, out_slots, out_pol = res[:6]
        retired: set[int] = set()
        if final:
            raw = out_blob.tobytes()
            for z, w in enumerate(active):
                o = int(out_off[z])
                consensus[w] = raw[o : o + int(out_len[z])]
                polished[w] = bool(out_pol[z])
            return retired

        # the round was a fixed point (same backbone, deletion costs, slot
        # map, zero backbone weights): later rounds would reproduce the
        # graph bit for bit and fin_blob already holds the final consensus
        fin_blob, fin_len, fin_pol, conv = res[6:]
        conv &= ~state.has_w
        conv_z = np.flatnonzero(conv)
        if len(conv_z):
            retired = {active[int(z)] for z in conv_z}
            raw = fin_blob.tobytes()
            for z in conv_z:
                z = int(z)
                o = int(out_off[z])
                consensus[active[z]] = raw[o : o + int(fin_len[z])]
                polished[active[z]] = bool(fin_pol[z])

        new_len = out_len.astype(np.int64)
        starts = out_off[: len(active)]
        new_slots, new_off = bindings.compose_slots(
            state.slots, state.off, lens, out_slots, starts, new_len, thr)
        state.cur = bindings.gather_ranges(out_blob, starts, new_len, thr)
        state.dcost = bindings.gather_ranges(out_del, starts, new_len, thr)
        state.slots = new_slots
        state.off = new_off
        state.w = np.zeros(len(state.cur), np.int32)
        state.has_w = np.zeros(len(active), bool)
        return retired


class _Cohort:
    """A cohort's windows, item layout and refinement state, and its
    round in flight."""

    def __init__(self, active, st, state):
        self.active = active
        self.st = st
        self.state = state
        self.pass_no = 0
        self.pending = None
        self.dev_q = None  # the gather form's layer blob, per device


class _StaticItems:
    """Round-invariant item layout: flat blobs and offsets for every
    (window, layer) pair, grouped by window in `active` order (the layout
    rt_poa_round_batch consumes)."""

    def __init__(self, windows, active, depth_cap):
        parts = [np.asarray(windows.layer_indices(w)[:depth_cap], np.int64)
                 for w in active]
        self.item_li = (np.concatenate(parts) if parts
                        else np.zeros(0, np.int64))
        counts = np.fromiter((len(p) for p in parts), np.int64, len(active))
        self.item_off = np.zeros(len(active) + 1, np.int64)
        np.cumsum(counts, out=self.item_off[1:])
        self.item_wz = np.repeat(np.arange(len(active)), counts)
        self.n_items = int(self.item_off[-1])

        # layers are slices of the store's forward blob or of the prepared
        # reverse complements: one combined-source ranged gather
        li = self.item_li
        store = windows.sequences
        qid = windows.lay_qid[li]
        strand = windows.lay_strand[li]
        qb = windows.lay_qbegin[li]
        qlen = windows.lay_qlen[li].astype(np.int64)
        self.lay_off = np.zeros(self.n_items + 1, np.int64)
        np.cumsum(qlen, out=self.lay_off[1:])
        self.lay_len = qlen
        self.lay_start_dev = self.lay_off[:-1].copy()
        thr = _nthr()
        rc_blob, rc_start = store.rc_arrays()
        rq_blob, rq_start = store.rq_arrays()
        hasq = store.qual_off[qid + 1] > store.qual_off[qid]
        base = np.where(strand, len(store.blob) + rc_start[qid],
                        store.data_off[qid]) + qb
        src = np.concatenate([store.blob, rc_blob])
        blob = bindings.gather_ranges(src, base, qlen, thr)
        # weights: phred-shifted quality, 1 where a layer has none
        if not hasq.any():
            weights = np.ones(int(self.lay_off[-1]), np.int32)
        else:
            qbase = np.where(strand, len(store.qual_blob) + rq_start[qid],
                             store.qual_off[qid]) + qb
            pad = int(qlen.max(initial=0)) + 1
            qbase = np.where(hasq, qbase,
                             len(store.qual_blob) + len(rq_blob))
            qsrc = np.concatenate([store.qual_blob, rq_blob,
                                   np.zeros(pad, np.uint8)])
            q8 = bindings.gather_ranges(qsrc, qbase, qlen, thr)
            weights = q8.astype(np.int32) - PHRED_OFFSET
            if not hasq.all():
                weights[~np.repeat(hasq, qlen)] = 1
        self.lay_blob = blob
        self.lay_codes = encode(blob).astype(np.int8)
        self.layw_blob = weights
        self.win_id = np.array([windows.win_target[w] for w in active],
                               np.int64)
        self.win_rank = np.array([windows.win_rank[w] for w in active],
                                 np.int32)

    def subset(self, keep_z: np.ndarray) -> "_StaticItems":
        """The items of a subset of windows (indices into the active
        list), sliced from the existing flat arrays."""
        s = object.__new__(_StaticItems)
        counts = self.item_off[keep_z + 1] - self.item_off[keep_z]
        ksel = _flat_ranges(self.item_off[keep_z], counts)
        s.item_li = self.item_li[ksel]
        s.item_off = np.zeros(len(keep_z) + 1, np.int64)
        np.cumsum(counts, out=s.item_off[1:])
        s.item_wz = np.repeat(np.arange(len(keep_z)), counts)
        s.n_items = int(s.item_off[-1])
        klen = self.lay_len[ksel]
        s.lay_off = np.zeros(s.n_items + 1, np.int64)
        np.cumsum(klen, out=s.lay_off[1:])
        s.lay_len = klen
        s.lay_start_dev = self.lay_start_dev[ksel]
        starts = self.lay_off[ksel]
        thr = _nthr()
        s.lay_blob = bindings.gather_ranges(self.lay_blob, starts, klen, thr)
        s.lay_codes = bindings.gather_ranges(self.lay_codes, starts, klen,
                                             thr)
        s.layw_blob = bindings.gather_ranges(self.layw_blob, starts, klen,
                                             thr)
        s.win_id = self.win_id[keep_z]
        s.win_rank = self.win_rank[keep_z]
        return s

    def rebase_dev(self) -> None:
        """Make lay_start_dev the offsets into this item set's own layer
        blob (not the blob it was cut from): called right before that blob
        goes up as a cohort's device copy. Retirement subsets carry these
        offsets, so they keep addressing the uploaded blob."""
        self.lay_start_dev = self.lay_off[:-1].copy()


class _RoundState:
    """Per-window refinement state in flat-blob form, aligned with the
    active window list: current backbone bytes, per-column weights and
    deletion costs, and the slot -> original-position map share `off`."""

    def __init__(self, windows, active, gap):
        self.cur, self.off = _concat_off(
            [np.asarray(windows.backbone(w)) for w in active])
        total = len(self.cur)
        lens = np.diff(self.off)
        self.w = np.zeros(total, np.int32)
        for z, wid in enumerate(active):  # backbone quality, round 1 only
            bq = windows.backbone_quality(wid)
            if bq is not None:
                self.w[self.off[z] : self.off[z + 1]] = (
                    bq.astype(np.int32) - PHRED_OFFSET)
        self.dcost = np.full(total, gap, np.int32)
        self.slots = (np.arange(total, dtype=np.int64)
                      - np.repeat(self.off[:-1], lens))
        self.has_w = (np.add.reduceat(np.abs(self.w), self.off[:-1]) > 0
                      if total else np.zeros(0, bool))
        self.max_backbone = int(lens.max(initial=0))

    def subset(self, keep_z: np.ndarray) -> None:
        """Drop retired windows in place (indices into the active list)."""
        lens = np.diff(self.off)[keep_z]
        starts = self.off[keep_z]
        thr = _nthr()
        self.cur = bindings.gather_ranges(self.cur, starts, lens, thr)
        self.w = bindings.gather_ranges(self.w, starts, lens, thr)
        self.dcost = bindings.gather_ranges(self.dcost, starts, lens, thr)
        self.slots = bindings.gather_ranges(self.slots, starts, lens, thr)
        self.off = np.zeros(len(keep_z) + 1, np.int64)
        np.cumsum(lens, out=self.off[1:])
        self.has_w = self.has_w[keep_z]


def _will_use_gather() -> bool:
    """Whether the stage dispatches the device-gather form:
    RACON_TPU_DEVGATHER=1 forces it; "0" or unset keeps the dense route,
    the reference's choice without a slow link (read at call time)."""
    return os.environ.get("RACON_TPU_DEVGATHER") == "1"


def _nthr() -> int:
    return os.cpu_count() or 2

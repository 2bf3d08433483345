"""Band geometry, payload sizes and base codes shared by the port's kernels
and stages: jax-free ports of the numpy helpers that live inside
racon_tpu/ops/nw_kernel.py and racon_tpu/ops/myers_kernel.py.

Every value here must equal the reference's, because payload formats and
budgets are decoded by the port's copy of the native runtime
(racon_tpu_torch/native/src/align.cpp) and compared byte for byte in the tests.
"""

from __future__ import annotations

import os

import numpy as np
import torch

PAD_CODE = 5              # nw_kernel.py:43; matches itself, rejects bases
NEG = -(10 ** 5)          # nw_kernel.py:44; forbids pad-vs-real pairing
SCAN_FILL = 2 * NEG       # fill of the scored sweep's max-plus prefix scan
DP16_FILL = -30000        # the scan's fill in the int16 DP (nw_kernel.py:815)
PACK = 16                 # query rows per int32 move word (nw_kernel._PACK)
GROUP = 128               # query rows per grid step of the TPU's transposed
                          # sweeps (nw_kernel._GROUP)
NW_CODES = 6              # ACGTN + PAD planes of the Myers Peq mask

# RLE event bytes (nw_kernel.py:1226-1228); 1..16 = diagonal run length
RLE_SKIP = 0
RLE_UP = 201
RLE_LEFT = 202

# packed2 step codes (nw_kernel.py:1798, 1807-1808): 0 diagonal, 1 up,
# 2 left, 3 skip; four per byte
OP_STREAM_SKIP = 3

# rows-payload record ops (nw_kernel.py:1887-1888)
REC_DIAG = 1
REC_UP = 2

_CODE = np.full(256, 4, dtype=np.uint8)  # anything unusual -> N
for _i, _b in enumerate(b"ACGTN"):
    _CODE[_b] = _i


def encode(seq: np.ndarray) -> np.ndarray:
    """Bytes -> base codes 0..4 (ACGTN; anything else is N)."""
    return _CODE[seq]


def band_dlo(m_cap: int, n_cap: int, w_band: int) -> int:
    """j = i + dlo + k for band lane k (nw_kernel.py:57-59)."""
    return n_cap - m_cap - w_band // 2


def _round4(x: int) -> int:
    return -(-x // 4) * 4


def walk_steps(m_cap: int, n_cap: int, w_band: int) -> int:
    """Step budget of the 2-bit op stream (nw_kernel.py:251-256)."""
    return min(_round4(m_cap + 2 * w_band), _round4(m_cap + n_cap))


def rle_events(m_cap: int, n_cap: int, w_band: int) -> int:
    """Event budget of the RLE walk (nw_kernel.py:1232-1237); walks that
    need more are flagged escaped and realigned on the host."""
    return max(walk_steps(m_cap, n_cap, w_band) // 4, 64)


def rows_payload_width(m_cap: int) -> int:
    """Rows payload bytes per item: one record per query row, the
    final-deletions byte and the escape flag (nw_kernel.py:1891-1894)."""
    return m_cap + 2


def scan_span(w_band: int) -> int:
    """Reach of the reference's log-step max-plus scan: steps 1, 2, 4, ...
    below W cover 2^ceil(log2 W) lanes. Lane k's result includes the
    scan's fill value exactly when k <= span - 2 (see nw_kernel
    _nw_band_kernel_t8: lanes below each shift read the fill)."""
    s = 1
    while s < w_band:
        s *= 2
    return s


def dp16_eligible(m_cap: int, n_cap: int, match: int, mismatch: int,
                  gap: int) -> bool:
    """Whether the scored sweep runs H in int16 (nw_kernel.py:790-808):
    only under RACON_TPU_DP16=1 (read at call time; default off), and only
    where every intermediate stays in int16 range, the most negative being
    neg + neg with neg = -((m_cap + n_cap) * cmax + 64)."""
    if os.environ.get("RACON_TPU_DP16", "0") != "1":
        return False
    cmax = max(abs(match), abs(mismatch), abs(gap))
    return 2 * ((m_cap + n_cap) * cmax + 64) <= 30000


def dp_consts(m_cap: int, n_cap: int, match: int, mismatch: int,
              gap: int) -> tuple[torch.dtype, int, int]:
    """(dtype of H, the sentinel neg, the scan's fill) of the scored sweep
    (nw_kernel.py:811-815): int16 with neg = -((m_cap + n_cap) * cmax + 64)
    and fill DP16_FILL where dp16_eligible holds, else int32 with NEG and
    SCAN_FILL."""
    if dp16_eligible(m_cap, n_cap, match, mismatch, gap):
        cmax = max(abs(match), abs(mismatch), abs(gap))
        return torch.int16, -((m_cap + n_cap) * cmax + 64), DP16_FILL
    return torch.int32, NEG, SCAN_FILL


def guard_bits(w_band: int) -> int:
    """Zero-bit guard on each side of the Peq mask (myers_kernel.py:61)."""
    return w_band // 2 + 32


def peq_words(n_cap: int, w_band: int) -> int:
    """32-bit words per Peq plane, guards included (myers_kernel.py:67)."""
    return (n_cap + 2 * guard_bits(w_band)) // 32


# Launch geometry of the kernels built around one warp per item (and of
# the RLE walk, a warp of items); the constants mirror kSweepRing
# (kernels/csrc/common.cuh), kSweepWarps (kernels/csrc/nw_sweep.cu),
# kSweep16Warps, kStrip16Warps (kernels/csrc/nw_sweep16.cu), kWalkWarps,
# kWalkRows (kernels/csrc/myers_walk.cu), kWalkItems, kMaxStage
# (kernels/csrc/rle_walk.cu), kPackedWarps, kPackedSlots, kWindowLanes,
# kStageBytes (kernels/csrc/packed_walk.cu) and kRowsWarps, kRowsSlots
# (kernels/csrc/rows_walk.cu).
SWEEP_WARP_MAX_W = 256    # widest band the warp-per-item sweep takes
SWEEP_WARPS = 4           # items (warps) per block of the warp sweep
SWEEP_RING = 2            # rows in each strip's hand-off rings
SWEEP_SMS = 132           # SMs of the H100 the strip kernel's rule counts
SWEEP16_SM_WARPS = 4      # warps an SM the int16 strip kernel's rule asks for
MYERS_WALK_WARPS = 2      # items (warps) per block of the Myers walk
MYERS_WALK_ROWS = 16      # query rows per cp.async group of the walk
RLE_WALK_ITEMS = 32       # items (threads) per block of the RLE walk
PACKED_WALK_WARPS = 1     # items (warps) per block of the packed2 walk
PACKED_WALK_SLOTS = 16    # word-rows (16 query rows) in its warps' rings
PACKED_WALK_LANES = 128   # lanes of a word-row its ring slots hold, at most
PACKED_WALK_STAGE = 512   # payload bytes it stages per copy-out
ROWS_WALK_WARPS = 2       # items (warps) per block of the rows walk
ROWS_WALK_SLOTS = 4       # word-rows (16 query rows) in its warps' rings
SMEM_BLOCK_MAX = 227 * 1024  # shared bytes one block may use (H100)


def sweep_lanes(w_band: int, B: int) -> int:
    """Band lanes each thread of the strip kernel owns at band width W >
    256 and B items (strip_lanes in kernels/csrc/nw_sweep.cu): eight where
    W is a multiple of 256 and strips of eight still put 16 warps or more
    on each of the H100's SWEEP_SMS SMs (an SM's items one block each),
    else four; timed on the card at every K2 and K5 shape (PERF.md). A
    warp's strip is 32 times as many lanes. (The warp kernel, W <= 256,
    gives each thread W / 32 lanes.)"""
    items_per_sm = -(-B // SWEEP_SMS)
    return 8 if w_band % 256 == 0 and w_band // 256 * items_per_sm >= 16 \
        else 4


def sweep_warps(w_band: int, B: int) -> int:
    """Warps (strips) per item of the strip kernel: strips of
    32 * sweep_lanes lanes, the last one cut at W."""
    return -(-w_band // (32 * sweep_lanes(w_band, B)))


def sweep_kernel(w_band: int, dp16: bool = False) -> str:
    """Which sweep kernel a band width launches, by its launch counter:
    "nw_sweep" (the warp kernel, K1's tiers), "nw_sweep_block" (the strip
    kernel, one block of warp strips per item, at K2's tiers and the align
    stage's scored route up to W = 1024) or "nw_sweep_wide" (the strip
    kernel at W = 2048 and 4096: K5). With dp16 (H in int16, sweep_dp16)
    up to W = 1024, their int16 forms "nw_sweep16" (the int16 warp
    kernel) and "nw_sweep_block16" (the int16 strip kernel); K5 has
    none."""
    if w_band > 1024:
        return "nw_sweep_wide"
    name = "nw_sweep" if w_band <= SWEEP_WARP_MAX_W else "nw_sweep_block"
    return name + "16" if dp16 else name


def sweep_dp16(m_cap: int, n_cap: int, w_band: int, match: int,
               mismatch: int, gap: int) -> bool:
    """Whether the sweep at this shape runs H in int16: dp16_eligible,
    where the reference's transposed kernels (t8, t8big) run, W <= 1024;
    its lane-major kernel (W = 2048, 4096) is int32 only."""
    return w_band <= 1024 and dp16_eligible(m_cap, n_cap, match, mismatch,
                                            gap)


def sweep16_tpi(w_band: int) -> int:
    """Threads per item of the int16 warp kernel (W <= 256): 8, four items
    a warp and eight pairs a thread, at W = 128, so that the row's
    shuffles and bookkeeping are shared by more pairs (PERF.md); 32 at
    the other widths."""
    return 8 if w_band == 128 else 32


def sweep16_pairs(w_band: int, B: int) -> int:
    """s16x2 pairs (two band lanes each) per thread of the int16 strip
    kernel at band width W > 256 and B items (strip16_pairs in
    kernels/csrc/nw_sweep16.cu): the most, 8 then 4, that still put
    SWEEP16_SM_WARPS warps or more (one a scheduler) on each of the H100's
    SWEEP_SMS SMs (an SM's items one block each), else 2; timed on the
    card at 2, 4 and 8 (benchmarks/strip_ab.py, PERF.md). A warp's strip
    is 64 times as many lanes."""
    items_per_sm = -(-B // SWEEP_SMS)
    for pairs in (8, 4):
        if items_per_sm * -(-w_band // (64 * pairs)) >= SWEEP16_SM_WARPS:
            return pairs
    return 2


def sweep16_warps(w_band: int, B: int) -> int:
    """Warps (strips) per item of the int16 strip kernel: strips of
    64 * sweep16_pairs lanes, the last one cut at W."""
    return -(-w_band // (64 * sweep16_pairs(w_band, B)))


def sweep16_threads(w_band: int, B: int = 1) -> int:
    """Threads per item of the int16 sweep: sweep16_tpi for the warp
    kernel; 32 a strip for the strip kernel, whose strips depend on the
    launch's B items (W = 512: 32 at B > 396, 64 at B = 133 .. 396, 128
    at B <= 132)."""
    if w_band <= SWEEP_WARP_MAX_W:
        return sweep16_tpi(w_band)
    return 32 * sweep16_warps(w_band, B)


def sweep_launch(B: int, m_cap: int, n_cap: int, w_band: int,
                 dp16: bool = False) -> tuple[int, int, int]:
    """(blocks, threads per block, shared bytes per block) of one sweep
    launch, as rtt_nw_sweep / rtt_nw_sweep_smem and rtt_nw_sweep16 /
    rtt_nw_sweep16_smem compute them: the warp kernel holds SWEEP_WARPS
    items a block, each warp its item's code bytes (m_cap + n_cap); the
    strip kernel one item, sweep_warps warps, with each warp's two
    hand-off rings of SWEEP_RING 8-byte slots, the query code bytes and
    the target columns as 32-bit values (code | deletion cost << 8). The
    int16 warp kernel holds 32 * SWEEP_WARPS / sweep16_tpi items a block,
    each its query code bytes and its target columns as 16-bit halves
    (m_cap + 2 n_cap); the int16 strip kernel one item, sweep16_warps
    warps, their rings as the int32 strip kernel's, and the codes as the
    int16 warp kernel's."""
    kernel = sweep_kernel(w_band, dp16)
    if kernel == "nw_sweep":
        return (-(-B // SWEEP_WARPS), 32 * SWEEP_WARPS,
                SWEEP_WARPS * (m_cap + n_cap))
    if kernel == "nw_sweep16":
        per_block = 32 * SWEEP_WARPS // sweep16_tpi(w_band)
        return (-(-B // per_block), 32 * SWEEP_WARPS,
                per_block * (m_cap + 2 * n_cap))
    if kernel == "nw_sweep_block16":
        warps = sweep16_warps(w_band, B)
        return B, 32 * warps, 16 * SWEEP_RING * warps + m_cap + 2 * n_cap
    warps = sweep_warps(w_band, B)
    return B, 32 * warps, 16 * SWEEP_RING * warps + m_cap + 4 * n_cap


def myers_walk_ring(w_band: int) -> int:
    """Query rows in each warp's shared-memory ring of the Myers walk (both
    planes, 2 W/32 words a row): 64 up to W = 1024, 32 above, so that a
    warp streams up to three (or one) groups of MYERS_WALK_ROWS rows ahead
    of the row it walks in 16 KB (32 KB at W = 4096)."""
    return 64 if w_band <= 1024 else 32


def myers_walk_launch(B: int, w_band: int) -> tuple[int, int, int]:
    """(blocks, threads per block, shared bytes per block) of one Myers
    walk launch: MYERS_WALK_WARPS items a block, one ring per warp."""
    return (-(-B // MYERS_WALK_WARPS), 32 * MYERS_WALK_WARPS,
            MYERS_WALK_WARPS * myers_walk_ring(w_band) * 2 * (w_band // 32)
            * 4)


def packed_walk_launch(B: int, w_band: int) -> tuple[int, int, int]:
    """(blocks, threads per block, shared bytes per block) of one packed2
    walk launch: PACKED_WALK_WARPS items a block (one, so that a chunk of
    up to 132 items takes as many SMs), each warp a ring of
    PACKED_WALK_SLOTS slots that hold PACKED_WALK_LANES lanes of a
    word-row (the whole row where W is narrower; a lane outside the window
    is read from global memory), a staging buffer of PACKED_WALK_STAGE
    bytes and a base lane per slot."""
    lanes = min(w_band, PACKED_WALK_LANES)
    return (-(-B // PACKED_WALK_WARPS), 32 * PACKED_WALK_WARPS,
            PACKED_WALK_WARPS * (PACKED_WALK_SLOTS * (lanes + 1) * 4
                                 + PACKED_WALK_STAGE))


def rows_walk_launch(B: int, w_band: int) -> tuple[int, int, int]:
    """(blocks, threads per block, shared bytes per block) of one rows walk
    launch: ROWS_WALK_WARPS items a block, each warp a ring of
    ROWS_WALK_SLOTS word-rows (W words each) and the bit planes of one
    word-row (W words)."""
    return (-(-B // ROWS_WALK_WARPS), 32 * ROWS_WALK_WARPS,
            ROWS_WALK_WARPS * (ROWS_WALK_SLOTS + 1) * w_band * 4)


def myers_sweep_launch(B: int, n_cap: int,
                       w_band: int) -> tuple[int, int, int]:
    """(blocks, threads per block, shared bytes per block) of one Myers
    sweep launch: one warp and one item a block, with the item's six Peq
    planes (myers_fits keeps them within 48 KB)."""
    return B, 32, NW_CODES * peq_words(n_cap, w_band) * 4


def moves_live_tiles(m: np.ndarray, m_cap: int, n_cap: int,
                     w_band: int) -> int:
    """Tiles (item, 16-row group, 32-lane word) of the Myers plane-to-move
    transform (J5, kernels/csrc/myers_moves.cu) that hold a valid cell: a
    row up to the item's m and a column inside 1 .. n_cap. Only these need
    their 32 plane words read and their codes worked out; the others are
    all ones whatever the planes hold. J5's bound counts these."""
    G, nw = m_cap // PACK, w_band // 32
    g = np.arange(G)
    # valid rows of each tile (0 .. 16); row r of a tile at lane t sits in
    # column J + r + t, J = 16 g + 1 + dlo + 32 w
    rows = np.clip(np.asarray(m, np.int64)[:, None] - PACK * g, 0, PACK)
    J = (PACK * g + 1 + band_dlo(m_cap, n_cap, w_band))[:, None] \
        + 32 * np.arange(nw)                                     # (G, nw)
    r = np.arange(PACK + 1)
    live = (r[None, :, None] > 0) & (J[:, None, :] <= n_cap) \
        & (J[:, None, :] + r[None, :, None] + 30 >= 1)          # (G, 17, nw)
    per = live.sum(axis=2)                                       # (G, 17)
    return int(per[g[None, :], rows].sum())


# The row gather's unit rule (J6, kernels/csrc/pack_gather.cu: kJ, kWarps,
# kSms, kFewUnits, gather_mode and rtt_pack_gather's rule). A warp is one
# unit: row segments of one item, each of at most 32 * GATHER_LANE_WORDS
# words (a quarter as many of the deletion-cost row, the same target
# elements).
GATHER_LANE_WORDS = 4     # words a lane loads of a segment, at most
GATHER_WARPS = 8          # warps (units) a block, at most
GATHER_SMS = 132          # SMs of the H100 the block rule counts
GATHER_FEW_UNITS = 4 * GATHER_SMS  # fewer units of whole rows: J = 1
# how a unit groups an item's segments k: "row" one segment; "pair" the
# query's apart from the target's with its deletion bits; "item" all three
GATHER_MODES = ("row", "pair", "item")


def _gather_whole(m_cap: int, n_cap: int) -> tuple[int, int]:
    """(lane words of a segment that holds a whole row: the fewest, at
    most GATHER_LANE_WORDS, for the longer row; the segments of that
    row at as many)."""
    longer = max(m_cap, n_cap) // 8
    J = min(GATHER_LANE_WORDS, -(-longer // 32))
    return J, -(-longer // (32 * J))


def gather_mode(m_cap: int, n_cap: int, B: int) -> str:
    """The grouping the row gather launches with (gather_mode in
    kernels/csrc/pack_gather.cu), picked by timing the three in turns
    (benchmarks/kernel_ab.py --only gather, PERF.md): an item's three rows
    a warp, or where that gives fewer than GATHER_FEW_UNITS units (a small
    B), the query's segments apart from the target's."""
    _, segs = _gather_whole(m_cap, n_cap)
    return "pair" if B * segs < GATHER_FEW_UNITS else "item"


def gather_units(m_cap: int, n_cap: int, B: int, mode: str | None = None,
                 lane_words: int | None = None
                 ) -> tuple[int, int, int, int, int]:
    """(S, segments of the query row, of the target row, units an item,
    warps a block) of one row-gather launch under `mode` (gather_mode's
    by default): segments of S = 32 J words, J the fewest lane words (at
    most GATHER_LANE_WORDS) that hold the longer row whole, or 1 where
    units of whole rows would give fewer than GATHER_FEW_UNITS warps (a
    small B: shorter warps, more of them); units an item by the
    grouping; GATHER_WARPS warps a block, halved while the units would
    fill fewer than GATHER_SMS blocks. `lane_words` fixes J (the variants
    benchmarks/kernel_ab.py times)."""
    mode = mode or gather_mode(m_cap, n_cap, B)
    wq, wt = m_cap // 8, n_cap // 8
    whole, segs = _gather_whole(m_cap, n_cap)
    J = lane_words or (1 if B * segs < GATHER_FEW_UNITS else whole)
    S = 32 * J
    sq, st = -(-wq // S), -(-wt // S)
    upi = {"row": sq + 2 * st, "pair": sq + st, "item": max(sq, st)}[mode]
    warps = GATHER_WARPS
    while warps > 1 and B * upi < warps * GATHER_SMS:
        warps //= 2
    return S, sq, st, upi, warps


def _rle_stage_bytes(items: int, max_events: int) -> int:
    # `items` payload rows of E + 1 bytes, zeroed in whole 16-byte words
    return (items * (max_events + 1) + 15) // 16 * 16


def rle_walk_items(max_events: int) -> int:
    """Items (threads) per block of the RLE walk: RLE_WALK_ITEMS, or half
    as many where their staging area would pass SMEM_BLOCK_MAX (E > 7263:
    the (40960,1024) tier's 10752); 0 where even that does not fit."""
    for items in (RLE_WALK_ITEMS, RLE_WALK_ITEMS // 2):
        if _rle_stage_bytes(items, max_events) <= SMEM_BLOCK_MAX:
            return items
    return 0


def rle_walk_launch(B: int, max_events: int) -> tuple[int, int, int]:
    """(blocks, threads per block, shared bytes per block) of one RLE walk
    launch: one warp a block, rle_walk_items items each, and their payload
    rows staged in shared memory."""
    items = rle_walk_items(max_events)
    return (-(-B // items), 32, _rle_stage_bytes(items, max_events))


def sweep_fits(m_cap: int, n_cap: int, w_band: int) -> bool:
    """Shapes the scored sweep takes (the checks of rtt_nw_sweep's
    bindings): W a multiple of 32 up to 1024, of 64 up to 2048 or of 128
    up to 4096 (the reference's lane-major kernel, nw_kernel.py:186), and
    the t8 regime dlo <= 0. Wider bands are refused."""
    step = 32 if w_band <= 1024 else (64 if w_band <= 2048 else 128)
    return (w_band % step == 0 and w_band <= 4096
            and m_cap % 16 == 0 and n_cap % 32 == 0
            and band_dlo(m_cap, n_cap, w_band) <= 0)


def sweep_t_fits(m_cap: int, n_cap: int, w_band: int) -> bool:
    """Shapes the int32 panel sweep (K7, nw_band_batch_t) takes: m_cap a
    multiple of GROUP (the TPU kernel's grid), W a multiple of 32 up to
    1024, and n_cap >= m_cap - W/2, i.e. dlo >= -W: below that the first
    row's window leaves the padded panels, where the TPU kernel has no
    defined answer. Unlike sweep_fits, a band right of the diagonal
    (dlo > 0) is taken."""
    return (m_cap % GROUP == 0 and w_band % 32 == 0 and 0 < w_band <= 1024
            and band_dlo(m_cap, n_cap, w_band) >= -w_band)


def myers_fits(m_cap: int, n_cap: int, w_band: int) -> bool:
    """Shapes the Myers kernels take: equal caps (the align-stage
    contract), W a multiple of 32 up to 4096, m_cap a multiple of 32, and
    one item's Peq mask (6 planes) within 48 KB of shared memory. The
    reference's VMEM model (myers_kernel.py:404-432) has no counterpart
    here."""
    return (m_cap == n_cap and w_band % 32 == 0 and w_band <= 4096
            and m_cap % 32 == 0 and band_dlo(m_cap, n_cap, w_band) <= 0
            and 6 * 4 * peq_words(n_cap, w_band) <= 48 * 1024)

// The panel sweep (K7) and its ablation variants (K8) with each row's
// window loaded as whole aligned vectors and completed from the next
// thread by shuffles: the counterpart of kernels/csrc/nw_sweep_t.cu that
// benchmarks/kernel_ab.py times against it (give it this directory as
// OTHER_CSRC with --only sweep_t; the other sources come from the
// checkout). Same C signature, moves and scores, byte for byte. On an
// H100 at 700 W, in turns at (640,128) B = 8192 against the single-word
// loads: full 2.130 against 2.069 ms, noclosure 1.181 against 1.020,
// nomoves 1.606 against 1.229, noload 1.245 against 1.185, empty 0.081
// against 0.105.
//
// Scored banded NW sweep over precomputed int32 panels, and its ablation
// variants.
//
// Replaces the TPU kernels racon_tpu/ops/nw_kernel.py::nw_band_batch_t
// (body _nw_band_kernel_t, "K7": the int32 transposed predecessor of K1)
// and benchmarks/profile_ablate.py::run_variant (body make_kernel, "K8":
// K7's body with pieces switched off, to find where a sweep's time goes).
//
// Inputs, item-major (K7's panels transposed): q (B, m_cap) codes,
// tp (B, n_cap + 2W) target codes with W PAD columns on both sides, and
// gcp (B, n_cap + 1 + 2W) the cumulative deletion costs gc[j] with W zero
// columns before and W copies of gc[n_cap] after. Outputs: moves
// (B, m_cap/16, W) int32 (2-bit DIAG(0) > UP(1) > LEFT(2), 3 = outside, 16
// rows per word, exactly K1's words) and score (B,) int32. The DP is
// nw_sweep.cu's; the differences are K7's: per row, lane k reads
// tp[off + k] and gcp[off + 1 + k] from global memory at
// off = i - 1 + W + dlo, where K1 stages the packed codes in shared memory
// and integrates gc. Unlike K1 it takes a band right of the diagonal
// (dlo > 0). The panels are not staged on purpose: the noload variant
// measures the per-row loads only if there are any.
//
// Variants (template flags): full <1,1,1,0> is K7; noclosure <0,1,1,0>
// takes h = cand (no max-plus scan, wrong results); nomoves <1,0,1,0>
// stores no moves (score only; the moves output stays unwritten); noload
// <1,1,0,0> reads every row's window at the static offset W + dlo and
// query row 0; empty <*,*,*,1> is the bare launch and loop:
// moves[b][8g+p][k] = gcp[b][k] + p for every 128-row group g, and score =
// gcp[b][0] + 8 (lane 0 after one group's 8 steps, as the TPU variant).
//
// Design on the H100, W <= 256 (K1's tiers and the harness's (640,128)):
// nw_sweep.cu's warp kernel on the panels. One warp per item,
// kSweepTWarps items per block, LPT band lanes per thread (LPT = 1, 2, 4
// or 8, the smallest with 32 LPT >= W; lanes from W up to 32 LPT are pad
// lanes, outside the matrix in every row, that read the panels at lane
// W - 1 and store nothing), everything of a row in registers and
// shuffles: no __syncthreads and no shared memory in the row loop. The up
// neighbour of a thread's last lane is a __shfl_down of the next thread's
// first lane; the scan is warp_lanes_incl_max (a serial max over the
// thread's lanes, five shuffles, one more for the exclusive prefix). Each
// row a thread reads its LPT contiguous words of tp and of gcp, one row
// ahead of the row it computes, so the loads overlap a row's work. The
// window slides a word a row, so it is 16-byte aligned one row in four;
// the thread loads the aligned 16-byte (8-byte at LPT = 2) vectors that
// start up to three words before its window, and the words past them
// come from the next thread's first vector by shuffles (one to three,
// one branch for the warp): whole vectors in every row (with pad lanes,
// W not a power of two, single words). Single-word loads in three rows of
// four, a warp's word spread over four cache lines, took 40 % of the
// time (the noload variant, H100). Moves: every 16 rows a thread stores
// its LPT words (16-byte stores at LPT = 4 and 8). What bounds it: as
// K1, instruction issue (~15 integer ops a cell and ~8 shuffles a row per
// warp), plus the two panel windows a row K1 does not load.
//
// W = 288 .. 1024: the block design this file had before (one block per
// item, one thread per band lane, the scan of sweep_scan.cuh, the up move
// through a double-buffered row in shared memory, two block barriers per
// row); no stage launches the panel sweep, and the harness runs W = 128.
#include <type_traits>

#include "sweep_scan.cuh"

namespace {

using namespace rtt;

constexpr int kSweepTWarps = 4;  // items (warps) per block of the warp
                                 // kernel

// The thread's LPT words row[off + k0 + u] of a panel row into v (k0 =
// LPT * lane). Where the band has no pad lane (`exact`: W = 32 LPT) each
// thread loads the aligned vectors that start r = (row + off) mod kVec
// words before its window (16-byte loads, 8-byte at LPT = 2; r is the
// same for the whole warp, which takes one branch) and the r words past
// them from the next thread's first vector by shuffles, lane 31 loading
// them itself: every row, whatever its window's alignment, the warp
// reads whole aligned vectors, each word of the window once. With pad
// lanes each thread reads its words one at a time, a pad lane lane W - 1's.
template <int LPT>
__device__ __forceinline__ void load_lanes(const int32_t* __restrict__ row,
                                           int off, int lane, int W,
                                           bool exact, int (&v)[LPT]) {
  constexpr int kVec = LPT >= 4 ? 4 : LPT;
  const int k0 = LPT * lane;
  if (kVec == 1 || !exact) {
#pragma unroll
    for (int u = 0; u < LPT; ++u)
      v[u] = __ldg(row + off + min(k0 + u, W - 1));
    return;
  }
  const int32_t* w = row + off;
  const int r =
      static_cast<int>(reinterpret_cast<uintptr_t>(w) >> 2) & (kVec - 1);
  const int32_t* p = w - r + k0;  // aligned to kVec words
  int buf[LPT + kVec];
  auto load_vec = [&](const int32_t* src, int* dst) {
    if constexpr (kVec == 4) {
      const int4 x = __ldg(reinterpret_cast<const int4*>(src));
      dst[0] = x.x;
      dst[1] = x.y;
      dst[2] = x.z;
      dst[3] = x.w;
    } else {
      const int2 x = __ldg(reinterpret_cast<const int2*>(src));
      dst[0] = x.x;
      dst[1] = x.y;
    }
  };
#pragma unroll
  for (int u = 0; u < LPT; u += kVec) load_vec(p + u, buf + u);
  // the window's words from r on: the first R past the thread's vectors
  // are the next thread's first R words
  auto take = [&](auto r_t) {
    constexpr int R = decltype(r_t)::value;
    if constexpr (R > 0) {
      int nx[kVec];
#pragma unroll
      for (int x = 0; x < R; ++x) nx[x] = __shfl_down_sync(kFull, buf[x], 1);
      if (lane == 31) load_vec(p + LPT, nx);
#pragma unroll
      for (int x = 0; x < R; ++x) buf[LPT + x] = nx[x];
    }
#pragma unroll
    for (int u = 0; u < LPT; ++u) v[u] = buf[R + u];
  };
  if (r == 0) {
    take(std::integral_constant<int, 0>{});
  } else if (kVec == 2 || r == 1) {
    take(std::integral_constant<int, 1>{});
  } else if constexpr (kVec == 4) {
    if (r == 2)
      take(std::integral_constant<int, 2>{});
    else
      take(std::integral_constant<int, 3>{});
  }
}

// The thread's LPT move words at dst (lane k0's word first): 16-byte
// stores where LPT % 4 == 0 and the thread has no pad lane, else the
// words of its lanes below W one at a time.
template <int LPT>
__device__ __forceinline__ void store_lanes(int32_t* dst,
                                            const uint32_t (&w)[LPT],
                                            int k0, int W, bool whole) {
  if constexpr (LPT % 4 == 0) {
    if (whole) {
#pragma unroll
      for (int v = 0; v < LPT; v += 4)
        *reinterpret_cast<int4*>(dst + v) =
            make_int4(w[v], w[v + 1], w[v + 2], w[v + 3]);
      return;
    }
  }
#pragma unroll
  for (int u = 0; u < LPT; ++u)
    if (whole || k0 + u < W) dst[u] = static_cast<int32_t>(w[u]);
}

// W <= 32 * LPT <= 256: one warp per item (see the note at the top).
// Thread `lane` owns band lanes LPT*lane .. LPT*lane + LPT - 1. The
// minimum of one block a SM frees ptxas from its occupancy target, as in
// nw_sweep.cu's warp kernel.
template <int LPT, bool kClosure, bool kMoves, bool kDynLoad, bool kEmpty>
__global__ void __launch_bounds__(32 * kSweepTWarps, 1)
nw_sweep_t_warp_kernel(const int32_t* __restrict__ q,
                       const int32_t* __restrict__ tp,
                       const int32_t* __restrict__ gcp,
                       int32_t* __restrict__ moves,
                       int32_t* __restrict__ score, int B, int m_cap,
                       int n_cap, int W, int match, int mismatch, int gap,
                       int span) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * kSweepTWarps + warp;
  if (b >= B) return;  // the whole warp: nothing below syncs the block
  const int k0 = LPT * lane;
  const bool whole = k0 + LPT <= W;  // no pad lane in this thread
  const bool exact = W == 32 * LPT;  // no pad lane in the warp
  const int dlo = n_cap - m_cap - W / 2;
  const int32_t* qrow = q + static_cast<size_t>(b) * m_cap;
  const int32_t* trow = tp + static_cast<size_t>(b) * (n_cap + 2 * W);
  const int32_t* grow = gcp + static_cast<size_t>(b) * (n_cap + 1 + 2 * W);
  int32_t* mrow = moves + static_cast<size_t>(b) * (m_cap / 16) * W + k0;
  // a band lane's last column inside the matrix: n_cap, or -1 for a pad
  // lane, which is then outside in every row
  auto jmax = [&](int u) { return (whole || k0 + u < W) ? n_cap : -1; };

  if (kEmpty) {
    int g0[LPT];
    load_lanes<LPT>(grow, 0, lane, W, exact, g0);
    for (int s = 0; s < m_cap / 16; ++s) {
      uint32_t w[LPT];
#pragma unroll
      for (int u = 0; u < LPT; ++u) w[u] = g0[u] + (s & 7);
      store_lanes<LPT>(mrow + s * W, w, k0, W, whole);
    }
    if (lane == 0) score[b] = g0[0] + 8;
    return;
  }

  // row 0: H[0][j] = gc[j] inside the matrix, NEG outside
  int hp[LPT], tc[LPT], gc[LPT];
  uint32_t pack[LPT];
  load_lanes<LPT>(grow, W + dlo, lane, W, exact, hp);
#pragma unroll
  for (int u = 0; u < LPT; ++u) {
    const int j0 = dlo + k0 + u;
    if (j0 < 0 || j0 > jmax(u)) hp[u] = kNeg;
    pack[u] = 0;
  }
  // row 1's panel words; at the static offset (noload) the only ones
  load_lanes<LPT>(trow, W + dlo, lane, W, exact, tc);
  if (kClosure) load_lanes<LPT>(grow, W + dlo + 1, lane, W, exact, gc);
  int qc = qrow[0];

  for (int i = 1; i <= m_cap; ++i) {
    // the next row's words, a row ahead (row m_cap + 1's window still
    // lies inside the panels; its query code is row m_cap's, unused)
    int tn[LPT], gn[LPT], qn = 0;
    if (kDynLoad) {
      const int offn = i + W + dlo;
      load_lanes<LPT>(trow, offn, lane, W, exact, tn);
      if (kClosure) load_lanes<LPT>(grow, offn + 1, lane, W, exact, gn);
      qn = qrow[min(i, m_cap - 1)];
    }
    // lane k + 1 of the previous row for the thread's last lane
    const int above_last = __shfl_down_sync(kFull, hp[0], 1);
    const int jb = i + dlo + k0;  // column of the thread's first lane
    int diag_c[LPT], up_c[LPT], a[LPT];
#pragma unroll
    for (int u = 0; u < LPT; ++u) {
      const int j = jb + u;
      const int sub = ((tc[u] == kPad) != (qc == kPad))
                          ? kNeg : (tc[u] == qc ? match : mismatch);
      diag_c[u] = hp[u] + sub;
      const int above = (u + 1 < LPT) ? hp[(u + 1) % LPT]
                        : (lane == 31 ? kNeg : above_last);
      up_c[u] = above + gap;
      int cand = max(diag_c[u], up_c[u]);
      if (j == 0) cand = i * gap;
      if (j < 0 || j > jmax(u)) cand = kNeg;
      a[u] = kClosure ? cand - gc[u] : cand;
    }
    if (kClosure) {
      warp_lanes_incl_max<LPT>(a, lane);
#pragma unroll
      for (int u = 0; u < LPT; ++u)
        if (k0 + u <= span - 2) a[u] = max(a[u], kScanFill);
    }

    const int p = (i - 1) & 15;
#pragma unroll
    for (int u = 0; u < LPT; ++u) {
      const int j = jb + u;
      int h = kClosure ? a[u] + gc[u] : a[u];
      if (j < 0 || j > jmax(u)) h = kNeg;
      if (kMoves) {
        int mv = (h == diag_c[u]) ? 0 : ((h == up_c[u]) ? 1 : 2);
        if (j < 1 || j > jmax(u)) mv = 3;
        pack[u] |= static_cast<uint32_t>(mv) << (2 * p);
      }
      hp[u] = h;
    }
    if (kMoves && p == 15) {
      store_lanes<LPT>(mrow + ((i - 1) >> 4) * W, pack, k0, W, whole);
#pragma unroll
      for (int u = 0; u < LPT; ++u) pack[u] = 0;
    }
    if (kDynLoad) {
#pragma unroll
      for (int u = 0; u < LPT; ++u) {
        tc[u] = tn[u];
        if (kClosure) gc[u] = gn[u];
      }
      qc = qn;
    }
  }
  const int k_end = n_cap - m_cap - dlo;
#pragma unroll
  for (int u = 0; u < LPT; ++u)
    if (k0 + u == k_end) score[b] = hp[u];
}

// W = 288 .. 1024: the block design (see the note at the top).
template <bool kClosure, bool kMoves, bool kDynLoad, bool kEmpty>
__global__ void __launch_bounds__(1024)
nw_sweep_t_block_kernel(const int32_t* __restrict__ q,
                        const int32_t* __restrict__ tp,
                        const int32_t* __restrict__ gcp,
                        int32_t* __restrict__ moves,
                        int32_t* __restrict__ score, int m_cap, int n_cap,
                        int W, int match, int mismatch, int gap, int span) {
  extern __shared__ int32_t smem[];
  int32_t* hbuf = smem;        // [2][W]: the previous row's H
  int32_t* wtot = smem + 2 * W;  // [32]: the scan's warp totals

  const int b = blockIdx.x;
  const int k = threadIdx.x;
  const int lane = k & 31;
  const int warp = k >> 5;
  const int dlo = n_cap - m_cap - W / 2;
  const int32_t* qrow = q + static_cast<size_t>(b) * m_cap;
  const int32_t* trow = tp + static_cast<size_t>(b) * (n_cap + 2 * W);
  const int32_t* grow = gcp + static_cast<size_t>(b) * (n_cap + 1 + 2 * W);
  int32_t* mrow = moves + static_cast<size_t>(b) * (m_cap / 16) * W;

  if (kEmpty) {
    const int g0 = grow[k];
    for (int s = 0; s < m_cap / 16; ++s) mrow[s * W + k] = g0 + (s & 7);
    if (k == 0) score[b] = g0 + 8;
    return;
  }

  // row 0: H[0][j] = gc[j] inside the matrix, NEG outside
  const int j0 = dlo + k;
  int hp = (j0 >= 0 && j0 <= n_cap) ? grow[W + dlo + k] : kNeg;
  const bool fill_lane = k <= span - 2;
  uint32_t pack = 0;
  hbuf[k] = hp;
  __syncthreads();

  for (int i = 1; i <= m_cap; ++i) {
    const int cur = (i - 1) & 1;
    const int off = kDynLoad ? i - 1 + W + dlo : W + dlo;
    const int tc = trow[off + k];
    const int qc = qrow[kDynLoad ? i - 1 : 0];
    const int j = i + dlo + k;
    const bool valid = j >= 1 && j <= n_cap;
    const bool inside = valid || j == 0;
    const int sub = ((tc == kPad) != (qc == kPad))
                        ? kNeg : (tc == qc ? match : mismatch);
    const int diag_c = hp + sub;
    const int up_c = (k == W - 1 ? kNeg : hbuf[cur * W + k + 1]) + gap;
    int cand = max(diag_c, up_c);
    if (j == 0) cand = i * gap;
    if (!inside) cand = kNeg;
    int h = cand;
    if (kClosure) {
      const int gc = grow[off + 1 + k];
      int a[1] = {cand - gc};
      block_incl_max<1>(a, lane, warp, wtot);
      if (fill_lane) a[0] = max(a[0], kScanFill);
      h = a[0] + gc;
    }
    if (!inside) h = kNeg;
    if (kMoves) {
      const int p = (i - 1) & 15;
      int mv = (h == diag_c) ? 0 : ((h == up_c) ? 1 : 2);
      if (!valid) mv = 3;
      pack |= static_cast<uint32_t>(mv) << (2 * p);
      if (p == 15) {
        mrow[((i - 1) >> 4) * W + k] = static_cast<int32_t>(pack);
        pack = 0;
      }
    }
    hp = h;
    hbuf[(cur ^ 1) * W + k] = h;
    __syncthreads();
  }
  if (k == n_cap - m_cap - dlo) score[b] = hp;
}

template <bool kClosure, bool kMoves, bool kDynLoad, bool kEmpty>
int launch_sweep_t(const int32_t* q, const int32_t* tp, const int32_t* gcp,
                   int32_t* moves, int32_t* score, int B, int m_cap,
                   int n_cap, int W, int match, int mismatch, int gap,
                   int span, cudaStream_t stream) {
  const int blocks = (B + kSweepTWarps - 1) / kSweepTWarps;
#define RTT_SWEEP_T_WARP(L)                                                 \
  nw_sweep_t_warp_kernel<L, kClosure, kMoves, kDynLoad, kEmpty>             \
      <<<blocks, 32 * kSweepTWarps, 0, stream>>>(q, tp, gcp, moves, score,  \
                                                 B, m_cap, n_cap, W, match, \
                                                 mismatch, gap, span);      \
  return RTT_LAUNCH_STATUS();
  if (W <= 32) {
    RTT_SWEEP_T_WARP(1)
  } else if (W <= 64) {
    RTT_SWEEP_T_WARP(2)
  } else if (W <= 128) {
    RTT_SWEEP_T_WARP(4)
  } else if (W <= 256) {
    RTT_SWEEP_T_WARP(8)
  }
#undef RTT_SWEEP_T_WARP
  const size_t smem = static_cast<size_t>(2 * W + 32) * 4;
  nw_sweep_t_block_kernel<kClosure, kMoves, kDynLoad, kEmpty>
      <<<B, W, smem, stream>>>(q, tp, gcp, moves, score, m_cap, n_cap, W,
                               match, mismatch, gap, span);
  return RTT_LAUNCH_STATUS();
}

}  // namespace

// q (B, m_cap) i32, tp (B, n_cap + 2W) i32, gcp (B, n_cap + 1 + 2W) i32 ->
// moves (B, m_cap/16, W) i32, score (B,) i32. variant: 0 full (K7),
// 1 noclosure, 2 nomoves, 3 noload, 4 empty. Requires W a multiple of 32
// up to 1024, m_cap % 16 == 0 and dlo >= -W (the first row's window inside
// the padded panels). W <= 256 runs the warp kernel, wider bands the block
// kernel.
extern "C" int rtt_nw_sweep_t(const int32_t* q, const int32_t* tp,
                              const int32_t* gcp, int32_t* moves,
                              int32_t* score, int B, int m_cap, int n_cap,
                              int W, int match, int mismatch, int gap,
                              int span, int variant, cudaStream_t stream) {
  if (B == 0) return 0;
  switch (variant) {
    case 0:
      return launch_sweep_t<true, true, true, false>(
          q, tp, gcp, moves, score, B, m_cap, n_cap, W, match, mismatch, gap,
          span, stream);
    case 1:
      return launch_sweep_t<false, true, true, false>(
          q, tp, gcp, moves, score, B, m_cap, n_cap, W, match, mismatch, gap,
          span, stream);
    case 2:
      return launch_sweep_t<true, false, true, false>(
          q, tp, gcp, moves, score, B, m_cap, n_cap, W, match, mismatch, gap,
          span, stream);
    case 3:
      return launch_sweep_t<true, true, false, false>(
          q, tp, gcp, moves, score, B, m_cap, n_cap, W, match, mismatch, gap,
          span, stream);
    case 4:
      return launch_sweep_t<true, true, true, true>(
          q, tp, gcp, moves, score, B, m_cap, n_cap, W, match, mismatch, gap,
          span, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

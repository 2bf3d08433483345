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
// off = i - 1 + W + dlo (coalesced: neighbouring lanes, neighbouring
// words), where K1 stages the packed codes in shared memory and
// integrates gc. Unlike K1 it takes a band right of the diagonal
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
// Design on the H100: one block per item, one thread per band lane
// (W <= 1024), the scan of sweep_scan.cuh (K1's), the up move through a
// double-buffered row in shared memory, two block barriers per row. What
// bounds it: as K1, the barriers and the shuffle chain per row (latency;
// the noclosure variant, which drops the scan and one barrier, takes well
// under half the time); by the card's model, the operations (15 per cell)
// over the bytes (the 168 MB of moves at (8192, 640, 128)).
#include "sweep_scan.cuh"

namespace {

using namespace rtt;

template <bool kClosure, bool kMoves, bool kDynLoad, bool kEmpty>
__global__ void __launch_bounds__(1024)
nw_sweep_t_kernel(const int32_t* __restrict__ q,
                  const int32_t* __restrict__ tp,
                  const int32_t* __restrict__ gcp,
                  int32_t* __restrict__ moves,
                  int32_t* __restrict__ score, int m_cap, int n_cap, int W,
                  int match, int mismatch, int gap, int span) {
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
  const size_t smem = static_cast<size_t>(2 * W + 32) * 4;
  nw_sweep_t_kernel<kClosure, kMoves, kDynLoad, kEmpty>
      <<<B, W, smem, stream>>>(q, tp, gcp, moves, score, m_cap, n_cap, W,
                               match, mismatch, gap, span);
  return RTT_LAUNCH_STATUS();
}

}  // namespace

// q (B, m_cap) i32, tp (B, n_cap + 2W) i32, gcp (B, n_cap + 1 + 2W) i32 ->
// moves (B, m_cap/16, W) i32, score (B,) i32. variant: 0 full (K7),
// 1 noclosure, 2 nomoves, 3 noload, 4 empty. Requires W a multiple of 32
// up to 1024, m_cap % 16 == 0 and dlo >= -W (the first row's window inside
// the padded panels).
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

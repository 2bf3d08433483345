// Scored banded linear-gap Needleman-Wunsch sweep.
//
// Replaces the TPU kernels racon_tpu/ops/nw_kernel.py::nw_band_batch_t8
// (body _nw_band_kernel_t8), ::nw_band_batch_t8big (body
// _nw_band_kernel_t8big) and ::nw_band_batch (body _nw_band_kernel, the
// lane-major form the reference runs at W = 2048 and 4096), which compute
// the same DP and differ only in how they fit TPU VMEM; one kernel,
// templated on the band lanes per thread, covers every consensus tier and
// every align tier of the scored route (W <= 4096).
//
// Geometry: band lane k of query row i is target column j = i + dlo + k,
// dlo = n_cap - m_cap - W/2. Per row: substitution (PAD against a real base
// = NEG), diag and up candidates, j == 0 -> i*gap, then deletion chains
// closed by an inclusive max-plus prefix scan of cand - gc over the band,
// gc the prefix sums of the per-column deletion costs. Moves are 2 bits,
// DIAG(0) > UP(1) > LEFT(2), 3 = outside the matrix, 16 rows per int32 word
// exactly like K1's words; the layout is (B, m_cap/16, W) so that one item's
// words are contiguous. The score is H at lane n_cap - m_cap - dlo.
//
// Design on the H100: one block per item, one thread per band lane up to
// W = 1024, two (lanes 2t, 2t+1) at W = 2048 and four (4t..4t+3) at
// W = 4096, so a block never exceeds 1024 threads. The item's codes and
// deletion bitmask sit in shared memory; gc is integrated per lane from
// the bitmask (popcount once, then one add per row, as K1's gc register
// does). The scan is a serial max over the
// thread's lanes, a warp shuffle scan plus one pass over the warp totals.
// Only each thread's first lane goes through shared memory (the up move of
// the thread below reads it). What bounds it: two block barriers and the
// ~log2(32) shuffle latency chain per row (latency, not bandwidth: 2 bits
// of output per cell), so enough items must be resident to fill the SMs;
// a 1024-thread block holds at most 64 registers per thread (ptxas gives
// 32, 46 and 46 at one, two and four lanes, no spills). At (40960, 4096)
// the codes and bitmask take ~93 KB of shared memory, past the 48 KB
// default, so the launcher raises the limit.
#include "sweep_scan.cuh"

namespace {

using namespace rtt;

// gc[j] = gap * (set bits among deletion-cost columns 0..j-1); 0 for j <= 0
__device__ int gc_at(const uint32_t* bits, int j, int n_cap, int gap) {
  if (j <= 0) return 0;
  if (j > n_cap) j = n_cap;
  int c = 0;
  for (int x = 0; x < (j >> 5); ++x) c += __popc(bits[x]);
  if (j & 31) c += __popc(bits[j >> 5] & ((1u << (j & 31)) - 1u));
  return c * gap;
}

// LPT band lanes per thread: 1 for W <= 1024 (thread k owns lane k), 2 for
// W = 2048 (thread t owns lanes 2t and 2t+1), 4 for W = 4096. Within a
// thread the lanes' values live in registers; the scan runs a serial max
// over the thread's lanes, then the warp scan over thread totals, then the
// warp totals.
template <int LPT>
__global__ void __launch_bounds__(1024)
nw_sweep_kernel(const uint8_t* __restrict__ q4,
                const uint8_t* __restrict__ t4,
                const uint8_t* __restrict__ dcb,
                int32_t* __restrict__ moves,
                int32_t* __restrict__ score, int m_cap, int n_cap, int W,
                int match, int mismatch, int gap, int span) {
  extern __shared__ int32_t smem[];
  const int T = W / LPT;                               // threads
  int32_t* hbuf = smem;                                // [2][T] lane LPT*t
  int32_t* wtot = hbuf + 2 * T;                        // [32]
  uint32_t* bits = reinterpret_cast<uint32_t*>(wtot + 32);  // [n_cap/32]
  uint8_t* qs = reinterpret_cast<uint8_t*>(bits + n_cap / 32);  // [m_cap]
  uint8_t* ts = qs + m_cap;                            // [n_cap]

  const int b = blockIdx.x;
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const int k0 = LPT * t;
  const int dlo = n_cap - m_cap - W / 2;

  const uint8_t* qrow = q4 + static_cast<size_t>(b) * (m_cap / 2);
  const uint8_t* trow = t4 + static_cast<size_t>(b) * (n_cap / 2);
  const uint8_t* drow = dcb + static_cast<size_t>(b) * (n_cap / 8);
  for (int x = t; x < m_cap / 2; x += T) {
    uint8_t v = qrow[x];
    qs[2 * x] = v & 15;
    qs[2 * x + 1] = v >> 4;
  }
  for (int x = t; x < n_cap / 2; x += T) {
    uint8_t v = trow[x];
    ts[2 * x] = v & 15;
    ts[2 * x + 1] = v >> 4;
  }
  for (int x = t; x < n_cap / 32; x += T) {
    const uint8_t* d = drow + 4 * x;
    bits[x] = static_cast<uint32_t>(d[0]) | (static_cast<uint32_t>(d[1]) << 8)
              | (static_cast<uint32_t>(d[2]) << 16)
              | (static_cast<uint32_t>(d[3]) << 24);
  }
  __syncthreads();

  // row 0: H[0][j] = gc[j] inside the matrix, NEG outside
  int hp[LPT], gcj[LPT];
  uint32_t pack[LPT];
  bool fill_lane[LPT];
#pragma unroll
  for (int u = 0; u < LPT; ++u) {
    const int jz = dlo + k0 + u;
    gcj[u] = gc_at(bits, jz, n_cap, gap);
    hp[u] = (jz >= 0 && jz <= n_cap) ? gcj[u] : kNeg;
    pack[u] = 0;
    fill_lane[u] = k0 + u <= span - 2;
  }
  hbuf[t] = hp[0];
  int32_t* mrow = moves + static_cast<size_t>(b) * (m_cap / 16) * W;
  __syncthreads();

  for (int i = 1; i <= m_cap; ++i) {
    const int cur = (i - 1) & 1;
    const int qc = qs[i - 1];
    int diag_c[LPT], up_c[LPT], a[LPT];
    bool valid[LPT], inside[LPT];
#pragma unroll
    for (int u = 0; u < LPT; ++u) {
      const int j = i + dlo + k0 + u;
      const int jm1 = j - 1;
      const bool in_t = jm1 >= 0 && jm1 < n_cap;
      if (in_t && ((bits[jm1 >> 5] >> (jm1 & 31)) & 1u)) gcj[u] += gap;
      valid[u] = j >= 1 && j <= n_cap;
      const bool jzero = j == 0;
      inside[u] = valid[u] || jzero;
      const int tc = in_t ? ts[jm1] : kPad;
      const int sub = ((tc == kPad) != (qc == kPad))
                          ? kNeg : (tc == qc ? match : mismatch);
      diag_c[u] = hp[u] + sub;
      // lane k + 1 of the previous row: this thread's next lane, or the
      // next thread's first lane from shared memory
      const int above = (u + 1 < LPT) ? hp[(u + 1) % LPT]
                        : ((k0 + LPT == W) ? kNeg : hbuf[cur * T + t + 1]);
      up_c[u] = above + gap;
      int cand = max(diag_c[u], up_c[u]);
      if (jzero) cand = i * gap;
      if (!inside[u]) cand = kNeg;
      a[u] = cand - gcj[u];
    }
    block_incl_max<LPT>(a, lane, warp, wtot);

    const int p = (i - 1) & 15;
#pragma unroll
    for (int u = 0; u < LPT; ++u) {
      if (fill_lane[u]) a[u] = max(a[u], kScanFill);
      int h = a[u] + gcj[u];
      if (!inside[u]) h = kNeg;
      int mv = (h == diag_c[u]) ? 0 : ((h == up_c[u]) ? 1 : 2);
      if (!valid[u]) mv = 3;
      pack[u] |= static_cast<uint32_t>(mv) << (2 * p);
      hp[u] = h;
    }
    if (p == 15) {
#pragma unroll
      for (int u = 0; u < LPT; ++u) {
        mrow[((i - 1) >> 4) * W + k0 + u] = static_cast<int32_t>(pack[u]);
        pack[u] = 0;
      }
    }
    hbuf[(cur ^ 1) * T + t] = hp[0];
    __syncthreads();
  }
#pragma unroll
  for (int u = 0; u < LPT; ++u)
    if (k0 + u == n_cap - m_cap - dlo) score[b] = hp[u];
}

}  // namespace

// band lanes per thread at band width W
static int lanes_per_thread(int W) {
  return W <= 1024 ? 1 : (W <= 2048 ? 2 : 4);
}

extern "C" size_t rtt_nw_sweep_smem(int m_cap, int n_cap, int W) {
  const int T = W / lanes_per_thread(W);
  return static_cast<size_t>(2 * T + 32 + n_cap / 32) * 4 + m_cap + n_cap;
}

template <int LPT>
static int launch_sweep(const uint8_t* q4, const uint8_t* t4,
                        const uint8_t* dcb, int32_t* moves, int32_t* score,
                        int B, int m_cap, int n_cap, int W, int match,
                        int mismatch, int gap, int span,
                        cudaStream_t stream) {
  const size_t smem = rtt_nw_sweep_smem(m_cap, n_cap, W);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        nw_sweep_kernel<LPT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  nw_sweep_kernel<LPT><<<B, W / LPT, smem, stream>>>(
      q4, t4, dcb, moves, score, m_cap, n_cap, W, match, mismatch, gap, span);
  return RTT_LAUNCH_STATUS();
}

// q4 (B, m_cap/2) u8, t4 (B, n_cap/2) u8, dcb (B, n_cap/8) u8 ->
// moves (B, m_cap/16, W) i32, score (B,) i32. Requires W a multiple of
// 32 * lanes_per_thread(W) and W <= 4096; m_cap % 16 == 0,
// n_cap % 32 == 0, dlo <= 0.
extern "C" int rtt_nw_sweep(const uint8_t* q4, const uint8_t* t4,
                            const uint8_t* dcb, int32_t* moves,
                            int32_t* score, int B, int m_cap, int n_cap,
                            int W, int match, int mismatch, int gap,
                            int span, cudaStream_t stream) {
  if (B == 0) return 0;
  switch (lanes_per_thread(W)) {
    case 1:
      return launch_sweep<1>(q4, t4, dcb, moves, score, B, m_cap, n_cap, W,
                             match, mismatch, gap, span, stream);
    case 2:
      return launch_sweep<2>(q4, t4, dcb, moves, score, B, m_cap, n_cap, W,
                             match, mismatch, gap, span, stream);
    default:
      return launch_sweep<4>(q4, t4, dcb, moves, score, B, m_cap, n_cap, W,
                             match, mismatch, gap, span, stream);
  }
}

extern "C" const char* rtt_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

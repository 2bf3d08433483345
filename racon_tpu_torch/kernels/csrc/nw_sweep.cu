// Scored banded linear-gap Needleman-Wunsch sweep.
//
// Replaces the TPU kernels racon_tpu/ops/nw_kernel.py::nw_band_batch_t8
// (body _nw_band_kernel_t8) and ::nw_band_batch_t8big (body
// _nw_band_kernel_t8big), which compute the same DP and differ only in how
// they fit TPU VMEM; one kernel covers every consensus tier with W <= 1024.
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
// Design on the H100: one block per item, one thread per band lane. The
// item's codes and deletion bitmask sit in shared memory; gc is integrated
// per lane from the bitmask (popcount once, then one add per row, as K1's
// gc register does). The scan is a warp shuffle scan plus one pass over the
// warp totals. What bounds it: two block barriers and the ~log2(32)
// shuffle latency chain per row (latency, not bandwidth: 2 bits of output
// per cell), so enough items must be resident to fill the SMs.
#include "common.cuh"

namespace {

using namespace rtt;

__device__ __forceinline__ int warp_incl_max(int v, int lane) {
#pragma unroll
  for (int s = 1; s < 32; s <<= 1) {
    int o = __shfl_up_sync(kFull, v, s);
    if (lane >= s) v = max(v, o);
  }
  return v;
}

// gc[j] = gap * (set bits among deletion-cost columns 0..j-1); 0 for j <= 0
__device__ int gc_at(const uint32_t* bits, int j, int n_cap, int gap) {
  if (j <= 0) return 0;
  if (j > n_cap) j = n_cap;
  int c = 0;
  for (int x = 0; x < (j >> 5); ++x) c += __popc(bits[x]);
  if (j & 31) c += __popc(bits[j >> 5] & ((1u << (j & 31)) - 1u));
  return c * gap;
}

__global__ void nw_sweep_kernel(const uint8_t* __restrict__ q4,
                                const uint8_t* __restrict__ t4,
                                const uint8_t* __restrict__ dcb,
                                int32_t* __restrict__ moves,
                                int32_t* __restrict__ score, int m_cap,
                                int n_cap, int W, int match, int mismatch,
                                int gap, int span) {
  extern __shared__ int32_t smem[];
  int32_t* hbuf = smem;                                // [2][W]
  int32_t* wtot = hbuf + 2 * W;                        // [32]
  uint32_t* bits = reinterpret_cast<uint32_t*>(wtot + 32);  // [n_cap/32]
  uint8_t* qs = reinterpret_cast<uint8_t*>(bits + n_cap / 32);  // [m_cap]
  uint8_t* ts = qs + m_cap;                            // [n_cap]

  const int b = blockIdx.x;
  const int k = threadIdx.x;
  const int lane = k & 31;
  const int warp = k >> 5;
  const int dlo = n_cap - m_cap - W / 2;

  const uint8_t* qrow = q4 + static_cast<size_t>(b) * (m_cap / 2);
  const uint8_t* trow = t4 + static_cast<size_t>(b) * (n_cap / 2);
  const uint8_t* drow = dcb + static_cast<size_t>(b) * (n_cap / 8);
  for (int x = k; x < m_cap / 2; x += W) {
    uint8_t v = qrow[x];
    qs[2 * x] = v & 15;
    qs[2 * x + 1] = v >> 4;
  }
  for (int x = k; x < n_cap / 2; x += W) {
    uint8_t v = trow[x];
    ts[2 * x] = v & 15;
    ts[2 * x + 1] = v >> 4;
  }
  for (int x = k; x < n_cap / 32; x += W) {
    const uint8_t* d = drow + 4 * x;
    bits[x] = static_cast<uint32_t>(d[0]) | (static_cast<uint32_t>(d[1]) << 8)
              | (static_cast<uint32_t>(d[2]) << 16)
              | (static_cast<uint32_t>(d[3]) << 24);
  }
  __syncthreads();

  // row 0: H[0][j] = gc[j] inside the matrix, NEG outside
  const int jz = dlo + k;
  int gcj = gc_at(bits, jz, n_cap, gap);
  int hp = (jz >= 0 && jz <= n_cap) ? gcj : kNeg;
  hbuf[k] = hp;
  const bool fill_lane = k <= span - 2;
  int32_t* mrow = moves + static_cast<size_t>(b) * (m_cap / 16) * W;
  uint32_t pack = 0;
  __syncthreads();

  for (int i = 1; i <= m_cap; ++i) {
    const int cur = (i - 1) & 1;
    const int j = i + dlo + k;
    const int jm1 = j - 1;
    const bool in_t = jm1 >= 0 && jm1 < n_cap;
    if (in_t && ((bits[jm1 >> 5] >> (jm1 & 31)) & 1u)) gcj += gap;
    const bool valid = j >= 1 && j <= n_cap;
    const bool jzero = j == 0;
    const int tc = in_t ? ts[jm1] : kPad;
    const int qc = qs[i - 1];
    const int sub = ((tc == kPad) != (qc == kPad))
                        ? kNeg : (tc == qc ? match : mismatch);
    const int diag_c = hp + sub;
    const int up_c = ((k == W - 1) ? kNeg : hbuf[cur * W + k + 1]) + gap;
    int cand = max(diag_c, up_c);
    if (jzero) cand = i * gap;
    if (!(valid || jzero)) cand = kNeg;

    int a = warp_incl_max(cand - gcj, lane);
    if (lane == 31) wtot[warp] = a;
    __syncthreads();
    for (int w = 0; w < warp; ++w) a = max(a, wtot[w]);
    if (fill_lane) a = max(a, kScanFill);

    int h = a + gcj;
    if (!(valid || jzero)) h = kNeg;
    int mv = (h == diag_c) ? 0 : ((h == up_c) ? 1 : 2);
    if (!valid) mv = 3;
    const int u = (i - 1) & 15;
    pack |= static_cast<uint32_t>(mv) << (2 * u);
    if (u == 15) {
      mrow[((i - 1) >> 4) * W + k] = static_cast<int32_t>(pack);
      pack = 0;
    }
    hbuf[(cur ^ 1) * W + k] = h;
    hp = h;
    __syncthreads();
  }
  if (k == n_cap - m_cap - dlo) score[b] = hp;
}

}  // namespace

extern "C" size_t rtt_nw_sweep_smem(int m_cap, int n_cap, int W) {
  return static_cast<size_t>(2 * W + 32 + n_cap / 32) * 4 + m_cap + n_cap;
}

// q4 (B, m_cap/2) u8, t4 (B, n_cap/2) u8, dcb (B, n_cap/8) u8 ->
// moves (B, m_cap/16, W) i32, score (B,) i32. Requires W % 32 == 0,
// W <= 1024, m_cap % 16 == 0, n_cap % 32 == 0, dlo <= 0.
extern "C" int rtt_nw_sweep(const uint8_t* q4, const uint8_t* t4,
                            const uint8_t* dcb, int32_t* moves,
                            int32_t* score, int B, int m_cap, int n_cap,
                            int W, int match, int mismatch, int gap,
                            int span, cudaStream_t stream) {
  if (B == 0) return 0;
  const size_t smem = rtt_nw_sweep_smem(m_cap, n_cap, W);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        nw_sweep_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  nw_sweep_kernel<<<B, W, smem, stream>>>(q4, t4, dcb, moves, score, m_cap,
                                          n_cap, W, match, mismatch, gap,
                                          span);
  return RTT_LAUNCH_STATUS();
}

extern "C" const char* rtt_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

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
// Design on the H100, W <= 256 (K1's tiers (256,128), (640,128),
// (1280,256)): one warp per item, kSweepWarps items per block, LPT = W/32
// band lanes per thread (thread t owns lanes LPT*t .. LPT*t + LPT - 1),
// everything of a row in registers and shuffles. The ablation of
// the block design (one block per item, one thread per lane) found the
// block scan with its barrier 60 % of the time and one barrier a row
// still left without it; here the band lies in one warp, so the row loop
// has no __syncthreads and no shared-memory exchange: the up neighbour of
// a thread's last lane is a __shfl_down of the next thread's first lane,
// the scan is warp_lanes_incl_max (a serial max over the thread's lanes,
// five shuffles, one more for the exclusive prefix), and the target codes
// slide one lane down a row by one more shuffle (the top lane reads one
// byte of shared memory). Each warp unpacks its item's codes into its own
// slice of shared memory with 16-byte loads, the deletion bit of each
// target column folded into bit 4 of its code byte (gc is integrated
// per lane from it, as K1's gc register does), behind one __syncwarp.
// Moves: every 16 rows a thread stores its LPT words (16-byte stores at
// K1's LPT = 4 and 8), so a warp writes one contiguous 4 W-byte run. What
// bounds it: instruction throughput, ~15 integer ops per cell and ~8
// shuffles a row per warp, with a warp per item resident to hide each
// warp's chain of dependent shuffles.
//
// W = 288 .. 4096 (K2's and K5's tiers and the align stage's scored
// route): one block per item, one thread per band lane up to W = 1024,
// two (lanes 2t, 2t+1) at W = 2048 and four (4t..4t+3) at W = 4096, so a
// block never exceeds 1024 threads. The item's codes and deletion
// bitmask sit in shared memory; gc is integrated per lane from the
// bitmask (popcount once, then one add per row). The scan is
// block_incl_max. Only each thread's first lane goes through shared
// memory (the up move of the thread below reads it). What bounds it: two
// block barriers and the ~log2(32) shuffle latency chain per row
// (latency, not bandwidth: 2 bits of output per cell), so enough items
// must be resident to fill the SMs; a 1024-thread block holds at most 64
// registers per thread. At (40960, 4096) the codes and bitmask take
// ~93 KB of shared memory, past the 48 KB default, so the launcher raises
// the limit.
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

constexpr int kSweepWarps = 4;   // items (warps) per block of the warp
                                 // kernel; geometry.SWEEP_WARPS

// 8 codes from 4 bytes of a nibble-packed row (low nibble first), one
// code per byte
__device__ __forceinline__ uint2 unpack8(uint32_t v) {
  const uint32_t lo = v & 0x0F0F0F0Fu;
  const uint32_t hi = (v >> 4) & 0x0F0F0F0Fu;
  return make_uint2(__byte_perm(lo, hi, 0x5140), __byte_perm(lo, hi, 0x7362));
}

// bit c of x (c < 4) to bit 4 of byte c
__device__ __forceinline__ uint32_t spread4(uint32_t x) {
  return ((x & 1u) | ((x & 2u) << 7) | ((x & 4u) << 14) | ((x & 8u) << 21))
         << 4;
}

// target column value of the warp kernel: code | deletion bit << 4, PAD
// (and no deletion cost) outside the target
__device__ __forceinline__ int col_at(const uint8_t* cs, int j, int n_cap) {
  return (j >= 0 && j < n_cap) ? cs[j] : kPad;
}

// a thread's LPT move words: 16-byte stores where LPT % 4 == 0 (K1's
// tiers), else one word at a time
template <int LPT>
__device__ __forceinline__ void store_words(int32_t* dst,
                                            const uint32_t (&w)[LPT]) {
  if constexpr (LPT % 4 == 0) {
#pragma unroll
    for (int v = 0; v < LPT; v += 4)
      *reinterpret_cast<int4*>(dst + v) =
          make_int4(w[v], w[v + 1], w[v + 2], w[v + 3]);
  } else {
#pragma unroll
    for (int v = 0; v < LPT; ++v) dst[v] = static_cast<int32_t>(w[v]);
  }
}

// W = 32 * LPT <= 256: one warp per item (see the note at the top).
// Shared memory per warp: the query codes (m_cap bytes), then the target
// column values (n_cap bytes). The minimum of one block a SM frees ptxas
// from its occupancy target: without it, it spilled 4 bytes at LPT = 6.
template <int LPT>
__global__ void __launch_bounds__(32 * kSweepWarps, 1)
nw_sweep_warp_kernel(const uint8_t* __restrict__ q4,
                     const uint8_t* __restrict__ t4,
                     const uint8_t* __restrict__ dcb,
                     int32_t* __restrict__ moves,
                     int32_t* __restrict__ score, int B, int m_cap,
                     int n_cap, int match, int mismatch, int gap,
                     int span) {
  extern __shared__ uint4 wsmem[];
  constexpr int W = 32 * LPT;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * kSweepWarps + warp;
  if (b >= B) return;  // the whole warp: nothing below syncs the block
  uint8_t* qs = reinterpret_cast<uint8_t*>(wsmem) + warp * (m_cap + n_cap);
  uint8_t* cs = qs + m_cap;
  const int k0 = LPT * lane;
  const int dlo = n_cap - m_cap - W / 2;

  // codes into shared memory: 16 bytes (32 codes) a load where the row
  // allows it (targets always: n_cap % 32 == 0), 8 bytes otherwise
  const uint8_t* qrow = q4 + static_cast<size_t>(b) * (m_cap / 2);
  if (m_cap % 32 == 0) {
    for (int x = lane; x < m_cap / 32; x += 32) {
      const uint4 v = reinterpret_cast<const uint4*>(qrow)[x];
      const uint2 a = unpack8(v.x), c = unpack8(v.y), d = unpack8(v.z),
                  e = unpack8(v.w);
      uint4* dst = reinterpret_cast<uint4*>(qs + 32 * x);
      dst[0] = make_uint4(a.x, a.y, c.x, c.y);
      dst[1] = make_uint4(d.x, d.y, e.x, e.y);
    }
  } else {
    for (int x = lane; x < m_cap / 16; x += 32) {
      const uint2 v = reinterpret_cast<const uint2*>(qrow)[x];
      const uint2 a = unpack8(v.x), c = unpack8(v.y);
      *reinterpret_cast<uint4*>(qs + 16 * x) = make_uint4(a.x, a.y, c.x, c.y);
    }
  }
  const uint4* trow =
      reinterpret_cast<const uint4*>(t4 + static_cast<size_t>(b) * (n_cap / 2));
  const uint32_t* drow = reinterpret_cast<const uint32_t*>(
      dcb + static_cast<size_t>(b) * (n_cap / 8));
  for (int x = lane; x < n_cap / 32; x += 32) {
    const uint4 v = trow[x];
    const uint32_t bits = drow[x];  // columns 32x .. 32x + 31
    uint2 p[4] = {unpack8(v.x), unpack8(v.y), unpack8(v.z), unpack8(v.w)};
#pragma unroll
    for (int y = 0; y < 4; ++y) {
      p[y].x |= spread4((bits >> (8 * y)) & 15u);
      p[y].y |= spread4((bits >> (8 * y + 4)) & 15u);
    }
    uint4* dst = reinterpret_cast<uint4*>(cs + 32 * x);
    dst[0] = make_uint4(p[0].x, p[0].y, p[1].x, p[1].y);
    dst[1] = make_uint4(p[2].x, p[2].y, p[3].x, p[3].y);
  }
  __syncwarp();

  // row 0: H[0][j] = gc[j] inside the matrix, NEG outside; c[u] is the
  // column value at j - 1 of row 1
  int hp[LPT], gcj[LPT], c[LPT];
  uint32_t pack[LPT];
  const uint32_t* bits = reinterpret_cast<const uint32_t*>(
      dcb + static_cast<size_t>(b) * (n_cap / 8));
#pragma unroll
  for (int u = 0; u < LPT; ++u) {
    const int jz = dlo + k0 + u;
    gcj[u] = gc_at(bits, jz, n_cap, gap);
    hp[u] = (jz >= 0 && jz <= n_cap) ? gcj[u] : kNeg;
    c[u] = col_at(cs, jz, n_cap);
    pack[u] = 0;
  }
  int32_t* mrow = moves + static_cast<size_t>(b) * (m_cap / 16) * W + k0;

  for (int i = 1; i <= m_cap; ++i) {
    const int qc = qs[i - 1];
    const int jb = i + dlo + k0;  // column of the thread's first lane
    if (i > 1) {
      // the window slides one column a row: lane k takes lane k + 1's
      // column value of the row before
      const int next = __shfl_down_sync(kFull, c[0], 1);
#pragma unroll
      for (int u = 0; u + 1 < LPT; ++u) c[u] = c[u + 1];
      c[LPT - 1] = lane == 31 ? col_at(cs, jb + LPT - 2, n_cap) : next;
    }
    // lane k + 1 of the previous row for the thread's last lane
    const int above_last = __shfl_down_sync(kFull, hp[0], 1);
    int diag_c[LPT], up_c[LPT], a[LPT];
#pragma unroll
    for (int u = 0; u < LPT; ++u) {
      const int j = jb + u;
      if (c[u] >> 4) gcj[u] += gap;
      const int tc = c[u] & 15;
      const int sub = ((tc == kPad) != (qc == kPad))
                          ? kNeg : (tc == qc ? match : mismatch);
      diag_c[u] = hp[u] + sub;
      const int above = (u + 1 < LPT) ? hp[(u + 1) % LPT]
                        : (lane == 31 ? kNeg : above_last);
      up_c[u] = above + gap;
      int cand = max(diag_c[u], up_c[u]);
      if (j == 0) cand = i * gap;
      if (j < 0 || j > n_cap) cand = kNeg;
      a[u] = cand - gcj[u];
    }
    warp_lanes_incl_max<LPT>(a, lane);

    const int p = (i - 1) & 15;
#pragma unroll
    for (int u = 0; u < LPT; ++u) {
      const int j = jb + u;
      if (k0 + u <= span - 2) a[u] = max(a[u], kScanFill);
      int h = a[u] + gcj[u];
      if (j < 0 || j > n_cap) h = kNeg;
      int mv = (h == diag_c[u]) ? 0 : ((h == up_c[u]) ? 1 : 2);
      if (j < 1 || j > n_cap) mv = 3;
      pack[u] |= static_cast<uint32_t>(mv) << (2 * p);
      hp[u] = h;
    }
    if (p == 15) {
      store_words<LPT>(mrow + ((i - 1) >> 4) * W, pack);
#pragma unroll
      for (int u = 0; u < LPT; ++u) pack[u] = 0;
    }
  }
#pragma unroll
  for (int u = 0; u < LPT; ++u)
    if (k0 + u == n_cap - m_cap - dlo) score[b] = hp[u];
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

// band lanes per thread of the block kernel at band width W
static int lanes_per_thread(int W) {
  return W <= 1024 ? 1 : (W <= 2048 ? 2 : 4);
}

// shared bytes per block: the warp kernel's kSweepWarps slices of codes
// (W <= 256), or the block kernel's exchange, warp totals, bitmask and
// codes (geometry.sweep_smem)
extern "C" size_t rtt_nw_sweep_smem(int m_cap, int n_cap, int W) {
  if (W <= 256) return static_cast<size_t>(kSweepWarps) * (m_cap + n_cap);
  const int T = W / lanes_per_thread(W);
  return static_cast<size_t>(2 * T + 32 + n_cap / 32) * 4 + m_cap + n_cap;
}

template <typename K>
static int raise_smem(K kernel, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem)));
}

template <int LPT>
static int launch_sweep(const uint8_t* q4, const uint8_t* t4,
                        const uint8_t* dcb, int32_t* moves, int32_t* score,
                        int B, int m_cap, int n_cap, int W, int match,
                        int mismatch, int gap, int span,
                        cudaStream_t stream) {
  const size_t smem = rtt_nw_sweep_smem(m_cap, n_cap, W);
  if (int e = raise_smem(nw_sweep_kernel<LPT>, smem)) return e;
  nw_sweep_kernel<LPT><<<B, W / LPT, smem, stream>>>(
      q4, t4, dcb, moves, score, m_cap, n_cap, W, match, mismatch, gap, span);
  return RTT_LAUNCH_STATUS();
}

template <int LPT>
static int launch_sweep_warp(const uint8_t* q4, const uint8_t* t4,
                             const uint8_t* dcb, int32_t* moves,
                             int32_t* score, int B, int m_cap, int n_cap,
                             int match, int mismatch, int gap, int span,
                             cudaStream_t stream) {
  const size_t smem = rtt_nw_sweep_smem(m_cap, n_cap, 32 * LPT);
  if (int e = raise_smem(nw_sweep_warp_kernel<LPT>, smem)) return e;
  const int blocks = (B + kSweepWarps - 1) / kSweepWarps;
  nw_sweep_warp_kernel<LPT><<<blocks, 32 * kSweepWarps, smem, stream>>>(
      q4, t4, dcb, moves, score, B, m_cap, n_cap, match, mismatch, gap,
      span);
  return RTT_LAUNCH_STATUS();
}

// q4 (B, m_cap/2) u8, t4 (B, n_cap/2) u8, dcb (B, n_cap/8) u8 ->
// moves (B, m_cap/16, W) i32, score (B,) i32. Requires W a multiple of
// 32 * lanes_per_thread(W) and W <= 4096; m_cap % 16 == 0,
// n_cap % 32 == 0, dlo <= 0. W <= 256 always runs the warp kernel.
extern "C" int rtt_nw_sweep(const uint8_t* q4, const uint8_t* t4,
                            const uint8_t* dcb, int32_t* moves,
                            int32_t* score, int B, int m_cap, int n_cap,
                            int W, int match, int mismatch, int gap,
                            int span, cudaStream_t stream) {
  if (B == 0) return 0;
#define RTT_WARP_CASE(L)                                                  \
  case L:                                                                 \
    return launch_sweep_warp<L>(q4, t4, dcb, moves, score, B, m_cap,      \
                                n_cap, match, mismatch, gap, span, stream);
  if (W <= 256) {
    switch (W / 32) {
      RTT_WARP_CASE(1)
      RTT_WARP_CASE(2)
      RTT_WARP_CASE(3)
      RTT_WARP_CASE(4)
      RTT_WARP_CASE(5)
      RTT_WARP_CASE(6)
      RTT_WARP_CASE(7)
      RTT_WARP_CASE(8)
      default:
        return static_cast<int>(cudaErrorInvalidValue);
    }
  }
#undef RTT_WARP_CASE
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

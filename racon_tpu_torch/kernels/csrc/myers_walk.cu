// Word-wise backward traceback over the Myers sweep's DIAG/UP planes.
//
// Replaces racon_tpu/ops/myers_kernel.py::myers_walk_t (body
// _myers_walk_kernel, row step _walk_row_words). From lane
// kvec = n - m - dlo, each query row i = m..1 exits its deletion run at the
// highest lane <= kvec whose DIAG or UP bit is set (the j = 0 lane counts
// as UP), records REC_DIAG or REC_UP | deletions << 2 in byte i - 1, and
// moves to that lane (+1 for an UP step). Escapes: kvec out of the band, no
// exit lane, or more than 63 deletions in a row; a final column outside
// 0..255 escapes too. The payload is the rows format of
// racon_tpu/ops/nw_kernel.py::walk_rows_t, (B, m_cap + 2) bytes: records,
// the final-deletions byte, the escape flag.
//
// Design on the H100: one warp per item, kWalkWarps items per block, so
// that the align stage's chunk of 409 items runs on 205 blocks over all
// 132 SMs. The first design (one thread per item, 128 to a block: 4 blocks
// on 4 SMs at that chunk) paid a DRAM round trip per query row, because
// each row's loads depended on kvec (the chunk's planes are 1.07 GB, past
// the 50 MB L2): ~9 ms a launch. Here the loads leave the dependent chain:
// the warp streams whole rows of both planes into a shared-memory ring
// with cp.async, kWalkRows rows a group, up to a ring (64 rows at
// W <= 1024, 32 above) ahead of the row it walks; the row addresses do
// not depend on kvec. The dependent step per row has no global load: every
// lane computes the same scalar step from the ring (broadcast reads):
// the word of lane kvec masked to lanes <= kvec, its highest set bit by
// clz and that bit's DIAG/UP bits; only a run that leaves the word, or a
// kvec out of the band, takes the out-of-line step_far (at most two words
// further down: the 63-deletion limit). A first version spread the words
// over the warp's lanes and found the exit with __ballot_sync and
// __shfl_sync; its chain of mask, ballot, shuffle and divergent selects
// took ~600 cycles a row against ~200 for the scalar step (PERF.md).
// Records gather in registers (lane r holds row 32g + r + 1's) and go out
// as one coalesced 32-byte store per 32 rows. What bounds it: the latency
// of that per-row chain (shared load, mask, clz, select) times the rows of
// the longest item; the planes stream at a small share of HBM bandwidth.
#include "common.cuh"

namespace {

using namespace rtt;

constexpr int kWalkWarps = 2;   // items (warps) per block;
                                // geometry.MYERS_WALK_WARPS
constexpr int kWalkRows = 16;   // query rows per cp.async group;
                                // geometry.MYERS_WALK_ROWS

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The rare part of a row step: kvec out of the band, or no set lane at or
// below kvec in its own word. Returns k_exit << 2 | DIAG hit << 1 | UP
// hit, or -1 to escape.
__device__ __noinline__ int step_far(const uint32_t* row, int nw, int W,
                                     int kvec, int kz) {
  if (kvec < 0 || kvec >= W) return -1;
  const int wk = kvec >> 5;
  for (int w = wk - 1; w >= 0 && w >= wk - 2; --w) {
    const uint32_t d = row[w], u = row[nw + w], oh = onehot(kz, w);
    const uint32_t nl = (d | u | oh) & mask_ge(kvec - 63, w);
    if (nl) {
      const int pos = 31 - __clz(nl);
      return ((32 * w + pos) << 2)
             | static_cast<int>(((d & ~oh) >> pos & 1u) << 1)
             | static_cast<int>((u | oh) >> pos & 1u);
    }
  }
  return -1;
}

// RING: query rows in each warp's ring, a multiple of kWalkRows
template <int RING>
__global__ void __launch_bounds__(32 * kWalkWarps)
myers_walk_kernel(const uint32_t* __restrict__ planes,
                  const int32_t* __restrict__ m,
                  const int32_t* __restrict__ n,
                  uint8_t* __restrict__ payload, int B, int m_cap,
                  int n_cap, int W) {
  extern __shared__ uint4 walk_ring[];
  constexpr int G = RING / kWalkRows;  // row groups in the ring
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * kWalkWarps + warp;
  if (b >= B) return;  // the whole warp: nothing below syncs the block
  const int nw = W / 32;
  const int rw = 2 * nw;  // words a row: DIAG words, then UP words
  const int dlo = n_cap - m_cap - W / 2;
  uint32_t* ring = reinterpret_cast<uint32_t*>(walk_ring) + warp * RING * rw;
  const uint32_t* pl = planes + static_cast<size_t>(b) * m_cap * rw;
  uint8_t* out = payload + static_cast<size_t>(b) * (m_cap + 2);
  const int mb = m[b];
  int kvec = n[b] - mb - dlo;

  // rows kWalkRows*k + 1 .. kWalkRows*k + kWalkRows into the ring as one
  // commit group (empty for k < 0, so that every group counts)
  auto fetch = [&](int k) {
    if (k >= 0) {
      const char* src = reinterpret_cast<const char*>(
          pl + static_cast<size_t>(kWalkRows * k) * rw);
      char* dst = reinterpret_cast<char*>(
          ring + ((kWalkRows * k) & (RING - 1)) * rw);
      for (int x = lane; x < kWalkRows * rw / 4; x += 32)
        cp_async16(dst + 16 * x, src + 16 * x);
    }
    cp_async_commit();
  };
  const int ktop = mb >= 1 ? (mb - 1) / kWalkRows : -1;
  for (int g = 0; g < G - 1; ++g) fetch(ktop - g);

  // records above row m are 0
  for (int x = ((mb + 31) & ~31) + lane; x < m_cap; x += 32) out[x] = 0;
  bool esc = false;
  uint32_t rec = 0;  // lane r: the record of row 32g + r + 1
  int i = mb;
  for (int k = ktop; k >= 0; --k) {
    __syncwarp();  // every lane is done with the group fetch() replaces
    fetch(k - (G - 1));
    cp_async_wait<G - 1>();
    __syncwarp();  // group k is in the ring for every lane
#pragma unroll
    for (int r = kWalkRows - 1; r >= 0; --r) {
      i = kWalkRows * k + r + 1;
      if (i > mb) continue;
      const uint32_t* row = ring + ((i - 1) & (RING - 1)) * rw;
      const int kz = -(i + dlo);  // the lane of column 0
      // the dependent step: the highest set lane <= kvec in its word
      const int w = min(static_cast<unsigned>(kvec) >> 5,
                        static_cast<unsigned>(nw - 1));
      const uint32_t d = row[w], u = row[nw + w];
      const int rel = kz - 32 * w;
      const uint32_t oh = static_cast<unsigned>(rel) < 32u ? 1u << rel : 0u;
      const uint32_t nl = (d | u | oh) & (kFull >> (31 - (kvec & 31)));
      int k_exit;
      bool dh, uh;
      if (nl && static_cast<unsigned>(kvec) < static_cast<unsigned>(W)) {
        const int pos = 31 - __clz(nl);
        k_exit = 32 * w + pos;
        dh = (d & ~oh) >> pos & 1u;
        uh = (u | oh) >> pos & 1u;
      } else {
        const int pk = step_far(row, nw, W, kvec, kz);
        if (pk < 0) {
          esc = true;  // sticky; kvec keeps its lane
          goto walked;
        }
        k_exit = pk >> 2;
        dh = pk & 2;
        uh = pk & 1;
      }
      const uint32_t val = (dh ? kRecDiag : kRecUp) | ((kvec - k_exit) << 2);
      rec = lane == ((i - 1) & 31) ? val : rec;
      kvec = k_exit + ((uh && !dh) ? 1 : 0);
    }
    if (((kWalkRows * k) & 31) == 0) {
      out[kWalkRows * k + lane] = static_cast<uint8_t>(rec);
      rec = 0;
    }
  }
walked:
  if (esc) {
    // the escaping row's group (rows above it walked), then 0 below
    const int g0 = (i - 1) & ~31;
    out[g0 + lane] = static_cast<uint8_t>(rec);
    for (int x = lane; x < g0; x += 32) out[x] = 0;
  }
  cp_async_wait<0>();
  if (lane == 0) {
    const int jfin = dlo + kvec;
    if (jfin < 0 || jfin > 255) esc = true;
    out[m_cap] = static_cast<uint8_t>(min(max(jfin, 0), 255));
    out[m_cap + 1] = esc ? 1 : 0;
  }
}

template <int RING>
int launch_walk(const uint32_t* planes, const int32_t* m, const int32_t* n,
                uint8_t* payload, int B, int m_cap, int n_cap, int W,
                cudaStream_t stream) {
  const size_t smem =
      static_cast<size_t>(kWalkWarps) * RING * 2 * (W / 32) * 4;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        myers_walk_kernel<RING>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int blocks = (B + kWalkWarps - 1) / kWalkWarps;
  myers_walk_kernel<RING><<<blocks, 32 * kWalkWarps, smem, stream>>>(
      planes, m, n, payload, B, m_cap, n_cap, W);
  return RTT_LAUNCH_STATUS();
}

}  // namespace

// planes (B, m_cap, 2, W/32) i32 from rtt_myers_sweep, m/n (B,) i32 ->
// payload (B, m_cap + 2) u8 in the rows format. W a multiple of 32 up to
// 4096, m_cap % 32 == 0. The ring holds 64 rows up to W = 1024 and 32
// above (geometry.myers_walk_launch).
extern "C" int rtt_myers_walk(const int32_t* planes, const int32_t* m,
                              const int32_t* n, uint8_t* payload, int B,
                              int m_cap, int n_cap, int W,
                              cudaStream_t stream) {
  if (B == 0) return 0;
  const uint32_t* p = reinterpret_cast<const uint32_t*>(planes);
  if (W <= 1024)
    return launch_walk<64>(p, m, n, payload, B, m_cap, n_cap, W, stream);
  return launch_walk<32>(p, m, n, payload, B, m_cap, n_cap, W, stream);
}

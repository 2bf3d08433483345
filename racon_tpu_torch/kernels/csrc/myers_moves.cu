// Myers planes to the scored sweep's 2-bit moves (J5).
//
// Replaces racon_tpu/ops/myers_kernel.py::myers_moves_from_planes
// (:655-693), the jnp transform behind align_walk_myers_rle_batch: the
// Myers sweep's DIAG and UP band words, (B, m_cap, 2, W/32) int32, become
// move words in nw_band_batch_t8's layout, (B, m_cap/16, W) int32 with
// 16 rows of one lane a word (bits 2r, 2r + 1 for row 16g + r + 1), so the
// RLE walk runs on Myers output. Per cell: 0 where the DIAG bit is set,
// else 1 where UP is set, else 2; 3 where jrow = i + dlo + k is < 1 or
// > n_cap and for rows i > m.
//
// Design on the H100: one warp per (item, 16-row group, 32-lane word).
// Lane j loads one plane word, of row 16g + (j >> 1) and plane j & 1, so
// the warp holds a 32 x 32 bit matrix whose column t is everything lane t
// (band lane k = 32w + t) needs; a five-step shuffle transpose hands each
// lane its column, from which it builds its output word with a few bit
// operations and writes it: a warp's stores are one coalesced 128-byte
// row. The eight warps of a block take neighbouring words of the same
// rows, so the loads of a block fill whole sectors through L1. What
// bounds it: bytes, the planes read once and the moves written once (the
// two are equal in size); the transpose is 5 shuffles a word.
#include "common.cuh"

namespace {

using namespace rtt;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

// Bits 0 .. 2n - 1 (n row pairs, n <= 16).
__device__ __forceinline__ uint32_t pairs_below(int n) {
  return n >= 16 ? kFull : (1u << (2 * n)) - 1u;
}

__global__ void __launch_bounds__(kThreads)
    myers_moves_kernel(const uint32_t* __restrict__ planes,
                       const int32_t* __restrict__ m,
                       uint32_t* __restrict__ moves, int B, int m_cap,
                       int n_cap, int W) {
  const int nw = W >> 5;
  const int G = m_cap >> 4;
  const long long tiles = static_cast<long long>(B) * G * nw;
  const long long tile =
      static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (tile >= tiles) return;  // a whole warp: the tile is warp-uniform
  const int lane = threadIdx.x & 31;
  const int w = static_cast<int>(tile % nw);
  const long long bg = tile / nw;  // b * G + g
  const int g = static_cast<int>(bg % G);
  const int b = static_cast<int>(bg / G);
  // row 16g + (lane >> 1) of item b, plane lane & 1, word w
  const long long row = static_cast<long long>(b) * m_cap + 16 * g +
                        (lane >> 1);
  uint32_t x = __ldg(planes + (row * 2 + (lane & 1)) * nw + w);
  // bit 2r + p: plane p (0 DIAG, 1 UP) of row 16g + r + 1 at lane 32w + lane
  x = transpose32(x, lane);
  const uint32_t nd = ~x & 0x55555555u;          // DIAG clear, at bit 2r
  const uint32_t up = (x >> 1) & 0x55555555u;    // UP, at bit 2r
  uint32_t code = (nd & up) | ((nd & ~up) << 1);  // 0 DIAG, 1 UP, 2 LEFT
  // pairs r of the band's columns 1 .. n_cap and rows up to m: the others 3
  const int k = 32 * w + lane;
  const int j0 = 16 * g + 1 + (n_cap - m_cap - W / 2) + k;  // jrow of r = 0
  const int rlo = max(0, 1 - j0);
  const int rhi = min(15, min(n_cap - j0, m[b] - (16 * g + 1)));
  const uint32_t valid =
      rlo > rhi ? 0u : (pairs_below(rhi + 1) & ~pairs_below(rlo));
  moves[bg * W + k] = code | ~valid;
}

}  // namespace

// moves (B, m_cap/16, W) int32 from planes (B, m_cap, 2, W/32) int32 and
// m (B,) int32. m_cap a multiple of 16, W of 32 (checked by the bindings).
extern "C" int rtt_myers_moves(const int32_t* planes, const int32_t* m,
                               int32_t* moves, int B, int m_cap, int n_cap,
                               int W, cudaStream_t stream) {
  const long long tiles =
      static_cast<long long>(B) * (m_cap / 16) * (W / 32);
  if (tiles == 0) return 0;
  const long long blocks = (tiles + kWarps - 1) / kWarps;
  myers_moves_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      reinterpret_cast<const uint32_t*>(planes), m,
      reinterpret_cast<uint32_t*>(moves), B, m_cap, n_cap, W);
  return RTT_LAUNCH_STATUS();
}

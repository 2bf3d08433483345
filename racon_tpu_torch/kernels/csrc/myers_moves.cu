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
// Design on the H100. A tile is (item b, 16-row group g, 32-lane word w):
// its 32 plane words (rows 16g .. 16g + 15, both planes, word w) in, its 32
// move words (band lanes 32w .. 32w + 31 of group g) out, the same 128
// bytes each way; tile T = (b G + g) nw + w writes moves[32 T .. 32 T + 31].
// Lane T % 32 of warp T / 32 owns tile T, found once in 32-bit arithmetic.
// It issues its 32 loads (one plane word each) before using any, so a
// thread keeps 128 bytes in flight, and a warp's load of one plane row of
// its tiles is one coalesced run (128 bytes at W >= 1024, 64 at W = 512).
// A tile with no valid cell (rows past m, or columns all outside 1 ..
// n_cap) is all ones whatever the planes hold: it loads nothing. The 32 x
// 32 bit transpose runs in registers (five rounds of word-pair block
// swaps, two shifts and two LOP3 a pair: 10 instructions a word, no
// shuffle), then the codes (4 a word) and, for a tile at an edge only, the
// row and column mask. The warp stages its 32 tiles' words in shared
// memory (rows of kRowWords words, 16 bytes at a time, conflict-free) and
// stores them 16 bytes a lane: each store of the warp one contiguous
// 512-byte run. What bounded the design before (a warp a tile, a lane one
// plane word): 64-bit % and / of the tile index in every warp, 4 bytes in
// flight a thread (8 KB an SM against the ~18 KB that 3.35 TB/s needs at
// ~0.7 us), and five shuffle rounds a word (its 64-bit index math cost
// 10 %: benchmarks/variants/myers_moves_div32/). What bounds this one:
// bytes, the planes read once (less the skipped tiles) and the moves
// written once, at ~25 SASS instructions a word.
#include "common.cuh"

namespace {

using namespace rtt;

constexpr int kWarps = 4;      // warps per block
constexpr int kRowWords = 36;  // a tile's 32 staged words, padded: 8 lanes'
                               // 16-byte accesses fall in distinct banks

// Bits 0 .. 2n - 1 (n row pairs, n <= 16).
__device__ __forceinline__ uint32_t pairs_below(int n) {
  return n >= 16 ? kFull : (1u << (2 * n)) - 1u;
}

// One round of transpose32_regs: words j and j + S (bit S of j clear)
// swap their off-diagonal S x S blocks, as lanes j and j ^ S do in
// common.cuh's transpose32 (mk: the low block of each pair of S bits).
template <int S>
__device__ __forceinline__ void swap_blocks(uint32_t (&x)[32], uint32_t mk) {
#pragma unroll
  for (int j = 0; j < 32; ++j) {
    if (j & S) continue;
    const uint32_t a = x[j], b = x[j + S];
    x[j] = (a & mk) | ((b << S) & ~mk);
    x[j + S] = (b & ~mk) | ((a >> S) & mk);
  }
}

// x[j]: row j of a 32 x 32 bit matrix (bit t = column t). In place, x[t]
// becomes column t (bit j = row j's bit t).
__device__ __forceinline__ void transpose32_regs(uint32_t (&x)[32]) {
  swap_blocks<16>(x, 0x0000FFFFu);
  swap_blocks<8>(x, 0x00FF00FFu);
  swap_blocks<4>(x, 0x0F0F0F0Fu);
  swap_blocks<2>(x, 0x33333333u);
  swap_blocks<1>(x, 0x55555555u);
}

// nw plane words a row (W / 32), G row groups an item, dlo the band's
// first column offset; `tiles` = B G nw.
__global__ void __launch_bounds__(32 * kWarps)
    myers_moves_kernel(const uint32_t* __restrict__ planes,
                       const int32_t* __restrict__ m,
                       uint32_t* __restrict__ moves, unsigned tiles,
                       unsigned G, unsigned nw, int n_cap, int dlo) {
  __shared__ uint4 stage[kWarps][32 * kRowWords / 4];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const unsigned first = (blockIdx.x * kWarps + warp) * 32u;
  if (first >= tiles) return;  // the whole warp
  const unsigned tile = first + lane;
  const bool in = tile < tiles;
  const unsigned bg = (in ? tile : first) / nw;  // b G + g
  const unsigned w = (in ? tile : first) - bg * nw;
  const unsigned b = bg / G;
  const int g = static_cast<int>(bg - b * G);
  // rows of the tile up to m, and the column of its first cell (row 0,
  // lane 0): its cells' columns run from J to J + 46
  const int rows = in ? m[b] - 16 * g : 0;
  const int J = 16 * g + 1 + dlo + 32 * static_cast<int>(w);
  const bool dead = rows <= 0 || J > n_cap || J + 46 < 1;
  const bool interior = rows >= 16 && J >= 1 && J + 46 <= n_cap;

  uint32_t x[32];
  if (!dead) {
    const uint32_t* src = planes + static_cast<size_t>(bg) * 32 * nw + w;
#pragma unroll
    for (int j = 0; j < 32; ++j) x[j] = __ldg(src + j * nw);
  } else {
#pragma unroll
    for (int j = 0; j < 32; ++j) x[j] = 0;
  }
  // bit 2r + p of x[t]: plane p (0 DIAG, 1 UP) of row 16g + r + 1 at lane
  // 32w + t
  transpose32_regs(x);
#pragma unroll
  for (int t = 0; t < 32; ++t) {
    const uint32_t nd = ~x[t] & 0x55555555u;        // DIAG clear, at bit 2r
    const uint32_t up = (x[t] >> 1) & 0x55555555u;  // UP, at bit 2r
    x[t] = (nd & up) | ((nd & ~up) << 1);           // 0 DIAG, 1 UP, 2 LEFT
  }
  if (!interior) {
    // pairs r of the band's columns 1 .. n_cap and rows up to m: the
    // others 3
#pragma unroll
    for (int t = 0; t < 32; ++t) {
      const int j0 = J + t;  // column of row r = 0 at lane 32w + t
      const int rlo = max(0, 1 - j0);
      const int rhi = min(15, min(n_cap - j0, rows - 1));
      const uint32_t valid =
          rlo > rhi ? 0u : (pairs_below(rhi + 1) & ~pairs_below(rlo));
      x[t] |= ~valid;
    }
  }

  uint32_t* row = reinterpret_cast<uint32_t*>(stage[warp]) + lane * kRowWords;
#pragma unroll
  for (int q = 0; q < 8; ++q)
    *reinterpret_cast<uint4*>(row + 4 * q) =
        make_uint4(x[4 * q], x[4 * q + 1], x[4 * q + 2], x[4 * q + 3]);
  __syncwarp();
  const uint32_t* staged = reinterpret_cast<const uint32_t*>(stage[warp]);
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    const int r = 4 * q + (lane >> 3);  // the warp's tile r
    if (first + r < tiles)
      *reinterpret_cast<uint4*>(moves + static_cast<size_t>(first + r) * 32 +
                                4 * (lane & 7)) =
          *reinterpret_cast<const uint4*>(staged + r * kRowWords +
                                          4 * (lane & 7));
  }
}

}  // namespace

// moves (B, m_cap/16, W) int32 from planes (B, m_cap, 2, W/32) int32 and
// m (B,) int32. m_cap a multiple of 16, W of 32 (checked by the bindings);
// B (m_cap/16) (W/32) tiles below 2^31.
extern "C" int rtt_myers_moves(const int32_t* planes, const int32_t* m,
                               int32_t* moves, int B, int m_cap, int n_cap,
                               int W, cudaStream_t stream) {
  const long long tiles =
      static_cast<long long>(B) * (m_cap / 16) * (W / 32);
  if (tiles == 0) return 0;
  if (tiles >= (1LL << 31)) return static_cast<int>(cudaErrorInvalidValue);
  const unsigned blocks =
      static_cast<unsigned>((tiles + 32 * kWarps - 1) / (32 * kWarps));
  myers_moves_kernel<<<blocks, 32 * kWarps, 0, stream>>>(
      reinterpret_cast<const uint32_t*>(planes), m,
      reinterpret_cast<uint32_t*>(moves), static_cast<unsigned>(tiles),
      static_cast<unsigned>(m_cap / 16), static_cast<unsigned>(W / 32), n_cap,
      n_cap - m_cap - W / 2);
  return RTT_LAUNCH_STATUS();
}

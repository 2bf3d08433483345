// Row-synchronous ("rows") traceback walk over the scored sweep's moves.
//
// Replaces the TPU kernel racon_tpu/ops/nw_kernel.py::walk_rows_t (body
// _walk_rows_kernel, row step _walk_rows_row). Walks backward from (m, n)
// one query row at a time and emits one record byte per row:
// REC_DIAG (1) or REC_UP (2) for the move that leaves the row, ORed with
// the number of deletions (LEFT moves) taken in the row before it, << 2;
// 0 for rows above m and rows after an escape. Then the final-deletions
// byte clip(dlo + k, 0, 255) and the escape flag (escaped, or final
// deletions outside [0, 255]).
//
// Per row the walk stands at band lane k (kvec; it starts at n - m - dlo)
// and leaves the row at the nearest lane at or below k whose move is not
// LEFT; the lane of column j = 0 counts as UP. A row escapes when k lies
// outside [0, W), when no such lane exists, when its move is 3 (outside
// the matrix) or when the run has more than 63 deletions. Escape is
// sticky and keeps k.
//
// Design on the H100: the Myers walk's (myers_walk.cu), carried over to
// the scored moves. One warp per item, kRowsWarps items a block, so that
// the align stage's scored chunk of 409 items at (10240, 1024) runs on 205
// blocks over the card (the first design, one thread an item and 64 to a
// block, ran it on 7 SMs and paid a dependent global load per row that
// changed word or lane). The warp streams word-rows (16 query rows, W
// words) into a shared-memory ring with cp.async, up to kRowsSlots - 1
// word-rows ahead of the one it walks. The TPU kernel finds each exit with
// a prefix max over the whole band, and the first design scanned down up
// to 64 words; here the step is the Myers walk's scalar step: the words of
// 32 lanes of the current word-row are turned into bit planes, for each
// row the low and the high bit of the 32 codes (a five-step shuffle
// transpose of the 32 x 32 bit matrix), so a row's exit is the highest
// "not LEFT" bit (~high | low) at or below kvec, by clz, and its code is
// that bit of both planes. The step reads its group's planes before it
// checks that they are this word-row's; where they are not, where kvec
// is out of the band or where the run leaves its 32 lanes, it takes the
// out-of-line step, which transposes a group at its first use in a
// word-row (by the whole warp; a word-row's walk usually needs one) and
// looks at most two groups further down (the 63-deletion limit), so the
// common step has no branch before its load. Every lane computes the
// same scalar step from broadcast reads;
// records gather in registers (lane r holds row 32g + r + 1's) and go out
// as one coalesced 32-byte store per 32 rows. What bounds it: the latency
// of the per-row chain (shared load, mask, clz, select) times the rows of
// the longest item, plus a transpose per word-row.
#include "common.cuh"

namespace {

using namespace rtt;

constexpr int kRowsWarps = 2;  // items (warps) per block;
                               // geometry.ROWS_WALK_WARPS
constexpr int kRowsSlots = 4;  // word-rows in each warp's ring;
                               // geometry.ROWS_WALK_SLOTS

// Group w (lanes 32w .. 32w + 31) of the word-row in `raw` as bit planes:
// word 32w + 2r + h holds bit h of the codes of row r at those lanes. The
// whole warp takes part.
__device__ __forceinline__ void planes_of(const uint32_t* raw,
                                          uint32_t* planes, int w,
                                          int lane) {
  __syncwarp();  // every lane is done with the planes this replaces
  planes[32 * w + lane] = transpose32(raw[32 * w + lane], lane);
  __syncwarp();
}

struct Exit {
  int pk;         // k_exit << 2 | code, or -1 to escape
  uint32_t done;  // the groups in bit planes, as the walk keeps them
};

// The rare part of a row step, out of line: kvec out of the band, its
// group not yet in bit planes this word-row, or no "not LEFT" lane at or
// below kvec in its group. Takes the group and at most two more below
// (lanes >= kvec - 63: the 63-deletion limit), turning each into bit
// planes first where it is not yet; groups wlo .. wlo + 31 are kept in
// `done`, one bit each.
__device__ __noinline__ Exit step_slow(const uint32_t* raw, uint32_t* planes,
                                       uint32_t done, int wlo, int W,
                                       int kvec, int kz, int r, int lane) {
  if (static_cast<unsigned>(kvec) >= static_cast<unsigned>(W))
    return {-1, done};
  const int w = kvec >> 5;
  for (int gw = w; gw >= 0 && gw >= w - 2; --gw) {
    const unsigned rel = static_cast<unsigned>(gw - wlo);
    if (!(rel < 32u && (done >> rel & 1u))) {
      planes_of(raw, planes, gw, lane);
      if (rel < 32u) done |= 1u << rel;
    }
    const uint2 p = *reinterpret_cast<const uint2*>(planes + 32 * gw + 2 * r);
    const uint32_t oh = onehot(kz, gw);
    const uint32_t below =
        gw == w ? kFull >> (31 - (kvec & 31)) : mask_ge(kvec - 63, gw);
    const uint32_t nl = (~p.y | p.x | oh) & below;
    if (nl) {
      const int pos = 31 - __clz(nl);
      const int code = (oh >> pos & 1u)
                           ? 1
                           : static_cast<int>((p.y >> pos & 1u) << 1 |
                                              (p.x >> pos & 1u));
      return {(32 * gw + pos) << 2 | code, done};
    }
  }
  return {-1, done};
}

__global__ void __launch_bounds__(32 * kRowsWarps)
rows_walk_kernel(const uint32_t* __restrict__ moves,
                 const int32_t* __restrict__ m,
                 const int32_t* __restrict__ n,
                 uint8_t* __restrict__ payload, int B, int m_cap, int n_cap,
                 int W) {
  extern __shared__ uint4 rows_smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * kRowsWarps + warp;
  if (b >= B) return;  // the whole warp: nothing below syncs the block
  const int nw = W >> 5;
  const int dlo = n_cap - m_cap - W / 2;
  uint32_t* ring =
      reinterpret_cast<uint32_t*>(rows_smem) + warp * (kRowsSlots + 1) * W;
  uint32_t* planes = ring + kRowsSlots * W;  // the current word-row's
  const uint32_t* mv_b = moves + static_cast<size_t>(b) * (m_cap / 16) * W;
  uint8_t* out = payload + static_cast<size_t>(b) * (m_cap + 2);
  const int top = min(max(m[b], 0), m_cap);
  int kvec = n[b] - m[b] - dlo;

  // word-row g into its slot as one commit group (empty for g < 0, so
  // that every group counts)
  auto fetch = [&](int g) {
    if (g >= 0) {
      const char* src =
          reinterpret_cast<const char*>(mv_b + static_cast<size_t>(g) * W);
      char* dst = reinterpret_cast<char*>(ring + (g & (kRowsSlots - 1)) * W);
      for (int x = lane; x < W / 4; x += 32)
        cp_async16(dst + 16 * x, src + 16 * x);
    }
    cp_async_commit();
  };
  const int gtop = top >= 1 ? (top - 1) >> 4 : -1;
  for (int q = 0; q < kRowsSlots - 1; ++q) fetch(gtop - q);

  // records above row top are 0
  for (int x = ((top + 31) & ~31) + lane; x < m_cap; x += 32) out[x] = 0;
  bool esc = false;
  uint32_t rec = 0;  // lane r: the record of row 32g + r + 1
  int i = top;
  for (int g = gtop; g >= 0; --g) {
    __syncwarp();  // every lane is done with the slot fetch() replaces
    fetch(g - (kRowsSlots - 1));
    cp_async_wait<kRowsSlots - 1>();
    __syncwarp();  // word-row g is in its slot for every lane
    const uint32_t* raw = ring + (g & (kRowsSlots - 1)) * W;
    // groups wlo .. wlo + 31 in bit planes this word-row, one bit each
    // (every group where W <= 1024); another group is transposed at each
    // use
    const int wlo = min(max((kvec >> 5) - 30, 0), max(nw - 32, 0));
    uint32_t done = 0;
#pragma unroll
    for (int r = 15; r >= 0; --r) {
      i = 16 * g + r + 1;
      if (i > top) continue;
      const int kz = -(i + dlo);  // the lane of column 0
      // the dependent step: the highest "not LEFT" lane <= kvec in its
      // group of 32, read before the checks that it is valid
      const int w = min(static_cast<unsigned>(kvec) >> 5,
                        static_cast<unsigned>(nw - 1));
      const uint2 p =
          *reinterpret_cast<const uint2*>(planes + 32 * w + 2 * r);
      const uint32_t oh = onehot(kz, w);
      const uint32_t nl = (~p.y | p.x | oh) & (kFull >> (31 - (kvec & 31)));
      // the lanes whose move is UP (column 0 is), and those whose code is
      // 3 (outside the matrix): read at the exit beside the clz
      const uint32_t upm = (p.x & ~p.y) | oh;
      const uint32_t out3 = p.x & p.y & ~oh;
      const unsigned rel = static_cast<unsigned>(w - wlo);
      int k_exit, up;
      if (nl && static_cast<unsigned>(kvec) < static_cast<unsigned>(W) &&
          rel < 32u && (done >> rel & 1u)) {
        const int pos = 31 - __clz(nl);
        if (out3 >> pos & 1u) {
          esc = true;  // sticky; kvec keeps its lane
          goto walked;
        }
        k_exit = 32 * w + pos;
        up = static_cast<int>(upm >> pos & 1u);
      } else {
        const Exit e = step_slow(raw, planes, done, wlo, W, kvec, kz, r,
                                 lane);
        done = e.done;
        if (e.pk < 0 || (e.pk & 3) == 3) {
          esc = true;
          goto walked;
        }
        k_exit = e.pk >> 2;
        up = (e.pk & 3) == 1;
      }
      const uint32_t val =
          (up ? kRecUp : kRecDiag) | ((kvec - k_exit) << 2);
      rec = lane == ((i - 1) & 31) ? val : rec;
      kvec = k_exit + up;
    }
    if (((16 * g) & 31) == 0) {
      if (16 * g + lane < m_cap)
        out[16 * g + lane] = static_cast<uint8_t>(rec);
      rec = 0;
    }
  }
walked:
  if (esc) {
    // the escaping row's group (rows above it walked), then 0 below
    const int g0 = (i - 1) & ~31;
    if (g0 + lane < m_cap) out[g0 + lane] = static_cast<uint8_t>(rec);
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

}  // namespace

// moves (B, m_cap/16, W) i32 from rtt_nw_sweep, m/n (B,) i32 ->
// payload (B, m_cap + 2) u8: m_cap row records, the final-deletions byte,
// the escape flag. W a multiple of 32 up to 4096 (every band the sweep
// takes); geometry.rows_walk_launch gives the launch.
extern "C" int rtt_rows_walk(const int32_t* moves, const int32_t* m,
                             const int32_t* n, uint8_t* payload, int B,
                             int m_cap, int n_cap, int W,
                             cudaStream_t stream) {
  if (B == 0) return 0;
  if (W <= 0 || W % 32 || W > 4096)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem =
      static_cast<size_t>(kRowsWarps) * (kRowsSlots + 1) * W * 4;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        rows_walk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int blocks = (B + kRowsWarps - 1) / kRowsWarps;
  rows_walk_kernel<<<blocks, 32 * kRowsWarps, smem, stream>>>(
      reinterpret_cast<const uint32_t*>(moves), m, n, payload, B, m_cap,
      n_cap, W);
  return RTT_LAUNCH_STATUS();
}

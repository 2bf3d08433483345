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
// Design on the H100: one thread per item, as rle_walk.cu. The TPU kernel
// advances all 128 items of a tile through every row in lockstep and finds
// each item's exit with a log2(W)-step prefix max over the whole (W, 128)
// move plane, because it cannot gather. Here a thread jumps straight to
// row m (zeroing the records above it) and scans down from k over at most
// 64 lanes: a longer run escapes anyway (more than 63 deletions), so
// stopping there is exact. The word of the current lane holds 16 rows and
// is reused while the walk stays on it. What bounds it: one dependent
// global load per row that changes word or lane (at least m / 16 per
// item), i.e. memory latency; the batch supplies the parallelism.
#include "common.cuh"

namespace {

using namespace rtt;

__global__ void rows_walk_kernel(const uint32_t* __restrict__ moves,
                                 const int32_t* __restrict__ m,
                                 const int32_t* __restrict__ n,
                                 uint8_t* __restrict__ payload, int B,
                                 int m_cap, int n_cap, int W) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const int dlo = n_cap - m_cap - W / 2;
  const uint32_t* mv_b = moves + static_cast<size_t>(b) * (m_cap / 16) * W;
  uint8_t* rec = payload + static_cast<size_t>(b) * (m_cap + 2);
  const int top = min(m[b], m_cap);
  for (int r = max(top, 0); r < m_cap; ++r) rec[r] = 0;
  int kvec = n[b] - m[b] - dlo;
  bool esc = false;
  int cached = -1;  // slot * W + lane of `word`
  uint32_t word = 0;
  for (int i = top; i >= 1; --i) {
    if (esc) {
      rec[i - 1] = 0;
      continue;
    }
    const int slot = (i - 1) >> 4;
    const int sh = 2 * ((i - 1) & 15);
    const int kz = -(i + dlo);  // lane of column j = 0
    int k_exit = -1, mv_exit = 0;
    if (kvec >= 0 && kvec < W) {
      const int lim = max(kvec - 63, 0);
      for (int k = kvec; k >= lim; --k) {
        const int at = slot * W + k;
        if (at != cached) {
          word = mv_b[at];
          cached = at;
        }
        const int mv = (k == kz) ? 1 : static_cast<int>((word >> sh) & 3u);
        if (mv != 2) {
          k_exit = k;
          mv_exit = mv;
          break;
        }
      }
    }
    if (k_exit < 0 || mv_exit == 3) {
      esc = true;
      rec[i - 1] = 0;
      continue;
    }
    const int nleft = kvec - k_exit;
    rec[i - 1] = static_cast<uint8_t>((mv_exit == 1 ? kRecUp : kRecDiag)
                                      | (nleft << 2));
    kvec = k_exit + (mv_exit == 1 ? 1 : 0);
  }
  const int jfin = dlo + kvec;
  rec[m_cap] = static_cast<uint8_t>(min(max(jfin, 0), 255));
  rec[m_cap + 1] = (esc || jfin < 0 || jfin > 255) ? 1 : 0;
}

}  // namespace

// moves (B, m_cap/16, W) i32 from rtt_nw_sweep, m/n (B,) i32 ->
// payload (B, m_cap + 2) u8: m_cap row records, the final-deletions byte,
// the escape flag.
extern "C" int rtt_rows_walk(const int32_t* moves, const int32_t* m,
                             const int32_t* n, uint8_t* payload, int B,
                             int m_cap, int n_cap, int W,
                             cudaStream_t stream) {
  if (B == 0) return 0;
  const int threads = 64;
  rows_walk_kernel<<<(B + threads - 1) / threads, threads, 0, stream>>>(
      reinterpret_cast<const uint32_t*>(moves), m, n, payload, B, m_cap,
      n_cap, W);
  return RTT_LAUNCH_STATUS();
}

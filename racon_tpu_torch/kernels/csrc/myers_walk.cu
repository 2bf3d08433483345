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
// Design on the H100: one thread per item. A row reads at most three
// words of each plane (the 63-deletion limit bounds the search), so the
// walk is a chain of dependent global loads: memory latency bound, with the
// batch supplying the parallelism.
#include "common.cuh"

namespace {

using namespace rtt;

__global__ void myers_walk_kernel(const uint32_t* __restrict__ planes,
                                  const int32_t* __restrict__ m,
                                  const int32_t* __restrict__ n,
                                  uint8_t* __restrict__ payload, int B,
                                  int m_cap, int n_cap, int W) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const int nw = W / 32;
  const int dlo = n_cap - m_cap - W / 2;
  const uint32_t* pl = planes + static_cast<size_t>(b) * m_cap * 2 * nw;
  uint8_t* out = payload + static_cast<size_t>(b) * (m_cap + 2);
  const int mb = m[b];
  int kvec = n[b] - mb - dlo;
  bool esc = false;
  for (int i = m_cap; i > mb; --i) out[i - 1] = 0;
  for (int i = mb; i >= 1; --i) {
    if (esc) {
      out[i - 1] = 0;
      continue;
    }
    const int kz = -(i + dlo);
    const uint32_t* drow = pl + static_cast<size_t>(i - 1) * 2 * nw;
    const uint32_t* urow = drow + nw;
    const bool inband = kvec >= 0 && kvec < W;
    int k_exit = -1;
    if (inband) {
      const int wk = kvec >> 5;
      for (int w = wk; w >= 0 && 32 * w + 31 >= kvec - 63; --w) {
        uint32_t nl = drow[w] | urow[w] | onehot(kz, w);
        if (w == wk) nl &= (2u << (kvec & 31)) - 1u;
        if (nl) {
          k_exit = 32 * w + 31 - __clz(nl);
          break;
        }
      }
    }
    const int nleft = kvec - k_exit;
    if (!inband || k_exit < 0 || nleft > 63) {
      esc = true;
      out[i - 1] = 0;
      continue;
    }
    const int we = k_exit >> 5;
    const uint32_t bit = 1u << (k_exit & 31);
    const uint32_t oh = onehot(kz, we);
    const bool dh = (drow[we] & ~oh & bit) != 0;
    const bool uh = ((urow[we] | oh) & bit) != 0;
    out[i - 1] = static_cast<uint8_t>((dh ? kRecDiag : kRecUp) | (nleft << 2));
    kvec = k_exit + ((uh && !dh) ? 1 : 0);
  }
  const int jfin = dlo + kvec;
  if (jfin < 0 || jfin > 255) esc = true;
  out[m_cap] = static_cast<uint8_t>(min(max(jfin, 0), 255));
  out[m_cap + 1] = esc ? 1 : 0;
}

}  // namespace

// planes (B, m_cap, 2, W/32) i32 from rtt_myers_sweep, m/n (B,) i32 ->
// payload (B, m_cap + 2) u8 in the rows format.
extern "C" int rtt_myers_walk(const int32_t* planes, const int32_t* m,
                              const int32_t* n, uint8_t* payload, int B,
                              int m_cap, int n_cap, int W,
                              cudaStream_t stream) {
  if (B == 0) return 0;
  const int threads = 128;
  myers_walk_kernel<<<(B + threads - 1) / threads, threads, 0, stream>>>(
      reinterpret_cast<const uint32_t*>(planes), m, n, payload, B, m_cap,
      n_cap, W);
  return RTT_LAUNCH_STATUS();
}

// packed2 traceback walk over the scored sweep's moves.
//
// Replaces racon_tpu/ops/nw_kernel.py::walk_moves_device(packed=True), a
// jnp while_loop on the TPU that goes with the lane-major sweep
// nw_band_batch (the reference's W = 2048 tier). Walks backward from
// (m, n) and emits one 2-bit code per step, 0 = diagonal, 1 = up
// (insertion), 2 = left (deletion), 3 = skip, four steps per byte (step
// 4p+u in bits 2u..2u+1 of byte p). Row 0 forces left steps and column 0
// up steps; at an interior cell outside the band, or on a move of 3, the
// item escapes. The walk stops at the origin; one that has not reached it
// after S steps is escaped too. The rest of the stream is skip codes
// (0xFF bytes), and byte S/4 holds the escape flag. Byte for byte the
// reference's payload, whose batch-wide loop only pads finished items.
//
// Design on the H100: one thread per item, each writing its own payload
// row; the (B, m_cap/16, W) move words are read straight from global
// memory. What bounds it: one dependent global load per step (a walk is
// about m + n steps, up to S = 14336 at the (10240, 2048) tier), i.e.
// memory latency; the batch supplies the parallelism. An all-PAD item
// (m = n = 0) starts at the origin and finishes at once.
#include "common.cuh"

namespace {

using namespace rtt;

constexpr int kSkip = 3;  // OP_STREAM_SKIP

__global__ void packed_walk_kernel(const uint32_t* __restrict__ moves,
                                   const int32_t* __restrict__ m,
                                   const int32_t* __restrict__ n,
                                   uint8_t* __restrict__ payload, int B,
                                   int m_cap, int n_cap, int W, int S) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const int dlo = n_cap - m_cap - W / 2;
  const uint32_t* mv_b = moves + static_cast<size_t>(b) * (m_cap / 16) * W;
  uint8_t* out = payload + static_cast<size_t>(b) * (S / 4 + 1);
  const int m_b = m[b];
  const int n_b = n[b];
  int i = m_b;
  int j = n_b;
  bool esc = false;
  int s = 0;
  uint32_t byte = 0;
  while (s < S && !(i == 0 && j == 0)) {
    const int k = j - i - dlo;
    const int row = max(i - 1, 0);
    const uint32_t word = mv_b[(row >> 4) * W + min(max(k, 0), W - 1)];
    int mv = (word >> (2 * (row & 15))) & 3;
    if (i == 0) mv = 2;              // row 0: all deletions
    if (j == 0 && i > 0) mv = 1;     // column 0: all insertions
    const bool inband = k >= 0 && k < W;
    if (i > 0 && j > 0 && (!inband || mv == 3)) {
      esc = true;  // this step and all later ones are skips
      break;
    }
    const bool real = mv == 0 ? (i <= m_b && j <= n_b)
                              : (mv == 1 ? i <= m_b : j <= n_b);
    byte |= static_cast<uint32_t>(real ? mv : kSkip) << (2 * (s & 3));
    if ((s & 3) == 3) {
      out[s >> 2] = static_cast<uint8_t>(byte);
      byte = 0;
    }
    i -= (mv == 0 || mv == 1) ? 1 : 0;
    j -= (mv == 0 || mv == 2) ? 1 : 0;
    ++s;
  }
  int p = s >> 2;
  if (s & 3) out[p++] = static_cast<uint8_t>(byte | (0xFFu << (2 * (s & 3))));
  for (; p < S / 4; ++p) out[p] = 0xFF;
  out[S / 4] = (esc || i != 0 || j != 0) ? 1 : 0;
}

}  // namespace

// moves (B, m_cap/16, W) i32 from rtt_nw_sweep, m/n (B,) i32 ->
// payload (B, S/4 + 1) u8: the packed step stream, then the escape flag.
// Requires S % 4 == 0.
extern "C" int rtt_packed_walk(const int32_t* moves, const int32_t* m,
                               const int32_t* n, uint8_t* payload, int B,
                               int m_cap, int n_cap, int W, int S,
                               cudaStream_t stream) {
  if (B == 0) return 0;
  const int threads = 128;
  packed_walk_kernel<<<(B + threads - 1) / threads, threads, 0, stream>>>(
      reinterpret_cast<const uint32_t*>(moves), m, n, payload, B, m_cap,
      n_cap, W, S);
  return RTT_LAUNCH_STATUS();
}

// RLE traceback walk over the scored sweep's moves.
//
// Replaces racon_tpu/ops/nw_kernel.py::walk_moves_rle_t, a jnp while_loop
// on the TPU. Walks backward from (m, n) and emits one byte per event:
// 1..16 a diagonal run, 201 an UP step, 202 a LEFT step, 0 filler; each
// iteration takes a run and, when its bits live in the same move word, the
// indel after it, and writes both bytes. A run stops at the 16-row word
// boundary, clz of an all-zero word counts 31 (the reference's binary
// search), and the loop stops at s + 1 < E, so the bytes match the
// reference exactly. Escapes (band exit, a pad move, budget overflow) set
// the flag in byte E and send the item to the host aligner.
//
// Design on the H100: one thread per item, the sweep's (B, m_cap/16, W)
// words read straight from global memory (L2-resident at chunk sizes).
// What bounds it: one dependent global load per iteration (~100 events
// per 500 bp window), i.e. memory latency; the batch supplies the
// parallelism.
#include "common.cuh"

namespace {

using namespace rtt;

__global__ void rle_walk_kernel(const uint32_t* __restrict__ moves,
                                const int32_t* __restrict__ m,
                                const int32_t* __restrict__ n,
                                uint8_t* __restrict__ payload, int B,
                                int m_cap, int n_cap, int W, int E) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const int dlo = n_cap - m_cap - W / 2;
  const uint32_t* mv_b = moves + static_cast<size_t>(b) * (m_cap / 16) * W;
  uint8_t* ev = payload + static_cast<size_t>(b) * (E + 1);
  int i = m[b];
  int j = n[b];
  bool esc = false;
  int s = 0;
  while (s + 1 < E && !(i == 0 && j == 0) && !esc) {
    const bool interior = i > 0 && j > 0;
    const int row = max(i - 1, 0);
    const int k = j - i - dlo;
    const uint32_t word = mv_b[(row >> 4) * W + min(max(k, 0), W - 1)];
    const int p = row & 15;
    int mv = (word >> (2 * p)) & 3;
    if (i == 0) mv = 2;
    if (j == 0 && i > 0) mv = 1;
    const bool inband = k >= 0 && k < W;
    esc = interior && (!inband || mv == 3);
    // diagonal run: zero 2-bit groups from group p downward in this word
    const uint32_t z = word << (2 * (15 - p));
    const int nlz = z ? __clz(z) : 31;
    int d = min(nlz >> 1, p + 1);
    d = (interior && !esc) ? min(d, min(i, j)) : 0;
    int out = d > 0 ? d : (mv == 1 ? kRleUp : (mv == 2 ? kRleLeft : 0));
    int di = d > 0 ? d : (mv == 1 ? 1 : 0);
    int dj = d > 0 ? d : (mv == 2 ? 1 : 0);
    if (esc) out = di = dj = 0;
    const int i1 = i - di;
    const int j1 = j - dj;
    // fused second event from the same word
    const bool origin2 = i1 == 0 && j1 == 0;
    const bool interior2 = i1 > 0 && j1 > 0;
    const int p2 = p - d;
    int mv2 = (word >> (2 * max(p2, 0))) & 3;
    if (i1 == 0) mv2 = 2;
    if (j1 == 0 && i1 > 0) mv2 = 1;
    const bool take2 = !esc && d > 0 && !origin2
                       && (!interior2 || (p2 >= 0 && (mv2 == 1 || mv2 == 2)));
    ev[s] = static_cast<uint8_t>(out);
    ev[s + 1] = take2 ? static_cast<uint8_t>(mv2 == 1 ? kRleUp : kRleLeft)
                      : static_cast<uint8_t>(0);
    i = i1 - ((take2 && mv2 == 1) ? 1 : 0);
    j = j1 - ((take2 && mv2 == 2) ? 1 : 0);
    s += 2;
  }
  for (; s < E; ++s) ev[s] = 0;
  ev[E] = (esc || i != 0 || j != 0) ? 1 : 0;
}

}  // namespace

// moves (B, m_cap/16, W) i32 from rtt_nw_sweep, m/n (B,) i32 ->
// payload (B, E + 1) u8: E event bytes then the escape flag.
extern "C" int rtt_rle_walk(const int32_t* moves, const int32_t* m,
                            const int32_t* n, uint8_t* payload, int B,
                            int m_cap, int n_cap, int W, int E,
                            cudaStream_t stream) {
  if (B == 0) return 0;
  const int threads = 128;
  rle_walk_kernel<<<(B + threads - 1) / threads, threads, 0, stream>>>(
      reinterpret_cast<const uint32_t*>(moves), m, n, payload, B, m_cap,
      n_cap, W, E);
  return RTT_LAUNCH_STATUS();
}

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
// Design on the H100: one thread per item, one warp of kWalkItems items
// per block (rle_walk_items: 16 where 32 payload rows would not fit in
// shared memory), so B = 4096 runs on 128 blocks over the card's SMs. The
// sweep's (B, m_cap/16, W) words are read straight from global memory.
// Each thread writes its events into its own row of a staging area in
// shared memory, zeroed first, which holds the warp's items' payload rows
// exactly as they lie in global memory; the warp then copies that one
// contiguous span out with 16-byte stores (a span starts on a 16-byte
// boundary: the payload does, and 16 or 32 rows are a multiple of 16
// bytes; a ragged last block's bytes past the last boundary go one at a
// time). Written straight to global memory, byte by byte, rows E + 1 bytes
// apart put every warp-wide store on 32 sectors. What bounds it: one
// dependent global load per iteration (~100 events per 500 bp window),
// i.e. memory latency; the batch supplies the parallelism.
#include "common.cuh"

namespace {

using namespace rtt;

constexpr int kWalkItems = 32;  // items (threads) per block, at most;
                                // geometry.RLE_WALK_ITEMS
constexpr size_t kMaxStage = 227 * 1024;  // shared bytes a block may use

// Shared bytes of a block's staging area: `items` rows of E + 1 bytes,
// zeroed in whole 16-byte words. geometry.rle_walk_launch.
size_t stage_bytes(int items, int E) {
  return (static_cast<size_t>(items) * (E + 1) + 15) / 16 * 16;
}

// Items per block: kWalkItems, or half as many where their staging area
// passes kMaxStage; 0 if even that does not fit. geometry.rle_walk_items.
int walk_items(int E) {
  for (int items = kWalkItems; items >= kWalkItems / 2; items /= 2)
    if (stage_bytes(items, E) <= kMaxStage) return items;
  return 0;
}

__device__ __forceinline__ void walk_item(const uint32_t* __restrict__ mv_b,
                                          int i, int j, uint8_t* ev,
                                          int m_cap, int n_cap, int W,
                                          int E) {
  const int dlo = n_cap - m_cap - W / 2;
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
    if (take2)
      ev[s + 1] = static_cast<uint8_t>(mv2 == 1 ? kRleUp : kRleLeft);
    i = i1 - ((take2 && mv2 == 1) ? 1 : 0);
    j = j1 - ((take2 && mv2 == 2) ? 1 : 0);
    s += 2;
  }
  // the rest of the row is the staging area's zeros
  ev[E] = (esc || i != 0 || j != 0) ? 1 : 0;
}

__global__ void __launch_bounds__(32)
    rle_walk_kernel(const uint32_t* __restrict__ moves,
                    const int32_t* __restrict__ m,
                    const int32_t* __restrict__ n,
                    uint8_t* __restrict__ payload, int B, int m_cap,
                    int n_cap, int W, int E, int items) {
  extern __shared__ uint4 stage4[];
  uint8_t* stage = reinterpret_cast<uint8_t*>(stage4);
  const int lane = threadIdx.x;
  const int b0 = blockIdx.x * items;
  const int nb = min(items, B - b0);
  const size_t row = static_cast<size_t>(E) + 1;
  const int span = static_cast<int>(nb * row);
  uint8_t* gspan = payload + b0 * row;

  for (int k = lane; k < (span + 15) / 16; k += 32)
    stage4[k] = make_uint4(0, 0, 0, 0);
  __syncwarp();
  if (lane < nb) {
    const int b = b0 + lane;
    walk_item(moves + static_cast<size_t>(b) * (m_cap / 16) * W, m[b], n[b],
              stage + lane * row, m_cap, n_cap, W, E);
  }
  __syncwarp();
  // out: whole 16-byte words, then the bytes past the last one
  const int body = span / 16;
  uint4* dst = reinterpret_cast<uint4*>(gspan);
  for (int k = lane; k < body; k += 32) dst[k] = stage4[k];
  for (int k = 16 * body + lane; k < span; k += 32) gspan[k] = stage[k];
}

}  // namespace

// moves (B, m_cap/16, W) i32 from rtt_nw_sweep, m/n (B,) i32 ->
// payload (B, E + 1) u8, 16-byte aligned: E event bytes then the escape
// flag.
extern "C" int rtt_rle_walk(const int32_t* moves, const int32_t* m,
                            const int32_t* n, uint8_t* payload, int B,
                            int m_cap, int n_cap, int W, int E,
                            cudaStream_t stream) {
  if (B == 0) return 0;
  const int items = walk_items(E);
  if (items == 0 || reinterpret_cast<uintptr_t>(payload) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = stage_bytes(items, E);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        rle_walk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  rle_walk_kernel<<<(B + items - 1) / items, 32, smem, stream>>>(
      reinterpret_cast<const uint32_t*>(moves), m, n, payload, B, m_cap,
      n_cap, W, E, items);
  return RTT_LAUNCH_STATUS();
}

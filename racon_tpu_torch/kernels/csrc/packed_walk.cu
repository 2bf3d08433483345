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
// reference's payload, whose batch-wide loop only pads finished items
// (its "real" test always holds for a walk that starts at (m, n)).
//
// Design on the H100: one warp per item, kPackedWarps items a block, so
// that the align stage's chunk at (40960, 4096), 25 items, runs on 25 SMs
// (the first design, one thread an item and 128 to a block, ran it on one
// SM and paid a dependent global load on every step: ~0.19 us a step). The
// walk only moves up the query rows, and the 16 rows of a word-row are W
// contiguous words whose address does not depend on the walk, so the warp
// streams word-rows into a shared-memory ring with cp.async, up to
// kPackedSlots - 1 word-rows ahead of the one it walks. A slot holds a window of L lanes of
// its word-row (kWindowLanes: 128, or the whole row where W is
// narrower), centred on the walk's lane when the copy is issued; a lane
// outside the window is read from global memory, so the window only
// decides speed, never bytes. Every lane computes the same scalar step
// from broadcast reads (as myers_walk.cu does). Inside the matrix each
// link of the walk's chain reads its move word from the ring and is
// either one up or left step or the whole run of diagonal codes below
// it in that word (the count of leading zero 2-bit fields, by clz),
// straight-line code whose branches are rarely taken; the walk along row
// 0 or column 0, which reads no move, comes last in one go. Codes
// gather 16 to a register word, which goes to a staging buffer in shared
// memory; each full buffer (kStageBytes) is copied out by the warp with
// coalesced byte stores, and the warp writes the 0xFF tail with 16-byte
// stores and the escape flag at the end. What bounds it: the latency of
// the walk's chain, one link per diagonal run, up or left step, and one
// ring hand-off per word-row, on the longest item (PERF.md); the window
// streams 512 bytes per 16 rows.
#include "common.cuh"

namespace {

using namespace rtt;

constexpr int kPackedWarps = 1;   // items (warps) per block;
                                  // geometry.PACKED_WALK_WARPS
constexpr int kPackedSlots = 16;  // word-rows in each warp's ring;
                                  // geometry.PACKED_WALK_SLOTS
constexpr int kWindowLanes = 128; // lanes of a word-row a slot holds, at
                                  // most; geometry.PACKED_WALK_LANES
constexpr int kStageBytes = 512;  // payload bytes staged per copy-out;
                                  // geometry.PACKED_WALK_STAGE

// Shared 32-bit words of one warp at L lanes a slot: the ring, the
// staging buffer, a base lane per slot (8.6 KB at most).
__host__ __device__ constexpr int warp_words(int L) {
  return kPackedSlots * L + kStageBytes / 4 + kPackedSlots;
}

// 0xFF into bytes [p0, p1) of out, 16 bytes a lane where aligned.
__device__ __forceinline__ void fill_skip(uint8_t* out, int p0, int p1,
                                          int lane) {
  if (p1 <= p0) return;
  const int head = min(p1 - p0, static_cast<int>(
      (16u - (reinterpret_cast<uintptr_t>(out + p0) & 15u)) & 15u));
  if (lane < head) out[p0 + lane] = 0xFF;
  p0 += head;
  const int nvec = (p1 - p0) >> 4;
  uint4* v = reinterpret_cast<uint4*>(out + p0);
  for (int x = lane; x < nvec; x += 32)
    v[x] = make_uint4(kFull, kFull, kFull, kFull);
  p0 += 16 * nvec;
  if (lane < p1 - p0) out[p0 + lane] = 0xFF;
}

// A lane outside its slot's window, from global memory: rare, so out of
// line, off the common link's code.
__device__ __noinline__ uint32_t load_far(const uint32_t* grow, int k) {
  return __ldg(grow + k);
}

// staged bytes [0, nbytes) to out[p0 ..], one coalesced byte a lane
__device__ __forceinline__ void copy_out(uint8_t* out, int p0,
                                         const uint32_t* stage, int nbytes,
                                         int lane) {
  const uint8_t* src = reinterpret_cast<const uint8_t*>(stage);
  for (int x = lane; x < nbytes; x += 32) out[p0 + x] = src[x];
}

__global__ void __launch_bounds__(32 * kPackedWarps)
packed_walk_kernel(const uint32_t* __restrict__ moves,
                   const int32_t* __restrict__ m,
                   const int32_t* __restrict__ n,
                   uint8_t* __restrict__ payload, int B, int m_cap,
                   int n_cap, int W, int S, int L) {
  extern __shared__ uint4 walk_smem[];
  constexpr int G = kPackedSlots;
  constexpr int SW = kStageBytes / 4;  // code words a staging buffer holds
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * kPackedWarps + warp;
  if (b >= B) return;  // the whole warp: nothing below syncs the block
  uint32_t* ring =
      reinterpret_cast<uint32_t*>(walk_smem) + warp * warp_words(L);
  uint32_t* stage = ring + G * L;
  int* base = reinterpret_cast<int*>(stage + SW);  // first lane of a slot
  const int dlo = n_cap - m_cap - W / 2;
  const int rows = m_cap / 16;
  const uint32_t* mv_b = moves + static_cast<size_t>(b) * rows * W;
  uint8_t* out = payload + static_cast<size_t>(b) * (S / 4 + 1);
  int i = m[b];
  int j = n[b];
  int k = j - i - dlo;

  // word-row r into its slot, the window centred on the walk's lane now,
  // as one commit group (empty for r outside the moves, so that every
  // group counts)
  auto fetch = [&](int r) {
    if (r >= 0 && r < rows) {
      const int slot = r & (G - 1);
      const int lo = min(max(k - L / 2, 0), W - L) & ~3;
      if (lane == 0) base[slot] = lo;
      const char* src = reinterpret_cast<const char*>(
          mv_b + static_cast<size_t>(r) * W + lo);
      char* dst = reinterpret_cast<char*>(ring + slot * L);
      for (int x = lane; x < L / 4; x += 32)
        cp_async16(dst + 16 * x, src + 16 * x);
    }
    cp_async_commit();
  };
  const int rtop = i >= 1 ? (i - 1) >> 4 : 0;
  for (int g = 0; g < G - 1; ++g) fetch(rtop - g);

  bool esc = false;
  int s = 0;
  uint32_t acc = 0;  // codes of steps 16 (s >> 4) .. s - 1
  // code word wi is complete: stage it, and copy out a full buffer
  auto emit = [&](int wi) {
    if (lane == 0) stage[wi & (SW - 1)] = acc;
    acc = 0;
    if ((wi & (SW - 1)) == SW - 1) {
      __syncwarp();
      copy_out(out, 4 * (wi - (SW - 1)), stage, kStageBytes, lane);
      __syncwarp();
    }
  };
  for (int r = rtop; r >= 0; --r) {
    __syncwarp();  // every lane is done with the slot fetch() replaces
    fetch(r - (G - 1));
    cp_async_wait<G - 1>();
    __syncwarp();  // word-row r is in its slot for every lane
    const uint32_t* slot = ring + (r & (G - 1)) * L;
    const int lo = base[r & (G - 1)];
    const uint32_t* grow = mv_b + static_cast<size_t>(r) * W;
    // the interior steps whose row i - 1 lies in word-row r: each link of
    // the chain a run of diagonal codes or one up or left step
    while (i > 16 * r && j > 0 && s < S) {
      if (static_cast<unsigned>(k) >= static_cast<unsigned>(W)) {
        esc = true;  // this step and all later ones are skips
        goto walked;
      }
      const int off = k - lo;
      uint32_t word;
      if (static_cast<unsigned>(off) < static_cast<unsigned>(L))
        word = slot[off];
      else
        word = load_far(grow, k);
      // the code of row i - 1 in bits 31:30, the word's lower rows below
      // it and ones under them, so that clz counts the run of 00 fields
      const int sh = 2 * ((i - 1) & 15);
      const uint32_t x = (word << (30 - sh)) | ((1u << (30 - sh)) - 1u);
      const int mv = static_cast<int>(x >> 30);
      if (mv == 3) {
        esc = true;
        goto walked;
      }
      // a diagonal run stops at column 0 or the step budget
      const int n = mv ? 1 : min(__clz(x) >> 1, min(j, S - s));
      acc |= static_cast<uint32_t>(mv) << (2 * (s & 15));
      if (((s + n) >> 4) != (s >> 4)) emit(s >> 4);
      s += n;
      i -= mv == 2 ? 0 : n;
      j -= mv == 1 ? 0 : n;
      k += (mv == 1) - (mv == 2);
    }
    if (i == 0 || j == 0 || s >= S) break;
  }
  {
    // row 0: left steps to the origin; column 0: up steps
    const int c = j == 0 ? 1 : 2;
    int n = min(j == 0 ? i : j, S - s);
    if (c == 1)
      i -= n;
    else
      j -= n;
    for (; n > 0; --n) {
      acc |= static_cast<uint32_t>(c) << (2 * (s & 15));
      if ((s & 15) == 15) emit(s >> 4);
      ++s;
    }
  }
walked:
  cp_async_wait<0>();
  {
    // the staged words not yet copied out, the last one padded with skips,
    // then skips up to byte S/4 and the flag
    const int wi = s >> 4;
    const int p0 = 4 * (wi & ~(SW - 1));
    int p1 = 4 * wi;
    if (s & 15) {
      if (lane == 0) stage[wi & (SW - 1)] = acc | (kFull << (2 * (s & 15)));
      p1 = min(p1 + 4, S / 4);
    }
    __syncwarp();
    copy_out(out, p0, stage, p1 - p0, lane);
    fill_skip(out, p1, S / 4, lane);
    if (lane == 0) out[S / 4] = (esc || i != 0 || j != 0) ? 1 : 0;
  }
}

}  // namespace

// moves (B, m_cap/16, W) i32 from rtt_nw_sweep, m/n (B,) i32 ->
// payload (B, S/4 + 1) u8: the packed step stream, then the escape flag.
// Requires S % 4 == 0 and W a multiple of 32 up to 4096 (every band the
// sweep takes); geometry.packed_walk_launch gives the launch.
extern "C" int rtt_packed_walk(const int32_t* moves, const int32_t* m,
                               const int32_t* n, uint8_t* payload, int B,
                               int m_cap, int n_cap, int W, int S,
                               cudaStream_t stream) {
  if (B == 0) return 0;
  if (W <= 0 || W % 32 || W > 4096 || S % 4)
    return static_cast<int>(cudaErrorInvalidValue);
  const int L = W < kWindowLanes ? W : kWindowLanes;
  const size_t smem = static_cast<size_t>(kPackedWarps) * warp_words(L) * 4;
  const int blocks = (B + kPackedWarps - 1) / kPackedWarps;
  packed_walk_kernel<<<blocks, 32 * kPackedWarps, smem, stream>>>(
      reinterpret_cast<const uint32_t*>(moves), m, n, payload, B, m_cap,
      n_cap, W, S, L);
  return RTT_LAUNCH_STATUS();
}

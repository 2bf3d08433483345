// The rows walk (K6) with a producer warp beside each walking warp: the
// counterpart of kernels/csrc/rows_walk.cu that benchmarks/kernel_ab.py
// times against it (give it this directory as OTHER_CSRC; the other
// sources come from the checkout). Same C signature and payload, byte
// for byte.
//
// Per item two warps: the producer streams word-rows into a 4-slot
// cp.async ring and turns every 32-lane group of each into bit planes
// (four groups at a time), into one of two plane slots; the walker takes the
// Myers walk's mask/clz row step on those planes and never transposes,
// so that the transposes leave the walk's chain. They hand the plane
// slots over by named barriers: "full" (the producer arrives, the
// walker waits) and "empty" (the other way), one pair per slot and item.
// Both warps pass the same barriers for every word-row from the top
// one down to 0, also after an escape (the walker then only passes
// them, the producer skips its copies and transposes), so every barrier
// phase is completed before the block ends.
#include "common.cuh"

namespace {

using namespace rtt;

constexpr int kItems = 2;      // items a block, two warps each
constexpr int kRowsSlots = 4;  // word-rows in each item's cp.async ring

__device__ __forceinline__ void bar_sync(int id) {
  asm volatile("bar.sync %0, 64;\n" ::"r"(id) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id) {
  asm volatile("bar.arrive %0, 64;\n" ::"r"(id) : "memory");
}

// transpose32 of four groups in step, so that their shuffles overlap (the
// compiler keeps shuffles in program order, so four transpose32 calls in
// a row would be four chains of five dependent shuffles)
__device__ __forceinline__ void transpose32x4(uint32_t (&x)[4], int lane) {
  const uint32_t masks[5] = {0x0000FFFFu, 0x00FF00FFu, 0x0F0F0F0Fu,
                             0x33333333u, 0x55555555u};
#pragma unroll
  for (int step = 0, s = 16; step < 5; ++step, s >>= 1) {
    const uint32_t mk = masks[step];
    uint32_t y[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) y[q] = __shfl_xor_sync(kFull, x[q], s);
#pragma unroll
    for (int q = 0; q < 4; ++q)
      x[q] = (lane & s) ? ((x[q] & ~mk) | ((y[q] >> s) & mk))
                        : ((x[q] & mk) | ((y[q] & mk) << s));
  }
}

// The exit of a row whose fast step failed: kvec out of the band, or no
// "not LEFT" lane at or below kvec in its group; looks at most two
// groups further down (the 63-deletion limit). k_exit << 2 | code, or -1.
__device__ __noinline__ int step_slow(const uint32_t* planes, int W,
                                      int kvec, int kz, int r) {
  if (static_cast<unsigned>(kvec) >= static_cast<unsigned>(W)) return -1;
  const int w = kvec >> 5;
  for (int gw = w; gw >= 0 && gw >= w - 2; --gw) {
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
      return (32 * gw + pos) << 2 | code;
    }
  }
  return -1;
}

__global__ void __launch_bounds__(64 * kItems)
rows_walk_kernel(const uint32_t* __restrict__ moves,
                 const int32_t* __restrict__ m,
                 const int32_t* __restrict__ n,
                 uint8_t* __restrict__ payload, int B, int m_cap, int n_cap,
                 int W) {
  extern __shared__ uint4 rows_smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int slot_item = warp >> 1;
  const bool producer = warp & 1;
  const int b = blockIdx.x * kItems + slot_item;
  if (b >= B) return;  // both warps of the item: no barrier of it is used
  const int nw = W >> 5;
  const int dlo = n_cap - m_cap - W / 2;
  uint32_t* ring = reinterpret_cast<uint32_t*>(rows_smem) +
                   slot_item * ((kRowsSlots + 2) * W + 4);
  uint32_t* planes = ring + kRowsSlots * W;  // two slots of W words
  // set by the walker once it escapes (four words keep the next item's
  // ring 16-byte aligned)
  volatile int* stop = reinterpret_cast<int*>(planes + 2 * W);
  const int full = 1 + 4 * slot_item;  // barriers full + q, empty + q
  const int empty = full + 2;
  const uint32_t* mv_b = moves + static_cast<size_t>(b) * (m_cap / 16) * W;
  const int top = min(max(m[b], 0), m_cap);
  const int gtop = top >= 1 ? (top - 1) >> 4 : -1;

  if (producer) {
    // word-row g into its ring slot as one commit group (empty for g < 0)
    auto fetch = [&](int g) {
      if (g >= 0) {
        const char* src =
            reinterpret_cast<const char*>(mv_b + static_cast<size_t>(g) * W);
        char* dst =
            reinterpret_cast<char*>(ring + (g & (kRowsSlots - 1)) * W);
        for (int x = lane; x < W / 4; x += 32)
          cp_async16(dst + 16 * x, src + 16 * x);
      }
      cp_async_commit();
    };
    for (int q = 0; q < kRowsSlots - 1; ++q) fetch(gtop - q);
    for (int t = 0, g = gtop; g >= 0; ++t, --g) {
      if (t >= 2) bar_sync(empty + (t & 1));  // the walker left slot t & 1
      const bool halt = t >= 2 && *stop;
      __syncwarp();  // every lane is done with the slot fetch() replaces
      fetch(halt ? -1 : g - (kRowsSlots - 1));
      cp_async_wait<kRowsSlots - 1>();
      __syncwarp();  // word-row g is in its slot for every lane
      if (!halt) {
        const uint32_t* raw = ring + (g & (kRowsSlots - 1)) * W;
        uint32_t* pl = planes + (t & 1) * W;
        for (int w = 0; w < nw; w += 4) {
          uint32_t x[4];
#pragma unroll
          for (int q = 0; q < 4; ++q)
            x[q] = w + q < nw ? raw[32 * (w + q) + lane] : 0u;
          transpose32x4(x, lane);
#pragma unroll
          for (int q = 0; q < 4; ++q)
            if (w + q < nw) pl[32 * (w + q) + lane] = x[q];
        }
      }
      bar_arrive(full + (t & 1));
    }
    cp_async_wait<0>();
    return;
  }

  uint8_t* out = payload + static_cast<size_t>(b) * (m_cap + 2);
  int kvec = n[b] - m[b] - dlo;
  if (lane == 0) *stop = 0;
  // records above row top are 0
  for (int x = ((top + 31) & ~31) + lane; x < m_cap; x += 32) out[x] = 0;
  bool esc = false;
  uint32_t rec = 0;  // lane r: the record of row 32g + r + 1
  int i = top;
  for (int t = 0, g = gtop; g >= 0; ++t, --g) {
    bar_sync(full + (t & 1));  // word-row g's planes are in slot t & 1
    if (!esc) {
      const uint32_t* pl = planes + (t & 1) * W;
#pragma unroll
      for (int r = 15; r >= 0; --r) {
        i = 16 * g + r + 1;
        if (i > top) continue;
        const int kz = -(i + dlo);  // the lane of column 0
        const int w = min(static_cast<unsigned>(kvec) >> 5,
                          static_cast<unsigned>(nw - 1));
        const uint2 p = *reinterpret_cast<const uint2*>(pl + 32 * w + 2 * r);
        const uint32_t oh = onehot(kz, w);
        const uint32_t nl =
            (~p.y | p.x | oh) & (kFull >> (31 - (kvec & 31)));
        const uint32_t upm = (p.x & ~p.y) | oh;
        const uint32_t out3 = p.x & p.y & ~oh;
        int k_exit, up;
        if (nl && static_cast<unsigned>(kvec) < static_cast<unsigned>(W)) {
          const int pos = 31 - __clz(nl);
          if (out3 >> pos & 1u) {
            esc = true;  // sticky; kvec keeps its lane
            break;
          }
          k_exit = 32 * w + pos;
          up = static_cast<int>(upm >> pos & 1u);
        } else {
          const int pk = step_slow(pl, W, kvec, kz, r);
          if (pk < 0 || (pk & 3) == 3) {
            esc = true;
            break;
          }
          k_exit = pk >> 2;
          up = (pk & 3) == 1;
        }
        const uint32_t val =
            (up ? kRecUp : kRecDiag) | ((kvec - k_exit) << 2);
        rec = lane == ((i - 1) & 31) ? val : rec;
        kvec = k_exit + up;
      }
      if (esc) {
        // the escaping row's group (rows above it walked), then 0 below
        const int g0 = (i - 1) & ~31;
        if (g0 + lane < m_cap) out[g0 + lane] = static_cast<uint8_t>(rec);
        for (int x = lane; x < g0; x += 32) out[x] = 0;
        if (lane == 0) *stop = 1;
      } else if (((16 * g) & 31) == 0) {
        if (16 * g + lane < m_cap)
          out[16 * g + lane] = static_cast<uint8_t>(rec);
        rec = 0;
      }
    }
    if (g >= 2) bar_arrive(empty + (t & 1));  // the producer may refill
  }
  if (lane == 0) {
    const int jfin = dlo + kvec;
    if (jfin < 0 || jfin > 255) esc = true;
    out[m_cap] = static_cast<uint8_t>(min(max(jfin, 0), 255));
    out[m_cap + 1] = esc ? 1 : 0;
  }
}

}  // namespace

extern "C" int rtt_rows_walk(const int32_t* moves, const int32_t* m,
                             const int32_t* n, uint8_t* payload, int B,
                             int m_cap, int n_cap, int W,
                             cudaStream_t stream) {
  if (B == 0) return 0;
  if (W <= 0 || W % 32 || W > 4096)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem =
      static_cast<size_t>(kItems) * ((kRowsSlots + 2) * W + 4) * 4;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        rows_walk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int blocks = (B + kItems - 1) / kItems;
  rows_walk_kernel<<<blocks, 64 * kItems, smem, stream>>>(
      reinterpret_cast<const uint32_t*>(moves), m, n, payload, B, m_cap,
      n_cap, W);
  return RTT_LAUNCH_STATUS();
}

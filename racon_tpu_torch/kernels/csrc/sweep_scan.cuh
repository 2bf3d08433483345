// The scored sweeps' inclusive max-plus prefix scans over the band lanes:
// the block scan of nw_sweep.cu's block kernel (K2/K5) and nw_sweep_t.cu
// (K7/K8), so that the ablation of K7 times the block design of K1, and
// the warp-only scan of nw_sweep.cu's warp kernel (K1, W <= 256).
#pragma once

#include <climits>

#include "common.cuh"

namespace rtt {

__device__ __forceinline__ int warp_incl_max(int v, int lane) {
#pragma unroll
  for (int s = 1; s < 32; s <<= 1) {
    int o = __shfl_up_sync(kFull, v, s);
    if (lane >= s) v = max(v, o);
  }
  return v;
}

// In place, a[u] becomes the max of a over every band lane at or below
// lane LPT*t + u of the block (thread t owns lanes LPT*t .. LPT*t+LPT-1):
// a serial max over the thread's lanes, a warp shuffle scan of the thread
// totals, then one pass over the warp totals in wtot[32] (shared memory),
// behind one block barrier. Every thread of the block must call it.
template <int LPT>
__device__ __forceinline__ void block_incl_max(int (&a)[LPT], int lane,
                                               int warp, int32_t* wtot) {
#pragma unroll
  for (int u = 1; u < LPT; ++u) a[u] = max(a[u], a[u - 1]);

  const int incl = warp_incl_max(a[LPT - 1], lane);
  if (lane == 31) wtot[warp] = incl;
  __syncthreads();
  int carry = INT_MIN;
  for (int w = 0; w < warp; ++w) carry = max(carry, wtot[w]);
  if (LPT == 1) {
    a[0] = max(incl, carry);
  } else {
    const int excl = __shfl_up_sync(kFull, incl, 1);
    const int pre = max(lane ? excl : INT_MIN, carry);
#pragma unroll
    for (int u = 0; u < LPT; ++u) a[u] = max(a[u], pre);
  }
}

// In place, a[u] becomes the max of a over every band lane at or below
// lane LPT*lane + u of the warp (the whole band lies in one warp): a
// serial max over the thread's lanes, the warp shuffle scan of the thread
// totals, then the exclusive prefix by one more shuffle. No shared memory
// and no barrier. Every lane of the warp must call it.
template <int LPT>
__device__ __forceinline__ void warp_lanes_incl_max(int (&a)[LPT],
                                                    int lane) {
#pragma unroll
  for (int u = 1; u < LPT; ++u) a[u] = max(a[u], a[u - 1]);

  const int incl = warp_incl_max(a[LPT - 1], lane);
  if (LPT == 1) {
    a[0] = incl;
  } else {
    const int excl = __shfl_up_sync(kFull, incl, 1);
    if (lane) {
#pragma unroll
      for (int u = 0; u < LPT; ++u) a[u] = max(a[u], excl);
    }
  }
}

}  // namespace rtt

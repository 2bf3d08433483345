// Issue-rate probe of the 32-bit and packed 16x2 integer instructions the
// int16 sweeps (kernels/csrc/nw_sweep16.cu) are built from. Each thread
// runs kChains chains of one operation for `iters` rounds, chain k taking
// chain k + 1's value as its second operand (so that no chain of an
// idempotent operation folds away), enough independent work for the loop
// to be bound by issue throughput, not latency; the host side
// (simd16_rate.py) divides the instructions by the CUDA-event time.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kChains = 8;

template <int OP>
__device__ __forceinline__ uint32_t step(uint32_t a, uint32_t b,
                                         uint32_t c) {
  if constexpr (OP == 0) return a + b;                         // IADD3
  if constexpr (OP == 1) return static_cast<uint32_t>(
      max(static_cast<int>(a), static_cast<int>(b)));         // IMNMX
  if constexpr (OP == 2) return __vadd2(a, b);
  if constexpr (OP == 3) return __vsub2(a, b);
  if constexpr (OP == 4) return __vmaxs2(a, b);
  if constexpr (OP == 5) return __vminu2(a, b);
  if constexpr (OP == 6) return __vcmpeq2(a, b) ^ a;
  if constexpr (OP == 7) return __viaddmax_s16x2(a, b, c);
  if constexpr (OP == 8) return __vimax3_s16x2(a, b, c);
  if constexpr (OP == 9) return static_cast<uint32_t>(__viaddmax_s32(
      static_cast<int>(a), static_cast<int>(b), static_cast<int>(c)));
  if constexpr (OP == 10) return __byte_perm(a, b, 0x5432);
  if constexpr (OP == 11) return (a ^ b) & c;                  // LOP3
  return a;
}

template <int OP>
__global__ void rate_kernel(uint32_t* out, uint32_t b, uint32_t c,
                            int iters) {
  uint32_t acc[kChains];
#pragma unroll
  for (int k = 0; k < kChains; ++k) acc[k] = threadIdx.x * 2654435761u + k;
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int k = 0; k < kChains; ++k)
      acc[k] = step<OP>(acc[k], acc[(k + 1) % kChains] ^ b, c);
  }
  uint32_t x = 0;
#pragma unroll
  for (int k = 0; k < kChains; ++k) x ^= acc[k];
  out[blockIdx.x * blockDim.x + threadIdx.x] = x;
}

template <int OP>
float run(uint32_t* out, int blocks, int threads, int iters) {
  cudaEvent_t e0, e1;
  cudaEventCreate(&e0);
  cudaEventCreate(&e1);
  rate_kernel<OP><<<blocks, threads>>>(out, 0x00030005u, 0x80008000u, iters);
  cudaEventRecord(e0);
  rate_kernel<OP><<<blocks, threads>>>(out, 0x00030005u, 0x80008000u, iters);
  cudaEventRecord(e1);
  cudaEventSynchronize(e1);
  float ms = 0.f;
  cudaEventElapsedTime(&ms, e0, e1);
  cudaEventDestroy(e0);
  cudaEventDestroy(e1);
  return cudaGetLastError() == cudaSuccess ? ms : -1.f;
}

}  // namespace

extern "C" int rtt_rate_ops() { return 12; }
extern "C" int rtt_rate_chains() { return kChains; }

// milliseconds of one launch of operation `op` (a warm-up launch first);
// out holds blocks * threads words. -1 on a launch error.
extern "C" float rtt_rate(int op, uint32_t* out, int blocks, int threads,
                          int iters) {
  switch (op) {
    case 0: return run<0>(out, blocks, threads, iters);
    case 1: return run<1>(out, blocks, threads, iters);
    case 2: return run<2>(out, blocks, threads, iters);
    case 3: return run<3>(out, blocks, threads, iters);
    case 4: return run<4>(out, blocks, threads, iters);
    case 5: return run<5>(out, blocks, threads, iters);
    case 6: return run<6>(out, blocks, threads, iters);
    case 7: return run<7>(out, blocks, threads, iters);
    case 8: return run<8>(out, blocks, threads, iters);
    case 9: return run<9>(out, blocks, threads, iters);
    case 10: return run<10>(out, blocks, threads, iters);
    case 11: return run<11>(out, blocks, threads, iters);
    default: return -1.f;
  }
}

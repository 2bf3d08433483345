// Shared constants and helpers of the port's hand-written Hopper kernels.
// Every kernel here is bit-exact against its TPU counterpart in
// racon_tpu/ops; the constants mirror racon_tpu_torch/ops/geometry.py.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace rtt {

constexpr int kPad = 5;             // PAD_CODE
constexpr int kNeg = -100000;       // NEG
constexpr int kScanFill = 2 * kNeg; // fill of the max-plus prefix scan
constexpr int kRleUp = 201;
constexpr int kRleLeft = 202;
constexpr int kRecDiag = 1;
constexpr int kRecUp = 2;
constexpr unsigned kFull = 0xffffffffu;

// 4-bit code at position pos of a nibble-packed row (low nibble first)
__device__ __forceinline__ int nib(const uint8_t* row, int pos) {
  return (row[pos >> 1] >> (4 * (pos & 1))) & 15;
}

// bits >= pos of word w of a multi-word bit vector (pos <= 0 -> all)
__device__ __forceinline__ uint32_t mask_ge(int pos, int w) {
  int sh = pos - 32 * w;
  if (sh <= 0) return kFull;
  if (sh >= 32) return 0u;
  return kFull << sh;
}

// the single bit at pos, if it falls in word w
__device__ __forceinline__ uint32_t onehot(int pos, int w) {
  int rel = pos - 32 * w;
  return (rel >= 0 && rel < 32) ? (1u << rel) : 0u;
}

}  // namespace rtt

// Launchers return the launch status without clearing it, so the PyTorch
// binding's C10_CUDA_KERNEL_LAUNCH_CHECK() (or the ctypes caller) sees it.
#define RTT_LAUNCH_STATUS() static_cast<int>(cudaPeekAtLastError())

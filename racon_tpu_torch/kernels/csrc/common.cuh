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

// 16 bytes from global to shared memory by cp.async (L2 only), in the
// current commit group
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N of this thread's commit groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Lane j holds row j of a 32 x 32 bit matrix (bit t = column t); returns
// column `lane` (bit j = row j's bit lane). Block transposes of halving
// size: at step s, lanes that differ in bit s swap their off-diagonal
// s x s blocks. Every lane of the warp must take part.
__device__ __forceinline__ uint32_t transpose32(uint32_t x, int lane) {
  const uint32_t masks[5] = {0x0000FFFFu, 0x00FF00FFu, 0x0F0F0F0Fu,
                             0x33333333u, 0x55555555u};
#pragma unroll
  for (int step = 0, s = 16; step < 5; ++step, s >>= 1) {
    const uint32_t mk = masks[step];
    const uint32_t y = __shfl_xor_sync(kFull, x, s);
    x = (lane & s) ? ((x & ~mk) | ((y >> s) & mk))
                   : ((x & mk) | ((y & mk) << s));
  }
  return x;
}

constexpr int kSweepRing = 2;  // rows in each warp's hand-off rings of the
                                // strip sweeps; geometry.SWEEP_RING
static_assert((kSweepRing & (kSweepRing - 1)) == 0, "a power of two");

// One hand-off slot of the strip sweeps (nw_sweep.cu, nw_sweep16.cu): the
// row in the high word, the value in the low, one 64-bit access, so that a
// reader never sees a row with another row's value and needs no fence.
__device__ __forceinline__ void publish(unsigned long long* slot, int row,
                                        int v) {
  *reinterpret_cast<volatile unsigned long long*>(slot) =
      (static_cast<unsigned long long>(row) << 32) | static_cast<uint32_t>(v);
}

// The value of `slot` once its row is `row` or later, read by the whole
// warp; a warp that finds it not yet written sleeps (a back-off up to
// 256 ns), so that it takes no issue slots from the working warps. A build
// with -DRTT_WAIT_POLLS=n traps after n polls, so that a hand-off fault
// ends the launch instead of hanging the card.
__device__ __forceinline__ int await_row(const unsigned long long* slot,
                                         int row) {
  const volatile unsigned long long* p = slot;
  unsigned long long v = *p;
  unsigned ns = 8;
#ifdef RTT_WAIT_POLLS
  long long polls = 0;
#endif
  while (!__all_sync(kFull, static_cast<int>(v >> 32) >= row)) {
#ifdef RTT_WAIT_POLLS
    if (++polls > RTT_WAIT_POLLS) __trap();
#endif
    __nanosleep(ns);
    ns = min(2 * ns, 256u);
    v = *p;
  }
  return static_cast<int>(static_cast<uint32_t>(v));
}

}  // namespace rtt

// Launchers return the launch status without clearing it, so the PyTorch
// binding's C10_CUDA_KERNEL_LAUNCH_CHECK() (or the ctypes caller) sees it.
#define RTT_LAUNCH_STATUS() static_cast<int>(cudaPeekAtLastError())

// Device-side row gather of the consensus stage's gather route (J6).
//
// Replaces the row gathers of racon_tpu/ops/nw_kernel.py's device-gather
// form: _gather_nib_cols (:1476) and _gather_bit_cols (:1510), which
// align_walk_gather_core_t / _rle_t / _rows_t (:1533, :1563, :2107) run
// before their sweep, and the lane-major _gather_nib_rows (:1408) and
// _gather_bit_rows (:1424). Each item's query row, target row and
// deletion-cost bits are cut from blobs that went up to the device once
// (the cohort's layers; the pass's backbones and deletion costs) by the
// item's meta row [q_start, m, t_start, n], and written in the packed
// layout the host packers write (bindings.pack_rows_nib /
// pack_rows_bits): nibble codes, PAD_CODE beyond m or n; bits, set beyond
// n. The sweep and walk that follow run unchanged on these rows.
//
// Blobs are little-endian int32 words: element e of a code blob is in word
// e >> 3 at bits 4 (e & 7), of the deletion-cost blob in word e >> 5 at
// bit e & 31. The bit blob is indexed by word, as _gather_bit_cols does,
// not by byte as _gather_bit_rows does (the reference's fault C1: its
// stage uploads that blob as words).
//
// Design on the H100: one thread per 32-bit output word (8 codes or 32
// bits). A thread reads the two blob words its elements straddle and
// realigns them with one funnel shift (the reference's word fetch plus
// funnel, nw_kernel.py:1490-1500), then masks in the fill past the row's
// length. Consecutive threads write consecutive words of a row, and rows
// of one output follow each other, so every warp's store is coalesced; the
// loads of neighbouring threads share their words through L1. What bounds
// it: bytes (each output word written once, about as many read); at the
// consensus tiers a launch moves a few MB, so launch latency dominates.
#include "common.cuh"

namespace {

using namespace rtt;

constexpr uint32_t kPadWord = 0x55555555u;  // eight PAD_CODE nibbles
constexpr int kThreads = 256;

// The 32 bits of a blob from bit `pos` on (words past the blob read 0).
__device__ __forceinline__ uint32_t fetch(const uint32_t* __restrict__ blob,
                                          long long nwords, long long pos) {
  const long long s = pos >> 5;
  const uint32_t lo = s < nwords ? __ldg(blob + s) : 0u;
  const uint32_t hi = s + 1 < nwords ? __ldg(blob + s + 1) : 0u;
  return __funnelshift_r(lo, hi, static_cast<int>(pos & 31));
}

// Output word w of a code row: elements start + 8w .. start + 8w + 7,
// PAD_CODE from element len of the row on.
__device__ __forceinline__ uint32_t nib_word(const uint32_t* __restrict__ blob,
                                             long long nwords, int start,
                                             int len, int w) {
  const int rel = len - 8 * w;
  if (rel <= 0) return kPadWord;
  const uint32_t v = fetch(blob, nwords, 4 * (start + 8LL * w));
  if (rel >= 8) return v;
  const uint32_t keep = (1u << (4 * rel)) - 1u;
  return (v & keep) | (kPadWord & ~keep);
}

// Output word w of a deletion-cost row: bits start + 32w .. + 31, set
// from bit len of the row on.
__device__ __forceinline__ uint32_t bit_word(const uint32_t* __restrict__ blob,
                                             long long nwords, int start,
                                             int len, int w) {
  const int rel = len - 32 * w;
  if (rel <= 0) return kFull;
  const uint32_t v = fetch(blob, nwords, start + 32LL * w);
  if (rel >= 32) return v;
  return v | ~((1u << rel) - 1u);
}

// Threads 0 .. B*wq - 1 write q4's words, the next B*wt t4's, the last
// B*wd dcb's; each output is (B, words a row) row-major.
__global__ void __launch_bounds__(kThreads)
    pack_gather_kernel(const uint32_t* __restrict__ qb, long long nq,
                       const uint32_t* __restrict__ tb, long long nt,
                       const uint32_t* __restrict__ db, long long nd,
                       const int32_t* __restrict__ meta,
                       uint32_t* __restrict__ q4, uint32_t* __restrict__ t4,
                       uint32_t* __restrict__ dcb, int B, int wq, int wt,
                       int wd) {
  long long idx = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  const long long nqw = static_cast<long long>(B) * wq;
  const long long ntw = static_cast<long long>(B) * wt;
  const long long ndw = static_cast<long long>(B) * wd;
  if (idx < nqw) {
    const int b = static_cast<int>(idx / wq);
    q4[idx] = nib_word(qb, nq, meta[4 * b], meta[4 * b + 1],
                       static_cast<int>(idx % wq));
    return;
  }
  idx -= nqw;
  if (idx < ntw) {
    const int b = static_cast<int>(idx / wt);
    t4[idx] = nib_word(tb, nt, meta[4 * b + 2], meta[4 * b + 3],
                       static_cast<int>(idx % wt));
    return;
  }
  idx -= ntw;
  if (idx < ndw) {
    const int b = static_cast<int>(idx / wd);
    dcb[idx] = bit_word(db, nd, meta[4 * b + 2], meta[4 * b + 3],
                        static_cast<int>(idx % wd));
  }
}

}  // namespace

// q4 (B, m_cap/2), t4 (B, n_cap/2), dcb (B, n_cap/8) uint8 from the word
// blobs qb (nq words), tb (nt), db (nd) and meta (B, 4) int32. m_cap a
// multiple of 8, n_cap of 32 (checked by the bindings).
extern "C" int rtt_pack_gather(const int32_t* qb, int nq, const int32_t* tb,
                               int nt, const int32_t* db, int nd,
                               const int32_t* meta, uint8_t* q4, uint8_t* t4,
                               uint8_t* dcb, int B, int m_cap, int n_cap,
                               cudaStream_t stream) {
  const int wq = m_cap / 8, wt = n_cap / 8, wd = n_cap / 32;
  const long long total = static_cast<long long>(B) * (wq + wt + wd);
  if (total == 0) return 0;
  const long long blocks = (total + kThreads - 1) / kThreads;
  pack_gather_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      reinterpret_cast<const uint32_t*>(qb), nq,
      reinterpret_cast<const uint32_t*>(tb), nt,
      reinterpret_cast<const uint32_t*>(db), nd, meta,
      reinterpret_cast<uint32_t*>(q4), reinterpret_cast<uint32_t*>(t4),
      reinterpret_cast<uint32_t*>(dcb), B, wq, wt, wd);
  return RTT_LAUNCH_STATUS();
}

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
// stage uploads that blob as words). Output word w of a row is then blob
// words s + w and s + w + 1 funnel-shifted right by sh, where s and sh
// (the row's word offset and shift: start >> 3 and 4 (start & 7) for
// nibbles, start >> 5 and start & 31 for bits) hold for the whole row.
//
// What bounds it on the H100: bytes (each output word written once, each
// blob word the rows cover read once: 4.9 MB, 1.5 us of HBM at the
// consensus stage's (640,128) B = 4096), and below that a fixed cost: the
// launch, then two dependent loads (an item's meta row, then its blob
// words) before the first store; at a small B only that chain counts.
// The design cuts everything else:
// - a warp is one unit (b, r): item b, and r of the item's units from
//   blockIdx.y, so no division stands before the meta load. A unit holds
//   row segments of its item, grouped as gather_mode says (at the
//   consensus tiers its three rows whole: one wave, 4096 warps at
//   B = 4096, 31 an SM). A segment is at most 32 kJ words; where units of
//   whole rows would give fewer than kFewUnits warps (a small B),
//   segments of 32 words, so that (5120,1024) B = 8 runs 160 warps of a
//   short chain each (geometry.gather_units mirrors the rule);
// - every lane reads the item's meta row at one address: one request a
//   warp, broadcast by the memory system; meta once a unit, not once a
//   word, and no shuffle on the chain;
// - lane l loads blob words s + w0 + l + 32 j of each segment, coalesced,
//   every load of the unit issued before the first is used, each word the
//   segment needs once (no word past the row's last element, none past
//   the blob; those read as 0). The high neighbour of the funnel shift
//   comes from lane l + 1 by shuffle; lane 31 takes lane 0's word of the
//   next j, and the segment's last word is the one load past its outputs;
// - lane l stores output words w0 + l + 32 j: 128-byte warp stores, the
//   PAD nibbles or set bits past m or n masked in by one clamped funnel
//   shift;
// - 32-bit index math (blobs are under 2^31 words; a row's output base is
//   the one 64-bit product a segment).
#include <algorithm>

#include "common.cuh"

namespace {

using namespace rtt;

constexpr uint32_t kPadWord = 0x55555555u;  // eight PAD_CODE nibbles
constexpr int kJ = 4;         // words a lane loads of a segment, at most;
                              // geometry.GATHER_LANE_WORDS
constexpr int kWarps = 8;     // warps a block, at most;
                              // geometry.GATHER_WARPS
constexpr int kSms = 132;     // SMs of the H100 the block rule counts
constexpr int kFewUnits = 4 * kSms;  // fewer units of whole rows: J = 1;
                                     // geometry.GATHER_FEW_UNITS

// How a unit groups an item's row segments (geometry.GATHER_MODES): a row
// segment alone, the query's apart from the target's with its deletion
// bits, or all three.
enum : int { kRow = 0, kPair = 1, kItem = 2 };

// Lane words of a segment that holds a whole row: the fewest, at most kJ,
// that hold the longer row.
static int whole_row_words(int m_cap, int n_cap) {
  return std::min(kJ, (std::max(m_cap, n_cap) / 8 + 31) / 32);
}

// Whether units of whole rows would give fewer than kFewUnits warps (a
// small B): one warp's chain of dependent loads and instructions then
// sets the time, and shorter warps, more of them, win.
static bool few_units(int m_cap, int n_cap, int B) {
  const int longer = std::max(m_cap, n_cap) / 8;
  const int S = 32 * whole_row_words(m_cap, n_cap);
  return static_cast<long long>(B) * ((longer + S - 1) / S) < kFewUnits;
}

static int gather_mode(int m_cap, int n_cap, int B) {
  return few_units(m_cap, n_cap, B) ? kPair : kItem;
}

// One row segment as lane `lane` sees it: the row's elements start at
// `start` of a blob of `nwords` words, `len` of them, PerWord (8 or 32)
// to a word; the segment is output words [w0, w1) of the row at `row`, J
// lane words (J + 1 load slots: lane 0's last is the next j's first).
template <int PerWord, int J>
struct Seg {
  static constexpr int kWidth = 32 / PerWord;  // bits an element
  static constexpr uint32_t kFill = PerWord == 8 ? kPadWord : kFull;
  const uint32_t* src;  // blob word s + w0 + lane
  uint32_t* dst;        // output word w0 + lane
  int avail;  // slot j loads where 32 j < avail: words the row needs, up
              // to w1 and inside the blob, from the lane's first on
  int outs;   // slot j stores where 32 j < outs (w1 - w0 - lane)
  int rel;    // elements of the row from the lane's first output word on
  int sh;     // the row's shift
  int n;      // w1 - w0, warp-uniform (0: the unit holds no segment here)
  uint32_t lo[J + 1];

  __device__ __forceinline__ Seg(const uint32_t* blob, int nwords, int start,
                                 int len, int w0, int w1, uint32_t* row,
                                 int lane, bool active) {
    constexpr int kShift = PerWord == 8 ? 3 : 5;
    const int s = static_cast<int>(static_cast<uint32_t>(start) >> kShift);
    const int last =
        len > 0 ? static_cast<int>((static_cast<uint32_t>(start) +
                                    static_cast<uint32_t>(len) - 1u) >>
                                   kShift) - s
                : -1;
    sh = (start & (PerWord - 1)) * kWidth;
    n = active ? w1 - w0 : 0;
    avail = active ? min(min(w1, last), nwords - 1 - s) - w0 - lane + 1 : 0;
    outs = w1 - w0 - lane;
    rel = len - PerWord * (w0 + lane);
    src = blob + (s + w0 + lane);
    dst = row + (w0 + lane);
  }

  // Every slot's load at once, coalesced; 0 where the slot holds no word
  // the row needs (past its last element, past w1, past the blob).
  __device__ __forceinline__ void load() {
#pragma unroll
    for (int j = 0; j <= J; ++j)
      lo[j] = 32 * j < avail ? __ldg(src + 32 * j) : 0u;
  }

  // Output words w0 + lane + 32 j < w1: the funnel shift of the lane's
  // word and its high neighbour (lane + 1's; lane 31 takes lane 0's of the
  // next j), the fill masked in past len.
  __device__ __forceinline__ void emit(int lane) {
#pragma unroll
    for (int j = 0; j < J; ++j) {
      if (32 * j >= n) break;  // warp-uniform
      const uint32_t give = lane == 0 ? lo[j + 1] : lo[j];
      const uint32_t hi = __shfl_sync(kFull, give, (lane + 1) & 31);
      const uint32_t v = __funnelshift_r(lo[j], hi, sh);
      // the low bits of the row's elements kept, min(that, 32) by the
      // clamped funnel shift: 0 past len, all of them inside
      const uint32_t keep = __funnelshift_lc(
          kFull, 0u, kWidth * max(rel - 32 * PerWord * j, 0));
      if (32 * j < outs) dst[32 * j] = (v & keep) | (kFill & ~keep);
    }
  }
};

// Unit (b, r): item b = blockIdx.x * warps a block + warp, r =
// blockIdx.y of the item's upi units (no division on the way to the meta
// load): segment kq of the item's query row, kt of its target row, kd of
// its deletion bits, as the mode groups them (-1: none). Segments are
// S = 32 J words (S / 4 of the bit row: the same target elements; one
// lane word, two slots); nq, nt segments a row.
template <int J>
__global__ void __launch_bounds__(32 * kWarps)
    pack_gather_kernel(const uint32_t* __restrict__ qb, int nq_words,
                       const uint32_t* __restrict__ tb, int nt_words,
                       const uint32_t* __restrict__ db, int nd_words,
                       const int32_t* __restrict__ meta,
                       uint32_t* __restrict__ q4, uint32_t* __restrict__ t4,
                       uint32_t* __restrict__ dcb, int B, int wq, int wt,
                       int nq, int nt, int mode) {
  constexpr int S = 32 * J;
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (b >= B) return;  // warp-uniform
  const int r = blockIdx.y;
  int kq = -1, kt = -1, kd = -1;
  if (mode == kItem) {
    kq = r < nq ? r : -1;
    kt = kd = r < nt ? r : -1;
  } else if (r < nq) {
    kq = r;
  } else if (mode == kPair) {
    kt = kd = r - nq;
  } else if (r < nq + nt) {
    kt = r - nq;
  } else {
    kd = r - nq - nt;
  }

  // the meta row, every lane at one address: one request a warp
  const int32_t* mrow = meta + 4 * b;
  const int qs = __ldg(mrow), m = __ldg(mrow + 1);
  const int ts = __ldg(mrow + 2), n = __ldg(mrow + 3);

  const int wd = wt >> 2;
  Seg<8, J> q(qb, nq_words, qs, m, kq * S, min(kq * S + S, wq),
              q4 + static_cast<size_t>(b) * wq, lane, kq >= 0);
  Seg<8, J> t(tb, nt_words, ts, n, kt * S, min(kt * S + S, wt),
              t4 + static_cast<size_t>(b) * wt, lane, kt >= 0);
  Seg<32, 1> d(db, nd_words, ts, n, kd * (S / 4),
               min(kd * (S / 4) + S / 4, wd),
               dcb + static_cast<size_t>(b) * wd, lane, kd >= 0);
  q.load();
  t.load();
  d.load();
  q.emit(lane);
  t.emit(lane);
  d.emit(lane);
}

}  // namespace

// q4 (B, m_cap/2), t4 (B, n_cap/2), dcb (B, n_cap/8) uint8 from the word
// blobs qb (nq words), tb (nt), db (nd) and meta (B, 4) int32. m_cap a
// multiple of 8, n_cap of 32 (checked by the bindings). The unit rule
// (geometry.gather_units): segments of S = 32 J words, J the fewest lane
// words (at most kJ) that hold the longer row whole, grouped as an
// item's three rows; where that gives fewer than kFewUnits units (a small
// B), J = 1 and the query's segments apart from the target's (shorter
// warps, more of them); warps a block halved from kWarps while the units
// would fill fewer than kSms blocks; blockIdx.y the unit of an item.
extern "C" int rtt_pack_gather(const int32_t* qb, int nq, const int32_t* tb,
                               int nt, const int32_t* db, int nd,
                               const int32_t* meta, uint8_t* q4, uint8_t* t4,
                               uint8_t* dcb, int B, int m_cap, int n_cap,
                               cudaStream_t stream) {
  const int wq = m_cap / 8, wt = n_cap / 8;
  const int whole = whole_row_words(m_cap, n_cap);
  const bool few = few_units(m_cap, n_cap, B);
  const int J = few ? 1 : whole;
  const int S = 32 * J;
  const int sq = (wq + S - 1) / S, st = (wt + S - 1) / S;
  const int mode = gather_mode(m_cap, n_cap, B);
  const int upi = mode == kItem ? std::max(sq, st)
                                : sq + (mode == kPair ? st : 2 * st);
  const long long units = static_cast<long long>(B) * upi;
  if (units == 0) return 0;
  int warps = kWarps;
  while (warps > 1 && units < static_cast<long long>(warps) * kSms)
    warps >>= 1;
  const dim3 grid((B + warps - 1) / warps, upi);
  const auto* q = reinterpret_cast<const uint32_t*>(qb);
  const auto* t = reinterpret_cast<const uint32_t*>(tb);
  const auto* d = reinterpret_cast<const uint32_t*>(db);
  auto* q4w = reinterpret_cast<uint32_t*>(q4);
  auto* t4w = reinterpret_cast<uint32_t*>(t4);
  auto* dw = reinterpret_cast<uint32_t*>(dcb);
#define RTT_GATHER(JJ)                                                     \
  pack_gather_kernel<JJ><<<grid, 32 * warps, 0, stream>>>(                 \
      q, nq, t, nt, d, nd, meta, q4w, t4w, dw, B, wq, wt, sq, st, mode)
  switch (J) {
    case 1: RTT_GATHER(1); break;
    case 2: RTT_GATHER(2); break;
    case 3: RTT_GATHER(3); break;
    default: RTT_GATHER(4); break;
  }
#undef RTT_GATHER
  return RTT_LAUNCH_STATUS();
}

// Scored banded linear-gap Needleman-Wunsch sweep with H in int16: the
// RACON_TPU_DP16=1 form of nw_sweep.cu's warp and strip kernels.
//
// Replaces the int16 instantiations of the TPU kernels
// racon_tpu/ops/nw_kernel.py::nw_band_batch_t8 (body _nw_band_kernel_t8)
// and ::nw_band_batch_t8big (body _nw_band_kernel_t8big), which run the
// same DP in int16 where dp16_eligible holds (2 ((m_cap + n_cap) cmax + 64)
// <= 30000): the sentinel is neg = -((m_cap + n_cap) cmax + 64) instead of
// NEG, and the scan's fill -30000 instead of 2 NEG. Moves and score equal
// the int32 sweep's bit for bit; inputs, moves layout and score are those
// of nw_sweep.cu (see its note), so the walks read them unchanged.
//
// Two band lanes share one 32-bit register as an s16x2 pair (lane 2v in
// the low half, 2v + 1 in the high half), and the row step is written in
// the packed 16x2 instructions sm_90a issues natively (cuobjdump -sass:
// __vadd2 as one VIADD.16x2, __vmaxs2 / __vminu2 as one VIMNMX.S16x2 /
// .U16x2, the three-way forms as one VIMNMX3, __viaddmax_s16x2 as one
// VIADDMNMX; __vsub2 with a register operand as two VIADD.16x2 and
// __vcmpeq2 emulated, so neither is used in a row): one instruction does
// the work of two cells. Wrapping 16x2 adds, as the plain version wraps;
// the gate keeps every value in range, so nothing wraps.
//
// nw_sweep16_warp_kernel<TPI, P, W> (W <= 256, K1's tiers): TPI threads
// per item (a warp; a quarter of one, four items a warp, at W = 128:
// geometry.sweep16_tpi), P pairs per thread (thread t owns lanes 2Pt ..
// 2Pt + 2P - 1; lanes from W up to 2 P TPI are pad lanes held at neg),
// everything of a row in registers and shuffles, as nw_sweep.cu's warp
// kernel: one shuffle a row brings the next thread's first column half
// and first H half together, the scan is a serial max over the thread's
// halves, log2(TPI) shuffles over the thread totals and one more for the
// exclusive prefix. H is kept less gc (hg = H - gc[j], the scan's own
// space, as nw_sweep.cu's strip kernel keeps it): diag = hg + (s - d_j)
// with d_j the column's deletion cost, up = above + gap, hg = the scan
// of max(diag, up) with the fill; no gc register, no per-row gc add and
// no a - gc a pair, and the score adds gc[n_cap] once. A lane outside
// the matrix holds neg (the values right of column n_cap never reach a
// lane inside it). Codes: a column half is the target code's one-hot
// byte (A, C, G, T, N bits 0-4; PAD 0xA0, bit 5 and a PAD flag in bit
// 7) | deletion bit << 15, a query row is stored as the shift 7 - code;
// per pair and row: the column slide (one PRMT), equal codes from the
// flag bit that shift brings to bit 7 (SHF, PRMT), PAD from the flag
// (PRMT), the substitution by two LOP3 selects, the deletion cost (PRMT,
// LOP3), diag (two VIADD), max(above + gap, diag) (one VIADDMNMX), the
// scan, and the move [h != diag] + [h != max(diag, up)] (two XOR, two
// VIMNMX, one add) accumulated into a pair word 8 rows at a time by one
// multiply-add. The matrix-edge masks (j == 0, j outside [0, n_cap], pad
// lanes) run only in rows where a lane of the warp touches an edge, the
// row body instantiated twice behind a warp-uniform branch (__any_sync),
// so that the interior rows carry no masks. What bounds it: issue slots
// (~35 SASS instructions a pair and interior row, the row's overhead
// included, against the bound's 7.5) and, with two warps a scheduler at
// B = 4096, the latency of the row's chain of shuffles and scan steps.
// Eight threads an item timed 10 % faster than sixteen, and the
// warp-uniform edge branch 21 % faster than a per-thread one (H100 at
// 700 W, benchmarks/kernel_ab.py in turns).
//
// nw_sweep16_strip_kernel<P> (W = 288 .. 1024, K2's tiers): one block
// per item, made of warp strips, as nw_sweep.cu's strip kernel: warp w
// owns S = 64 P contiguous band lanes, thread t of it P pairs (lanes w S
// + 2 P t ..), the last strip cut at W (its threads past W run the row and
// store nothing: no lane right of W - 1 reaches a lane inside it). Inside
// a strip the row is the warp kernel's row above (H less gc, one-hot codes,
// max(above + gap, diag) as one VIADDMNMX, the edge masks behind a
// warp-uniform branch, the moves gathered 8 rows to a pair word by one
// IMAD, P 16-byte stores every 16 rows). What bounded the block design
// before (one pair a thread, 256 threads at W = 512): two block barriers
// a row (a shared-memory scan of the warp totals and the H exchange), the
// row's overhead over one pair, a gc register updated every row and a
// per-thread edge branch: 0.59x the int32 strip kernel on the same items.
// Here the row loop has no __syncthreads: warp w takes the carry (the
// max over every lane left of its strip, in the scan's space) from warp
// w - 1 and warp w + 1's first-lane H through per-warp shared-memory rings
// of row-tagged 64-bit slots, skewed as in nw_sweep.cu: lane 31's last
// lane leaves its up candidate out of the row and takes it when the next
// row starts (its pair's high half raised, its move added to the pair
// word then; the flush of the words waits for it), so warp w reads warp
// w + 1's H of row i - 2 at row i and the carry never waits on the right
// neighbour; two rows of ring suffice. Pairs a thread by the launch's rule
// (strip16_pairs, geometry.sweep16_pairs): 8 (a warp an item at W = 512,
// no hand-off) where that still puts 4 warps on an SM, then 4, else 2.
// What bounds it: with 8 warps an SM (B = 1024 at W = 512), each warp's
// chain a row (the nb shuffle, the pairs, the five-shuffle scan, the
// carry) that two warps a scheduler cannot hide, at ~37 SASS
// instructions a pair and interior row (against the bound's 7.5): 45 %
// of the issue slots used; with more warps an item, the row's overhead
// over fewer pairs. The hand-off (kSweepRing, publish, await_row) is
// common.cuh's, shared with nw_sweep.cu.
#include <type_traits>

#include "common.cuh"

namespace {

using namespace rtt;

constexpr int kSweep16Warps = 4;      // warps per block of the warp kernel
                                      // (geometry.SWEEP_WARPS)
constexpr uint32_t kMin2 = 0x80008000u;  // -32768 in both halves
constexpr uint32_t kOnes2 = 0x00010001u;
constexpr uint32_t kMoves3 = 0x00030003u;
constexpr int kDp16Fill = -30000;        // the scan's fill (geometry.DP16_FILL)
// the warp kernel's code bytes: a one-hot code (A, C, G, T, N bits 0-4,
// PAD bit 5 and a PAD flag in bit 7) by prmt from these tables, and per
// query row the shift 7 - code that brings the code's bit to bit 7
constexpr uint32_t kOneHotLo = 0x08040201u;  // codes 0-3
constexpr uint32_t kOneHotHi = 0x8040A010u;  // codes 4-7: N, PAD, 6, 7
constexpr uint32_t kShiftLo = 0x04050607u;
constexpr uint32_t kShiftHi = 0x00010203u;
constexpr uint32_t kPadOneHot = 0xA0u;       // PAD in the one-hot bytes
constexpr int kPadShift = 2;                 // 7 - PAD

__device__ __forceinline__ uint32_t prmt(uint32_t a, uint32_t b,
                                         uint32_t s) {
  // PTX prmt in its generic mode: a selector nibble with bit 3 set
  // replicates the sign of the byte it selects
  uint32_t r;
  asm("prmt.b32 %0, %1, %2, %3;" : "=r"(r) : "r"(a), "r"(b), "r"(s));
  return r;
}

__device__ __forceinline__ uint32_t dup16(int v) {
  return (static_cast<uint32_t>(v) & 0xFFFFu) * kOnes2;
}

// the half of pair word x at lane u (0 low, 1 high), sign-extended
__device__ __forceinline__ int half_at(uint32_t x, int u) {
  return u ? static_cast<int>(x) >> 16
           : static_cast<int>(static_cast<int16_t>(x & 0xFFFFu));
}

__device__ __forceinline__ uint32_t set_half(uint32_t x, int u, int v) {
  return u ? (x & 0xFFFFu) | (static_cast<uint32_t>(v) << 16)
           : (x & 0xFFFF0000u) | (static_cast<uint32_t>(v) & 0xFFFFu);
}

// 0xFFFF in each half whose bit 15 is set (the deletion bit of a column
// half)
__device__ __forceinline__ uint32_t high_sign(uint32_t x) {
  return prmt(x, 0, 0xBB99);
}

// deletion bits 0 and 1 of d to bit 15 of each half
__device__ __forceinline__ uint32_t del2(uint32_t d) {
  return ((d & 1u) << 15) | ((d & 2u) << 30);
}

// gc[j] = gap * (set bits among deletion-cost columns 0..j-1); 0 for j <= 0
__device__ int gc_at16(const uint32_t* bits, int j, int n_cap, int gap) {
  if (j <= 0) return 0;
  if (j > n_cap) j = n_cap;
  int c = 0;
  for (int x = 0; x < (j >> 5); ++x) c += __popc(bits[x]);
  if (j & 31) c += __popc(bits[j >> 5] & ((1u << (j & 31)) - 1u));
  return c * gap;
}

// the int16 kernels' column half of target column j: one-hot code |
// deletion bit << 15; PAD without a deletion cost outside the target
__device__ __forceinline__ uint32_t col_oh(const uint16_t* cs, int j,
                                           int n_cap) {
  return (j >= 0 && j < n_cap) ? cs[j] : kPadOneHot;
}

// One item's codes into shared memory for the int16 kernels by `nt` threads
// (t = 0 .. nt-1): the query as one byte a row, the shift 7 - code
// (qs[m_cap]), the target as column halves cs2[n_cap / 2] (two columns a
// word), each the code's one-hot byte | deletion bit << 15. A code nibble
// is itself a prmt selector, so one prmt maps four codes.
__device__ void load_item16_onehot(const uint8_t* q4, const uint8_t* t4,
                                   const uint8_t* dcb, int b, int m_cap,
                                   int n_cap, uint8_t* qs, uint32_t* cs2,
                                   int t, int nt) {
  const uint32_t* qrow = reinterpret_cast<const uint32_t*>(
      q4 + static_cast<size_t>(b) * (m_cap / 2));
  for (int x = t; x < m_cap / 8; x += nt) {
    const uint32_t v = qrow[x];  // rows 8x .. 8x + 7
    *reinterpret_cast<uint2*>(qs + 8 * x) =
        make_uint2(prmt(kShiftLo, kShiftHi, v),
                   prmt(kShiftLo, kShiftHi, v >> 16));
  }
  const uint4* trow =
      reinterpret_cast<const uint4*>(t4 + static_cast<size_t>(b) * (n_cap / 2));
  const uint32_t* drow = reinterpret_cast<const uint32_t*>(
      dcb + static_cast<size_t>(b) * (n_cap / 8));
  for (int x = t; x < n_cap / 32; x += nt) {
    const uint4 v = trow[x];
    const uint32_t bits = drow[x];  // columns 32x .. 32x + 31
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
    uint32_t o[16];
#pragma unroll
    for (int y = 0; y < 4; ++y) {
      const uint32_t e0 = prmt(kOneHotLo, kOneHotHi, w[y]);
      const uint32_t e1 = prmt(kOneHotLo, kOneHotHi, w[y] >> 16);
      o[4 * y] = prmt(e0, 0, 0x4140) | del2(bits >> (8 * y));
      o[4 * y + 1] = prmt(e0, 0, 0x4342) | del2(bits >> (8 * y + 2));
      o[4 * y + 2] = prmt(e1, 0, 0x4140) | del2(bits >> (8 * y + 4));
      o[4 * y + 3] = prmt(e1, 0, 0x4342) | del2(bits >> (8 * y + 6));
    }
    uint4* dst = reinterpret_cast<uint4*>(cs2 + 16 * x);
#pragma unroll
    for (int y = 0; y < 4; ++y)
      dst[y] = make_uint4(o[4 * y], o[4 * y + 1], o[4 * y + 2], o[4 * y + 3]);
  }
}

// The matrix-edge masks of a thread's pairs in row i (lanes k0 .. k0 +
// 2P - 1, columns jb .. jb + 2P - 1): out (0xFFFF where the lane is outside
// [0, n_cap] or a pad lane), zero (where j == 0) and inv (where j is
// outside [1, n_cap] or a pad lane: move 3).
template <int P>
__device__ __forceinline__ void edge_masks(int jb, int k0, int W, int n_cap,
                                           uint32_t (&out)[P],
                                           uint32_t (&zero)[P],
                                           uint32_t (&inv)[P]) {
#pragma unroll
  for (int v = 0; v < P; ++v) {
    out[v] = zero[v] = inv[v] = 0;
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int j = jb + 2 * v + u;
      const bool pad = k0 + 2 * v + u >= W;
      const uint32_t m = 0xFFFFu << (16 * u);
      if (pad || j < 0 || j > n_cap) out[v] |= m;
      if (!pad && j == 0) zero[v] |= m;
      if (pad || j < 1 || j > n_cap) inv[v] |= m;
    }
  }
}

// In place, pair a[v] (low half lane 2v, high half 2v + 1) becomes the max
// over the thread's lanes up to and including each half.
template <int P>
__device__ __forceinline__ void pairs_incl_max(uint32_t (&a)[P]) {
  a[0] = __vmaxs2(a[0], prmt(a[0], 0, 0x1010));
#pragma unroll
  for (int v = 1; v < P; ++v)
    a[v] = __vimax3_s16x2(a[v], prmt(a[v], 0, 0x1010),
                          prmt(a[v - 1], 0, 0x3232));
}

// W = 2 P TPI - (pad lanes) <= 256: TPI threads per item (see the note at
// the top). H is kept less gc, the scan's own space (hg = H - gc[j]): the
// diag candidate adds the substitution less the column's deletion cost,
// the up candidate the gap, and hg is the scan's result; a lane outside
// the matrix holds neg. The minimum of one block a SM frees ptxas from
// its occupancy target, as in nw_sweep.cu's warp kernel.
template <int TPI, int P, int W>
__global__ void __launch_bounds__(32 * kSweep16Warps, 1)
nw_sweep16_warp_kernel(const uint8_t* __restrict__ q4,
                       const uint8_t* __restrict__ t4,
                       const uint8_t* __restrict__ dcb,
                       int32_t* __restrict__ moves,
                       int32_t* __restrict__ score, int B, int m_cap,
                       int n_cap, int match, int mismatch, int gap, int span,
                       int neg) {
  constexpr int IPW = 32 / TPI;   // items per warp
  constexpr int L = 2 * P;        // lanes per thread
  constexpr int WP = TPI * L;     // lanes with the pad lanes
  static_assert(WP >= W && WP - W < 64, "at most one pad pair a thread");
  extern __shared__ uint4 wsmem16[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int tl = lane % TPI;
  const int slot = warp * IPW + lane / TPI;
  const int first = blockIdx.x * kSweep16Warps * IPW + warp * IPW;
  if (first >= B) return;  // the whole warp: nothing below syncs the block
  const int b_raw = first + lane / TPI;
  const bool live = b_raw < B;    // a dummy item of a part-empty warp runs
  const int b = live ? b_raw : B - 1;  // the last item and stores nothing
  uint8_t* base = reinterpret_cast<uint8_t*>(wsmem16) +
                  static_cast<size_t>(slot) * (2 * n_cap + m_cap);
  uint32_t* cs2 = reinterpret_cast<uint32_t*>(base);
  const uint16_t* cs = reinterpret_cast<const uint16_t*>(base);
  const uint8_t* qs = base + 2 * n_cap;
  const int k0 = L * tl;
  const int dlo = n_cap - m_cap - W / 2;
  const bool top = tl == TPI - 1;
  const bool has_pad = k0 + L > W;

  load_item16_onehot(q4, t4, dcb, b, m_cap, n_cap, base + 2 * n_cap, cs2,
                     tl, TPI);
  __syncwarp();

  const uint32_t match2 = dup16(match), mis2 = dup16(mismatch);
  const uint32_t gap2 = dup16(gap), neg2 = dup16(neg);
  const uint32_t ngap2 = dup16(-gap), fill2 = dup16(kDp16Fill);

  // row 0: hg = 0 inside the matrix, neg outside and on pad lanes;
  // col[v] holds the column halves at j - 1 of row 0 (the slide brings
  // row 1's). The scan's fill reaches every lane k <= span - 2: all but
  // at most the band's last lane (span >= W) and pad lanes, all in the
  // thread's last pair (fill_last).
  uint32_t hp[P], col[P], acc[P], lo8[P];
  uint32_t fill_last = 0;
#pragma unroll
  for (int v = 0; v < P; ++v) {
    hp[v] = col[v] = 0;
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int k = k0 + 2 * v + u;
      const int jz = dlo + k;
      hp[v] = set_half(hp[v], u, (k < W && jz >= 0 && jz <= n_cap) ? 0 : neg);
      col[v] = set_half(col[v], u, col_oh(cs, jz - 1, n_cap));
      if (v == P - 1)
        fill_last = set_half(fill_last, u,
                             k <= span - 2 ? kDp16Fill : -32768);
    }
    acc[v] = lo8[v] = 0;
  }
  int32_t* mrow = moves + static_cast<size_t>(b) * (m_cap / 16) * W + k0;

  // one row; `edge` (std::true_type) where a lane of the warp touches
  // the matrix's edges (j < 1 or j > n_cap) or is a pad lane, so that the
  // warp's interior rows carry no edge masks
  auto row = [&](int i, auto edge_t) {
    constexpr bool kEdge = decltype(edge_t)::value;
    // the query code as a shift: a column half's one-hot bit of that
    // code lands in bit 7 of its low byte; a column that is not PAD
    // against a real base is mismatch unless the query is PAD
    const uint32_t s = qs[i - 1];
    const uint32_t other2 = s == kPadShift ? neg2 : mis2;
    const int jb = i + dlo + k0;  // column of the thread's first lane
    // the next thread's first column half (low) and first hg half (high)
    // of the row before
    const uint32_t nb =
        __shfl_down_sync(kFull, prmt(col[0], hp[0], 0x5410), 1, TPI);
    // the window slides one column a row: lane k takes lane k + 1's
    // column; the top lane reads its own
    const uint32_t in = top ? col_oh(cs, i + dlo + WP - 2, n_cap) : nb;
    uint32_t above[P];
#pragma unroll
    for (int v = 0; v + 1 < P; ++v) {
      col[v] = prmt(col[v], col[v + 1], 0x5432);
      above[v] = prmt(hp[v], hp[v + 1], 0x5432);
    }
    col[P - 1] = prmt(col[P - 1], in, 0x5432);
    above[P - 1] = prmt(hp[P - 1], top ? neg2 : nb, 0x7632);

    // per pair: the substitution (equal codes: match; a PAD against a
    // base: neg; else other2) less the deletion cost of the column, the
    // diag candidate, and the best of diag and up (own)
    uint32_t diag[P], own[P], a[P];
#pragma unroll
    for (int v = 0; v < P; ++v) {
      const uint32_t eq = prmt(col[v] << s, 0, 0xAA88);
      const uint32_t pad = prmt(col[v], 0, 0xAA88);
      const uint32_t sub = (eq & match2) | (~eq & ((pad & neg2) |
                                                   (~pad & other2)));
      const uint32_t del = high_sign(col[v]) & ngap2;
      diag[v] = __vadd2(hp[v], __vadd2(sub, del));
      own[v] = __viaddmax_s16x2(above[v], gap2, diag[v]);
      a[v] = own[v];
    }
    uint32_t out[P], inv[P];
    if constexpr (kEdge) {
      uint32_t zero[P];
      edge_masks<P>(jb, k0, W, n_cap, out, zero, inv);
      const uint32_t ig2 = dup16(i * gap);
#pragma unroll
      for (int v = 0; v < P; ++v) {
        a[v] = (a[v] & ~zero[v]) | (ig2 & zero[v]);
        a[v] = (a[v] & ~out[v]) | (neg2 & out[v]);
      }
    }

    // max-plus prefix scan over the band: the thread's lanes, the thread
    // totals (sign-extended high half of the last pair) across the item's
    // threads, then the exclusive prefix and the fill
    pairs_incl_max<P>(a);
    int tot = static_cast<int>(a[P - 1]) >> 16;
#pragma unroll
    for (int d = 1; d < TPI; d <<= 1)
      tot = max(tot, __shfl_up_sync(kFull, tot, d, TPI));
    const int excl = __shfl_up_sync(kFull, tot, 1, TPI);
    const uint32_t pre = tl ? dup16(excl) : kMin2;

    // moves: DIAG where h == diag, UP where h == own (up won), else LEFT:
    // h != own implies h > own >= diag, so the move is
    // [h != diag] + [h != own]
    const int p = (i - 1) & 15;
    const uint32_t shift = 1u << (2 * (p & 7));
#pragma unroll
    for (int v = 0; v < P; ++v) {
      uint32_t h = __vimax3_s16x2(a[v], pre, v == P - 1 ? fill_last : fill2);
      if constexpr (kEdge) h = (h & ~out[v]) | (neg2 & out[v]);
      uint32_t mv = __vminu2(h ^ diag[v], kOnes2) +
                    __vminu2(h ^ own[v], kOnes2);
      if constexpr (kEdge) mv |= inv[v] & kMoves3;
      // one IMAD: written as mv * shift the compiler shifts and adds
      asm("mad.lo.u32 %0, %1, %2, %0;" : "+r"(acc[v]) : "r"(mv), "r"(shift));
      hp[v] = h;
    }
    if (p == 7) {
#pragma unroll
      for (int v = 0; v < P; ++v) {
        lo8[v] = acc[v];
        acc[v] = 0;
      }
    } else if (p == 15) {
      // lane 2v's word: rows 0-7 from the low half of lo8, rows 8-15
      // from the low half of acc; lane 2v + 1's from the high halves
      uint32_t w[L];
#pragma unroll
      for (int v = 0; v < P; ++v) {
        w[2 * v] = prmt(lo8[v], acc[v], 0x5410);
        w[2 * v + 1] = prmt(lo8[v], acc[v], 0x7632);
        acc[v] = 0;
      }
      int32_t* dst = mrow + ((i - 1) >> 4) * W;
      if (live) {
        if constexpr (WP == W && L % 4 == 0) {
#pragma unroll
          for (int x = 0; x < L; x += 4)
            *reinterpret_cast<int4*>(dst + x) =
                make_int4(w[x], w[x + 1], w[x + 2], w[x + 3]);
        } else if constexpr (WP == W) {
          *reinterpret_cast<int2*>(dst) = make_int2(w[0], w[1]);
        } else {
#pragma unroll
          for (int x = 0; x < L; ++x)
            if (k0 + x < W) dst[x] = static_cast<int32_t>(w[x]);
        }
      }
    }
  };

  for (int i = 1; i <= m_cap; ++i) {
    const int jb = i + dlo + k0;
    if (__any_sync(kFull, has_pad || jb < 1 || jb + L - 1 > n_cap))
      row(i, std::true_type{});
    else
      row(i, std::false_type{});
  }
  // the end lane's column is n_cap: H = hg + gc[n_cap], wrapped to int16
  // as the pair arithmetic wraps
  const int k_end = n_cap - m_cap - dlo;
  const int gc_end = gc_at16(reinterpret_cast<const uint32_t*>(
                                 dcb + static_cast<size_t>(b) * (n_cap / 8)),
                             n_cap, n_cap, gap);
#pragma unroll
  for (int x = 0; x < L; ++x)
    if (live && k0 + x == k_end)
      score[b] = static_cast<int16_t>(half_at(hp[x >> 1], x & 1) + gc_end);
}

constexpr int kStrip16Warps = 4;  // warps an SM the pairs rule asks for
                                  // (geometry.SWEEP16_SM_WARPS)

// W = 288 .. 1024: one block per item, warp w owns the strip of band lanes
// w S .. w S + S - 1 (S = 64 P, the last strip cut at W), thread t of it P
// pairs from lane w S + 2 P t (see the note at the top). Shared memory: the
// warps' hand-off rings ([warp][carries, first-lane H][kSweepRing]
// slots), the target column halves (2 n_cap bytes), the query shifts
// (m_cap bytes). Lane 31's last lane (the strip's, where another strip
// follows) takes its up candidate when the next row starts: the lane to
// its right, the next strip's first, reaches every value that candidate
// could give by its own up candidate, so the carry leaves it out (see
// nw_sweep.cu's strip kernel).
template <int P>
__global__ void __launch_bounds__(1024 / P)
nw_sweep16_strip_kernel(const uint8_t* __restrict__ q4,
                        const uint8_t* __restrict__ t4,
                        const uint8_t* __restrict__ dcb,
                        int32_t* __restrict__ moves,
                        int32_t* __restrict__ score, int m_cap, int n_cap,
                        int W, int match, int mismatch, int gap, int span,
                        int neg) {
  extern __shared__ uint4 ssmem16[];
  constexpr int L = 2 * P;   // band lanes per thread
  constexpr int S = 32 * L;  // band lanes per strip
  constexpr int R = kSweepRing;
  const int T = blockDim.x;
  const int nw = T >> 5;
  const int t = threadIdx.x;
  const int warp = t >> 5;
  const int lane = t & 31;
  const int b = blockIdx.x;
  unsigned long long* ring = reinterpret_cast<unsigned long long*>(ssmem16);
  uint32_t* cs2 = reinterpret_cast<uint32_t*>(ring + 2 * R * nw);
  const uint16_t* cs = reinterpret_cast<const uint16_t*>(cs2);
  uint8_t* qs = reinterpret_cast<uint8_t*>(cs2 + n_cap / 2);
  const int k0 = warp * S + L * lane;
  const int dlo = n_cap - m_cap - W / 2;

  load_item16_onehot(q4, t4, dcb, b, m_cap, n_cap, qs, cs2, t, T);

  const uint32_t match2 = dup16(match), mis2 = dup16(mismatch);
  const uint32_t gap2 = dup16(gap), neg2 = dup16(neg);
  const uint32_t ngap2 = dup16(-gap), fill2 = dup16(kDp16Fill);

  // row 0: hg = 0 inside the matrix, neg outside and past W; the scan's
  // fill on every lane k <= span - 2 (all but at most lane W - 1, in a
  // thread's last pair: fill_last)
  uint32_t hp[P], col[P], acc[P], lo8[P];
  uint32_t fill_last = 0;
#pragma unroll
  for (int v = 0; v < P; ++v) {
    hp[v] = 0;
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int k = k0 + 2 * v + u;
      const int jz = dlo + k;
      hp[v] = set_half(hp[v], u, (k < W && jz >= 0 && jz <= n_cap) ? 0 : neg);
      if (v == P - 1)
        fill_last = set_half(fill_last, u,
                             k <= span - 2 ? kDp16Fill : -32768);
    }
    acc[v] = lo8[v] = 0;
  }
  // this warp's rings: carries (read by warp + 1), first-lane H (read by
  // warp - 1); every slot at row 0, the first-lane H of row 0 published
  unsigned long long* carry_out = ring + 2 * R * warp;
  unsigned long long* first_out = carry_out + R;
  const unsigned long long* carry_in = carry_out - 2 * R;  // warp - 1's
  const unsigned long long* first_in = first_out + 2 * R;  // warp + 1's
  if (lane < 2 * R) carry_out[lane] = 0;
  __syncwarp();
  if (lane == 0) publish(first_out, 0, half_at(hp[0], 0));
  __syncthreads();  // the codes and the rings; the row loop has no other
  // col[v] holds the column halves at j - 1 of row 0 (the slide brings
  // row 1's)
#pragma unroll
  for (int v = 0; v < P; ++v) {
    col[v] = 0;
#pragma unroll
    for (int u = 0; u < 2; ++u)
      col[v] = set_half(col[v], u, col_oh(cs, dlo + k0 + 2 * v + u - 1,
                                          n_cap));
  }

  const bool has_left = warp > 0;
  const bool has_right = warp + 1 < nw;
  const bool live = k0 < W;              // not past the band's end
  // the thread's last lane takes no up candidate in the row: lane W - 1
  // (none), and lane 31's where a strip follows (taken when the next row
  // starts: dm, the high half of its last pair)
  const bool no_up = lane == 31 || k0 + L == W;
  const uint32_t dm = lane == 31 && has_right ? 0xFFFF0000u : 0u;
  int32_t* mrow = moves + static_cast<size_t>(b) * (m_cap / 16) * W + k0;
  // the last pair's diag and its move-3 mask (an edge row's) of the row
  // before, for the deferred up candidate
  uint32_t d_last = 0, inv_last = 0;

  // row r ends: lane 31 takes its last lane's up candidate, warp + 1's
  // first-lane H of row r - 1 plus gap, where that lane lies in columns 1
  // .. n_cap (h = max(h, up), the move DIAG, UP or LEFT from h, diag and
  // max(diag, up)); then the pair words go out once row r ends a block of
  // 16 rows
  auto finish = [&](int r) {
    const int p = (r - 1) & 15;
    const uint32_t shift = 1u << (2 * (p & 7));
    if (has_right) {
      const int right = await_row(first_in + ((r - 1) & (R - 1)), r - 1);
      const uint32_t pm = dm & ~inv_last;
      const uint32_t up = (static_cast<uint32_t>(right + gap) << 16 & pm) |
                          (kMin2 & ~pm);
      const uint32_t h = __vmaxs2(hp[P - 1], up);
      const uint32_t own = __vmaxs2(d_last, up);
      const uint32_t mv = (__vminu2(h ^ d_last, kOnes2) +
                           __vminu2(h ^ own, kOnes2)) |
                          (inv_last & kMoves3);
      acc[P - 1] += (mv & dm) * shift;
      hp[P - 1] = h;
    }
    if (p == 7) {
#pragma unroll
      for (int v = 0; v < P; ++v) {
        lo8[v] = acc[v];
        acc[v] = 0;
      }
    } else if (p == 15) {
      // lane 2v's word: rows 0-7 from the low half of lo8, rows 8-15
      // from the low half of acc; lane 2v + 1's from the high halves
      uint32_t w[L];
#pragma unroll
      for (int v = 0; v < P; ++v) {
        w[2 * v] = prmt(lo8[v], acc[v], 0x5410);
        w[2 * v + 1] = prmt(lo8[v], acc[v], 0x7632);
        acc[v] = 0;
      }
      if (live) {
        int32_t* dst = mrow + ((r - 1) >> 4) * W;
#pragma unroll
        for (int x = 0; x < L; x += 4)
          *reinterpret_cast<int4*>(dst + x) =
              make_int4(w[x], w[x + 1], w[x + 2], w[x + 3]);
      }
    }
  };

  // one row of the strip; `edge` (std::true_type) where a lane of the strip
  // lies outside columns 1 .. n_cap, so that the rows in between carry no
  // edge masks
  auto row = [&](int i, auto edge_t) {
    constexpr bool kEdge = decltype(edge_t)::value;
    // the query code as a shift (see the warp kernel)
    const uint32_t s = qs[i - 1];
    const uint32_t other2 = s == kPadShift ? neg2 : mis2;
    const int jb = i + dlo + k0;  // column of the thread's first lane
    // the next thread's first column half (low) and first hg half (high)
    // of the row before
    const uint32_t nb =
        __shfl_down_sync(kFull, prmt(col[0], hp[0], 0x5410), 1);
    // the window slides one column a row: lane k takes lane k + 1's
    // column; lane 31 reads its own
    const uint32_t in =
        lane != 31 ? nb
                   : (kEdge ? col_oh(cs, jb + L - 2, n_cap)
                            : static_cast<uint32_t>(cs[jb + L - 2]));
    uint32_t above[P];
#pragma unroll
    for (int v = 0; v + 1 < P; ++v) {
      col[v] = prmt(col[v], col[v + 1], 0x5432);
      above[v] = prmt(hp[v], hp[v + 1], 0x5432);
    }
    col[P - 1] = prmt(col[P - 1], in, 0x5432);
    above[P - 1] = prmt(hp[P - 1], no_up ? neg2 : nb, 0x7632);

    uint32_t diag[P], own[P], a[P];
#pragma unroll
    for (int v = 0; v < P; ++v) {
      const uint32_t eq = prmt(col[v] << s, 0, 0xAA88);
      const uint32_t pad = prmt(col[v], 0, 0xAA88);
      const uint32_t sub = (eq & match2) | (~eq & ((pad & neg2) |
                                                   (~pad & other2)));
      const uint32_t del = high_sign(col[v]) & ngap2;
      diag[v] = __vadd2(hp[v], __vadd2(sub, del));
      own[v] = __viaddmax_s16x2(above[v], gap2, diag[v]);
      a[v] = own[v];
    }
    uint32_t out[P], inv[P];
    if constexpr (kEdge) {
      uint32_t zero[P];
      edge_masks<P>(jb, k0, W, n_cap, out, zero, inv);
      const uint32_t ig2 = dup16(i * gap);
#pragma unroll
      for (int v = 0; v < P; ++v) {
        a[v] = (a[v] & ~zero[v]) | (ig2 & zero[v]);
        a[v] = (a[v] & ~out[v]) | (neg2 & out[v]);
      }
    }

    // the scan over the strip: the thread's lanes, the thread totals
    // (sign-extended high half of the last pair) across the warp, then the
    // carry from the strip to the left and the exclusive prefix. A shuffle
    // up gives a lane below its offset its own total, which the max leaves
    // as it is.
    pairs_incl_max<P>(a);
    int tot = static_cast<int>(a[P - 1]) >> 16;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1)
      tot = max(tot, __shfl_up_sync(kFull, tot, d));
    const int excl = __shfl_up_sync(kFull, tot, 1);
    const int carry =
        has_left ? await_row(carry_in + (i & (R - 1)), i) : -32768;
    if (lane == 31 && has_right)
      publish(carry_out + (i & (R - 1)), i, max(carry, tot));
    const uint32_t pre = dup16(lane ? max(excl, carry) : carry);

    // moves: DIAG where h == diag, UP where h == own (up won), else LEFT:
    // [h != diag] + [h != own]; the deferred lane's comes in finish()
    const int p = (i - 1) & 15;
    const uint32_t shift = 1u << (2 * (p & 7));
#pragma unroll
    for (int v = 0; v < P; ++v) {
      uint32_t h = __vimax3_s16x2(a[v], pre, v == P - 1 ? fill_last : fill2);
      if constexpr (kEdge) h = (h & ~out[v]) | (neg2 & out[v]);
      uint32_t mv = __vminu2(h ^ diag[v], kOnes2) +
                    __vminu2(h ^ own[v], kOnes2);
      if constexpr (kEdge) mv |= inv[v] & kMoves3;
      if (v == P - 1) mv &= ~dm;
      // one IMAD: written as mv * shift the compiler shifts and adds
      asm("mad.lo.u32 %0, %1, %2, %0;" : "+r"(acc[v]) : "r"(mv), "r"(shift));
      hp[v] = h;
    }
    d_last = diag[P - 1];
    if constexpr (kEdge)
      inv_last = inv[P - 1];
    else
      inv_last = 0u;
    if (lane == 0 && has_left)
      publish(first_out + (i & (R - 1)), i, half_at(hp[0], 0));
  };

  for (int i = 1; i <= m_cap; ++i) {
    if (i > 1) finish(i - 1);
    const int jw = i + dlo + warp * S;  // column of the strip's first lane
    if (jw >= 1 && jw + S - 1 <= n_cap)
      row(i, std::false_type{});
    else
      row(i, std::true_type{});
  }
  finish(m_cap);
  // the end lane's column is n_cap: H = hg + gc[n_cap], wrapped to int16
  // as the pair arithmetic wraps
  const int k_end = n_cap - m_cap - dlo;
  const int gc_end = gc_at16(reinterpret_cast<const uint32_t*>(
                                 dcb + static_cast<size_t>(b) * (n_cap / 8)),
                             n_cap, n_cap, gap);
#pragma unroll
  for (int x = 0; x < L; ++x)
    if (live && k0 + x == k_end)
      score[b] = static_cast<int16_t>(half_at(hp[x >> 1], x & 1) + gc_end);
}

// pairs a thread of the strip kernel at band width W > 256 and B items
// (geometry.sweep16_pairs): the most (8, then 4) that still put
// kStrip16Warps warps or more (one a scheduler) on each of the H100's 132
// SMs (an SM's items one block each), else 2. Fewer pairs a thread spread
// the row's overhead (the shuffles of the scan, the finish step, the
// hand-off) over fewer pairs, but hide more of each warp's chain of
// shuffles; timed on the card at every pairs count, the rule's choice the
// fastest at six of seven shapes and 2 % off at the seventh
// (benchmarks/strip_ab.py, PERF.md)
static int strip16_pairs(int W, int B) {
  const int items_per_sm = (B + 131) / 132;
  if (items_per_sm * ((W + 511) / 512) >= kStrip16Warps) return 8;
  if (items_per_sm * ((W + 255) / 256) >= kStrip16Warps) return 4;
  return 2;
}

// warps per item of the strip kernel: strips of 64 P lanes, the last one
// cut at W
static int strip16_warps(int W, int B) {
  const int S = 64 * strip16_pairs(W, B);
  return (W + S - 1) / S;
}

// threads per item of the warp kernel (geometry.sweep16_tpi): 8, four
// items a warp, at W = 128; 32 at the other widths
static int warp16_tpi(int W) { return W == 128 ? 8 : 32; }

}  // namespace

// shared bytes per block of the int16 sweep (geometry.sweep_launch): the
// warp kernel's items (each 2 n_cap + m_cap bytes, kSweep16Warps * 32 /
// warp16_tpi(W) of them), or the strip kernel's hand-off rings and codes
extern "C" size_t rtt_nw_sweep16_smem(int m_cap, int n_cap, int W, int B) {
  if (W <= 256)
    return static_cast<size_t>(kSweep16Warps * 32 / warp16_tpi(W)) *
           (2 * n_cap + m_cap);
  return static_cast<size_t>(16 * kSweepRing) * strip16_warps(W, B) +
         2 * n_cap + m_cap;
}

template <typename K>
static int raise_smem16(K kernel, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem)));
}

template <int P>
static int launch_strip16(const uint8_t* q4, const uint8_t* t4,
                          const uint8_t* dcb, int32_t* moves, int32_t* score,
                          int B, int m_cap, int n_cap, int W, int match,
                          int mismatch, int gap, int span, int neg,
                          cudaStream_t stream) {
  const size_t smem = rtt_nw_sweep16_smem(m_cap, n_cap, W, B);
  if (int e = raise_smem16(nw_sweep16_strip_kernel<P>, smem)) return e;
  nw_sweep16_strip_kernel<P><<<B, 32 * strip16_warps(W, B), smem, stream>>>(
      q4, t4, dcb, moves, score, m_cap, n_cap, W, match, mismatch, gap, span,
      neg);
  return RTT_LAUNCH_STATUS();
}

template <int TPI, int P, int W>
static int launch_warp16(const uint8_t* q4, const uint8_t* t4,
                         const uint8_t* dcb, int32_t* moves, int32_t* score,
                         int B, int m_cap, int n_cap, int match,
                         int mismatch, int gap, int span, int neg,
                         cudaStream_t stream) {
  const size_t smem = rtt_nw_sweep16_smem(m_cap, n_cap, W, B);
  auto kernel = nw_sweep16_warp_kernel<TPI, P, W>;
  if (int e = raise_smem16(kernel, smem)) return e;
  const int per_block = kSweep16Warps * 32 / TPI;
  kernel<<<(B + per_block - 1) / per_block, 32 * kSweep16Warps, smem,
           stream>>>(q4, t4, dcb, moves, score, B, m_cap, n_cap, match,
                     mismatch, gap, span, neg);
  return RTT_LAUNCH_STATUS();
}

// q4 (B, m_cap/2) u8, t4 (B, n_cap/2) u8, dcb (B, n_cap/8) u8 ->
// moves (B, m_cap/16, W) i32, score (B,) i32, H in int16 with the sentinel
// neg. Requires W a multiple of 32 up to 1024, m_cap % 16 == 0,
// n_cap % 32 == 0, dlo <= 0, and the int16 gate (the caller's).
extern "C" int rtt_nw_sweep16(const uint8_t* q4, const uint8_t* t4,
                              const uint8_t* dcb, int32_t* moves,
                              int32_t* score, int B, int m_cap, int n_cap,
                              int W, int match, int mismatch, int gap,
                              int span, int neg, cudaStream_t stream) {
  if (B == 0) return 0;
  if (W > 256) {
    switch (strip16_pairs(W, B)) {
      case 2:
        return launch_strip16<2>(q4, t4, dcb, moves, score, B, m_cap, n_cap,
                                 W, match, mismatch, gap, span, neg, stream);
      case 4:
        return launch_strip16<4>(q4, t4, dcb, moves, score, B, m_cap, n_cap,
                                 W, match, mismatch, gap, span, neg, stream);
      case 8:
        return launch_strip16<8>(q4, t4, dcb, moves, score, B, m_cap, n_cap,
                                 W, match, mismatch, gap, span, neg, stream);
      default:
        return static_cast<int>(cudaErrorInvalidValue);
    }
  }
#define RTT_WARP16(TPI, P, WW)                                              \
  return launch_warp16<TPI, P, WW>(q4, t4, dcb, moves, score, B, m_cap,     \
                                   n_cap, match, mismatch, gap, span, neg,  \
                                   stream);
  switch (W) {
    case 32: RTT_WARP16(32, 1, 32)
    case 64: RTT_WARP16(32, 1, 64)
    case 96: RTT_WARP16(32, 2, 96)
    case 128: RTT_WARP16(8, 8, 128)
    case 160: RTT_WARP16(32, 3, 160)
    case 192: RTT_WARP16(32, 3, 192)
    case 224: RTT_WARP16(32, 4, 224)
    case 256: RTT_WARP16(32, 4, 256)
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef RTT_WARP16
}

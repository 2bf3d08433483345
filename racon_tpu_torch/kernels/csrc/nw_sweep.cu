// Scored banded linear-gap Needleman-Wunsch sweep.
//
// Replaces the TPU kernels racon_tpu/ops/nw_kernel.py::nw_band_batch_t8
// (body _nw_band_kernel_t8), ::nw_band_batch_t8big (body
// _nw_band_kernel_t8big) and ::nw_band_batch (body _nw_band_kernel, the
// lane-major form the reference runs at W = 2048 and 4096), which compute
// the same DP and differ only in how they fit TPU VMEM; two kernels,
// each templated on the band lanes per thread, cover every consensus tier
// and every align tier of the scored route (W <= 4096): the warp kernel up
// to W = 256, the strip kernel above.
//
// Geometry: band lane k of query row i is target column j = i + dlo + k,
// dlo = n_cap - m_cap - W/2. Per row: substitution (PAD against a real base
// = NEG), diag and up candidates, j == 0 -> i*gap, then deletion chains
// closed by an inclusive max-plus prefix scan of cand - gc over the band,
// gc the prefix sums of the per-column deletion costs. Moves are 2 bits,
// DIAG(0) > UP(1) > LEFT(2), 3 = outside the matrix, 16 rows per int32 word
// exactly like K1's words; the layout is (B, m_cap/16, W) so that one item's
// words are contiguous. The score is H at lane n_cap - m_cap - dlo.
//
// Design on the H100, W <= 256 (K1's tiers (256,128), (640,128),
// (1280,256)): one warp per item, kSweepWarps items per block, LPT = W/32
// band lanes per thread (thread t owns lanes LPT*t .. LPT*t + LPT - 1),
// everything of a row in registers and shuffles. The ablation of
// the block design (one block per item, one thread per lane) found the
// block scan with its barrier 60 % of the time and one barrier a row
// still left without it; here the band lies in one warp, so the row loop
// has no __syncthreads and no shared-memory exchange: the up neighbour of
// a thread's last lane is a __shfl_down of the next thread's first lane,
// the scan is warp_lanes_incl_max (a serial max over the thread's lanes,
// five shuffles, one more for the exclusive prefix), and the target codes
// slide one lane down a row by one more shuffle (the top lane reads one
// byte of shared memory). Each warp unpacks its item's codes into its own
// slice of shared memory with 16-byte loads, the deletion bit of each
// target column folded into bit 4 of its code byte (gc is integrated
// per lane from it, as K1's gc register does), behind one __syncwarp.
// Moves: every 16 rows a thread stores its LPT words (16-byte stores at
// K1's LPT = 4 and 8), so a warp writes one contiguous 4 W-byte run. What
// bounds it: instruction throughput, ~15 integer ops per cell and ~8
// shuffles a row per warp, with a warp per item resident to hide each
// warp's chain of dependent shuffles.
//
// W = 288 .. 4096 (K2's and K5's tiers and the align stage's scored
// route): one block per item, made of warp strips. Warp w owns S = 32 LPT
// contiguous band lanes (LPT = strip_lanes(W, B): 4, or 8 where that still
// leaves 16 warps an SM; the last strip cut at W), each of its threads LPT
// of them, so a strip's row is the warp kernel's row: the query codes and
// the target columns in shared memory (a column as code | deletion cost
// << 8), the column values sliding a lane a row in registers (each
// thread's last lane reads its new column), the scan five shuffles and
// one more. H is kept less gc, the scan's own space. Rows whose strip
// lies inside columns 1 .. n_cap skip the edge tests and take each move
// from the scan value and the diag/up comparison. The block barriers of
// the design before (a block scan and an exchange barrier a row, ~60 % of
// its time in the ablation) are gone: per row, warp w needs two integers,
// the carry (the max of cand - gc over every lane left of its strip) from
// warp w - 1, and warp w + 1's first-lane H of the row before, for the up
// move of its last lane. Each warp publishes its pair into rings of
// kSweepRing rows in shared memory, a slot being the row and the value in
// one 64-bit word; a waiting warp polls the slot behind a __nanosleep
// back-off. The hand-off is skewed so that the carry never waits for the
// right neighbour: a thread's last lane leaves its up candidate out of the
// scan (the lane to its right reaches every value it could give, see the
// kernel) and takes it when the next row starts, so warp w reads warp
// w + 1's H of row i - 2 at row i and runs at most two rows ahead of it.
// Two rows of ring are then enough (a reader has always taken the slot a
// writer reuses) and one is not. The only __syncthreads is the one after
// staging the codes; the warps of a block are all resident, so the waits
// cannot deadlock. Moves: every 16 rows a thread stores its LPT words as
// 16-byte stores, a warp one contiguous 4 S-byte run. What bounds it: the
// integer work of a cell at 64 INT32 lanes an SM, one item an SM below
// B = 132; with few warps an SM, each warp's chain of dependent
// instructions a row, the hand-off waits and the scan's shuffles among
// them (benchmarks/strip_ab.py times the kernel without each).
#include <type_traits>

#include "sweep_scan.cuh"

namespace {

using namespace rtt;

// gc[j] = gap * (set bits among deletion-cost columns 0..j-1); 0 for j <= 0
__device__ int gc_at(const uint32_t* bits, int j, int n_cap, int gap) {
  if (j <= 0) return 0;
  if (j > n_cap) j = n_cap;
  int c = 0;
  for (int x = 0; x < (j >> 5); ++x) c += __popc(bits[x]);
  if (j & 31) c += __popc(bits[j >> 5] & ((1u << (j & 31)) - 1u));
  return c * gap;
}

constexpr int kSweepWarps = 4;   // items (warps) per block of the warp
                                 // kernel; geometry.SWEEP_WARPS

// 8 codes from 4 bytes of a nibble-packed row (low nibble first), one
// code per byte
__device__ __forceinline__ uint2 unpack8(uint32_t v) {
  const uint32_t lo = v & 0x0F0F0F0Fu;
  const uint32_t hi = (v >> 4) & 0x0F0F0F0Fu;
  return make_uint2(__byte_perm(lo, hi, 0x5140), __byte_perm(lo, hi, 0x7362));
}

// bit c of x (c < 4) to bit 4 of byte c
__device__ __forceinline__ uint32_t spread4(uint32_t x) {
  return ((x & 1u) | ((x & 2u) << 7) | ((x & 4u) << 14) | ((x & 8u) << 21))
         << 4;
}

// target column value of the warp kernel: code | deletion bit << 4, PAD
// (and no deletion cost) outside the target
__device__ __forceinline__ int col_at(const uint8_t* cs, int j, int n_cap) {
  return (j >= 0 && j < n_cap) ? cs[j] : kPad;
}

// a thread's LPT move words: 16-byte stores where LPT % 4 == 0 (K1's
// tiers), else one word at a time
template <int LPT>
__device__ __forceinline__ void store_words(int32_t* dst,
                                            const uint32_t (&w)[LPT]) {
  if constexpr (LPT % 4 == 0) {
#pragma unroll
    for (int v = 0; v < LPT; v += 4)
      *reinterpret_cast<int4*>(dst + v) =
          make_int4(w[v], w[v + 1], w[v + 2], w[v + 3]);
  } else {
#pragma unroll
    for (int v = 0; v < LPT; ++v) dst[v] = static_cast<int32_t>(w[v]);
  }
}

// W = 32 * LPT <= 256: one warp per item (see the note at the top).
// Shared memory per warp: the query codes (m_cap bytes), then the target
// column values (n_cap bytes). The minimum of one block a SM frees ptxas
// from its occupancy target: without it, it spilled 4 bytes at LPT = 6.
template <int LPT>
__global__ void __launch_bounds__(32 * kSweepWarps, 1)
nw_sweep_warp_kernel(const uint8_t* __restrict__ q4,
                     const uint8_t* __restrict__ t4,
                     const uint8_t* __restrict__ dcb,
                     int32_t* __restrict__ moves,
                     int32_t* __restrict__ score, int B, int m_cap,
                     int n_cap, int match, int mismatch, int gap,
                     int span) {
  extern __shared__ uint4 wsmem[];
  constexpr int W = 32 * LPT;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * kSweepWarps + warp;
  if (b >= B) return;  // the whole warp: nothing below syncs the block
  uint8_t* qs = reinterpret_cast<uint8_t*>(wsmem) + warp * (m_cap + n_cap);
  uint8_t* cs = qs + m_cap;
  const int k0 = LPT * lane;
  const int dlo = n_cap - m_cap - W / 2;

  // codes into shared memory: 16 bytes (32 codes) a load where the row
  // allows it (targets always: n_cap % 32 == 0), 8 bytes otherwise
  const uint8_t* qrow = q4 + static_cast<size_t>(b) * (m_cap / 2);
  if (m_cap % 32 == 0) {
    for (int x = lane; x < m_cap / 32; x += 32) {
      const uint4 v = reinterpret_cast<const uint4*>(qrow)[x];
      const uint2 a = unpack8(v.x), c = unpack8(v.y), d = unpack8(v.z),
                  e = unpack8(v.w);
      uint4* dst = reinterpret_cast<uint4*>(qs + 32 * x);
      dst[0] = make_uint4(a.x, a.y, c.x, c.y);
      dst[1] = make_uint4(d.x, d.y, e.x, e.y);
    }
  } else {
    for (int x = lane; x < m_cap / 16; x += 32) {
      const uint2 v = reinterpret_cast<const uint2*>(qrow)[x];
      const uint2 a = unpack8(v.x), c = unpack8(v.y);
      *reinterpret_cast<uint4*>(qs + 16 * x) = make_uint4(a.x, a.y, c.x, c.y);
    }
  }
  const uint4* trow =
      reinterpret_cast<const uint4*>(t4 + static_cast<size_t>(b) * (n_cap / 2));
  const uint32_t* drow = reinterpret_cast<const uint32_t*>(
      dcb + static_cast<size_t>(b) * (n_cap / 8));
  for (int x = lane; x < n_cap / 32; x += 32) {
    const uint4 v = trow[x];
    const uint32_t bits = drow[x];  // columns 32x .. 32x + 31
    uint2 p[4] = {unpack8(v.x), unpack8(v.y), unpack8(v.z), unpack8(v.w)};
#pragma unroll
    for (int y = 0; y < 4; ++y) {
      p[y].x |= spread4((bits >> (8 * y)) & 15u);
      p[y].y |= spread4((bits >> (8 * y + 4)) & 15u);
    }
    uint4* dst = reinterpret_cast<uint4*>(cs + 32 * x);
    dst[0] = make_uint4(p[0].x, p[0].y, p[1].x, p[1].y);
    dst[1] = make_uint4(p[2].x, p[2].y, p[3].x, p[3].y);
  }
  __syncwarp();

  // row 0: H[0][j] = gc[j] inside the matrix, NEG outside; c[u] is the
  // column value at j - 1 of row 1
  int hp[LPT], gcj[LPT], c[LPT];
  uint32_t pack[LPT];
  const uint32_t* bits = reinterpret_cast<const uint32_t*>(
      dcb + static_cast<size_t>(b) * (n_cap / 8));
#pragma unroll
  for (int u = 0; u < LPT; ++u) {
    const int jz = dlo + k0 + u;
    gcj[u] = gc_at(bits, jz, n_cap, gap);
    hp[u] = (jz >= 0 && jz <= n_cap) ? gcj[u] : kNeg;
    c[u] = col_at(cs, jz, n_cap);
    pack[u] = 0;
  }
  int32_t* mrow = moves + static_cast<size_t>(b) * (m_cap / 16) * W + k0;

  for (int i = 1; i <= m_cap; ++i) {
    const int qc = qs[i - 1];
    const int jb = i + dlo + k0;  // column of the thread's first lane
    if (i > 1) {
      // the window slides one column a row: lane k takes lane k + 1's
      // column value of the row before
      const int next = __shfl_down_sync(kFull, c[0], 1);
#pragma unroll
      for (int u = 0; u + 1 < LPT; ++u) c[u] = c[u + 1];
      c[LPT - 1] = lane == 31 ? col_at(cs, jb + LPT - 2, n_cap) : next;
    }
    // lane k + 1 of the previous row for the thread's last lane
    const int above_last = __shfl_down_sync(kFull, hp[0], 1);
    int diag_c[LPT], up_c[LPT], a[LPT];
#pragma unroll
    for (int u = 0; u < LPT; ++u) {
      const int j = jb + u;
      if (c[u] >> 4) gcj[u] += gap;
      const int tc = c[u] & 15;
      const int sub = ((tc == kPad) != (qc == kPad))
                          ? kNeg : (tc == qc ? match : mismatch);
      diag_c[u] = hp[u] + sub;
      const int above = (u + 1 < LPT) ? hp[(u + 1) % LPT]
                        : (lane == 31 ? kNeg : above_last);
      up_c[u] = above + gap;
      int cand = max(diag_c[u], up_c[u]);
      if (j == 0) cand = i * gap;
      if (j < 0 || j > n_cap) cand = kNeg;
      a[u] = cand - gcj[u];
    }
    warp_lanes_incl_max<LPT>(a, lane);

    const int p = (i - 1) & 15;
#pragma unroll
    for (int u = 0; u < LPT; ++u) {
      const int j = jb + u;
      if (k0 + u <= span - 2) a[u] = max(a[u], kScanFill);
      int h = a[u] + gcj[u];
      if (j < 0 || j > n_cap) h = kNeg;
      int mv = (h == diag_c[u]) ? 0 : ((h == up_c[u]) ? 1 : 2);
      if (j < 1 || j > n_cap) mv = 3;
      pack[u] |= static_cast<uint32_t>(mv) << (2 * p);
      hp[u] = h;
    }
    if (p == 15) {
      store_words<LPT>(mrow + ((i - 1) >> 4) * W, pack);
#pragma unroll
      for (int u = 0; u < LPT; ++u) pack[u] = 0;
    }
  }
#pragma unroll
  for (int u = 0; u < LPT; ++u)
    if (k0 + u == n_cap - m_cap - dlo) score[b] = hp[u];
}

constexpr int kSweepRing = 2;  // rows in each warp's hand-off rings;
                                // geometry.SWEEP_RING
static_assert((kSweepRing & (kSweepRing - 1)) == 0, "a power of two");

// One hand-off slot: the row in the high word, the value in the low, one
// 64-bit access, so that a reader never sees a row with another row's
// value and needs no fence.
__device__ __forceinline__ void publish(unsigned long long* slot, int row,
                                        int v) {
  *reinterpret_cast<volatile unsigned long long*>(slot) =
      (static_cast<unsigned long long>(row) << 32) | static_cast<uint32_t>(v);
}

// The value of `slot` once its row is `row` or later, read by the whole
// warp; a warp that finds it not yet written sleeps (a back-off up to
// 256 ns), so that it takes no issue slots from the working warps.
__device__ __forceinline__ int await_row(const unsigned long long* slot,
                                         int row) {
  const volatile unsigned long long* p = slot;
  unsigned long long v = *p;
  unsigned ns = 8;
  while (!__all_sync(kFull, static_cast<int>(v >> 32) >= row)) {
    __nanosleep(ns);
    ns = min(2 * ns, 256u);
    v = *p;
  }
  return static_cast<int>(static_cast<uint32_t>(v));
}

// In place, a[u] becomes the max of a over the warp's lanes at or below
// lane LPT*lane + u (thread t owns lanes LPT*t .. LPT*t + LPT - 1): a
// serial max over the thread's lanes, a shuffle scan of the thread
// totals and the exclusive prefix by one more shuffle. A shuffle up
// gives a lane below its offset its own value, which the max leaves as it
// is, so the steps need no lane test.
template <int LPT>
__device__ __forceinline__ void strip_incl_max(int (&a)[LPT], int lane) {
#pragma unroll
  for (int u = 1; u < LPT; ++u) a[u] = max(a[u], a[u - 1]);
  int v = a[LPT - 1];
#pragma unroll
  for (int s = 1; s < 32; s <<= 1) v = max(v, __shfl_up_sync(kFull, v, s));
  const int excl = __shfl_up_sync(kFull, v, 1);
  if (lane) {
#pragma unroll
    for (int u = 0; u < LPT; ++u) a[u] = max(a[u], excl);
  }
}

// target column value of the strip kernel: code | deletion cost << 8
// (gap or 0), PAD (and no deletion cost) outside the target
__device__ __forceinline__ int col32_at(const int* cs, int j, int n_cap) {
  return (j >= 0 && j < n_cap) ? cs[j] : kPad;
}

// W = 288 .. 4096: one block per item, warp w owns the strip of band
// lanes w*S .. w*S + S - 1 (S = 32 * LPT, the last strip cut at W), thread
// t of it lanes w*S + LPT*t .. + LPT - 1 (see the note at the top).
// Shared memory: the warps' hand-off rings ([warp][carries, first-lane
// H][kSweepRing] slots), the target column values (4 n_cap bytes), the
// query codes (m_cap bytes).
//
// H is kept less gc (hg = H - gc[j], the scan's own space): the scan value
// of a lane is then its best candidate, a lane's H is its scan result, and
// the diag candidate subtracts the deletion cost of the column it crosses;
// gc itself is carried for each thread's first lane only and summed over
// the thread's columns where a row reaches the matrix's edges.
//
// The last lane L of each thread takes its up candidate when the next row
// starts, and its scan value leaves it out. The scan loses nothing: lane
// L + 1 (a first lane, inside the band wherever L's candidate counts)
// reaches the same cell by its own up candidate, left then up at row i - 1
// costing what up then left does at row i, and the left chain of row i - 1
// makes its H there at least H(i-1, j_L) plus the deletion cost. So the
// carry to the next warp never waits for that warp, and the right
// neighbour's first-lane H is read one row late.
template <int LPT>
__global__ void __launch_bounds__(4096 / LPT > 1024 ? 1024 : 4096 / LPT)
nw_sweep_strip_kernel(const uint8_t* __restrict__ q4,
                      const uint8_t* __restrict__ t4,
                      const uint8_t* __restrict__ dcb,
                      int32_t* __restrict__ moves,
                      int32_t* __restrict__ score, int m_cap, int n_cap,
                      int W, int match, int mismatch, int gap, int span) {
  extern __shared__ uint4 ssmem[];
  static_assert(LPT >= 2, "a thread's first lane is never its last");
  constexpr int S = 32 * LPT;
  constexpr int R = kSweepRing;
  const int T = blockDim.x;
  const int nw = T >> 5;
  const int t = threadIdx.x;
  const int warp = t >> 5;
  const int lane = t & 31;
  const int b = blockIdx.x;
  unsigned long long* ring = reinterpret_cast<unsigned long long*>(ssmem);
  int* cs = reinterpret_cast<int*>(ring + 2 * R * nw);
  uint8_t* qs = reinterpret_cast<uint8_t*>(cs + n_cap);
  const int k0 = warp * S + LPT * lane;
  const int dlo = n_cap - m_cap - W / 2;

  // codes into shared memory, by the whole block: the query codes 16 bytes
  // (32 codes) a load where the row allows it, 8 bytes otherwise; the
  // target columns 32 a thread, each code | deletion cost << 8
  const uint8_t* qrow = q4 + static_cast<size_t>(b) * (m_cap / 2);
  if (m_cap % 32 == 0) {
    for (int x = t; x < m_cap / 32; x += T) {
      const uint4 v = reinterpret_cast<const uint4*>(qrow)[x];
      const uint2 a = unpack8(v.x), c = unpack8(v.y), d = unpack8(v.z),
                  e = unpack8(v.w);
      uint4* dst = reinterpret_cast<uint4*>(qs + 32 * x);
      dst[0] = make_uint4(a.x, a.y, c.x, c.y);
      dst[1] = make_uint4(d.x, d.y, e.x, e.y);
    }
  } else {
    for (int x = t; x < m_cap / 16; x += T) {
      const uint2 v = reinterpret_cast<const uint2*>(qrow)[x];
      const uint2 a = unpack8(v.x), c = unpack8(v.y);
      *reinterpret_cast<uint4*>(qs + 16 * x) = make_uint4(a.x, a.y, c.x, c.y);
    }
  }
  const uint4* trow =
      reinterpret_cast<const uint4*>(t4 + static_cast<size_t>(b) * (n_cap / 2));
  const uint32_t* bits = reinterpret_cast<const uint32_t*>(
      dcb + static_cast<size_t>(b) * (n_cap / 8));
  for (int x = t; x < n_cap / 32; x += T) {
    const uint4 v = trow[x];
    const uint32_t bw = bits[x];  // columns 32x .. 32x + 31
    const uint32_t w4[4] = {v.x, v.y, v.z, v.w};
    int4* dst = reinterpret_cast<int4*>(cs + 32 * x);
#pragma unroll
    for (int y = 0; y < 8; ++y) {  // columns 32x + 4y .. + 3
      int col[4];
#pragma unroll
      for (int z = 0; z < 4; ++z) {
        const int jj = 4 * y + z;
        col[z] = static_cast<int>((w4[jj >> 3] >> (4 * (jj & 7))) & 15u) |
                 (((bw >> jj) & 1u) ? gap * 256 : 0);
      }
      dst[y] = make_int4(col[0], col[1], col[2], col[3]);
    }
  }

  // row 0: hg = 0 inside the matrix, NEG - gc outside; c[u] is the column
  // value at j - 1 of row 1; gc0 is gc at the thread's first lane
  int hp[LPT], c[LPT];
  uint32_t pack[LPT];
  int gc0 = gc_at(bits, dlo + k0, n_cap, gap);
#pragma unroll
  for (int u = 0; u < LPT; ++u) {
    const int jz = dlo + k0 + u;
    hp[u] = (jz >= 0 && jz <= n_cap) ? 0 : kNeg - gc_at(bits, jz, n_cap, gap);
    pack[u] = 0;
  }
  // the scan's fill: every lane but W - 1 (a thread's last) where W is a
  // power of two takes it (k <= span - 2)
  const int fill_last = k0 + LPT - 1 <= span - 2 ? kScanFill : INT_MIN;
  // this warp's rings: carries (read by warp + 1), first-lane H (read by
  // warp - 1); every slot at row 0, the first-lane H of row 0 published
  unsigned long long* carry_out = ring + 2 * R * warp;
  unsigned long long* first_out = carry_out + R;
  const unsigned long long* carry_in = carry_out - 2 * R;  // warp - 1's
  const unsigned long long* first_in = first_out + 2 * R;  // warp + 1's
  if (lane < 2 * R) carry_out[lane] = 0;
  __syncwarp();
  if (lane == 0) publish(first_out, 0, hp[0]);
  __syncthreads();  // the codes and the rings; the row loop has no other
#pragma unroll
  for (int u = 0; u < LPT; ++u) c[u] = col32_at(cs, dlo + k0 + u, n_cap);

  const bool has_left = warp > 0;
  const bool has_right = warp + 1 < nw;
  const bool band_end = k0 + LPT == W;  // the thread holds lane W - 1
  const bool live = k0 < W;             // not past the band's end
  int32_t* mrow = moves + static_cast<size_t>(b) * (m_cap / 16) * W + k0;
  // gc at the thread's lanes of the current row (where a row reaches the
  // matrix's edges)
  auto gc_lanes = [&](int (&g)[LPT]) {
    g[0] = gc0;
#pragma unroll
    for (int u = 1; u < LPT; ++u) g[u] = g[u - 1] + (c[u] >> 8);
  };
  // the thread's last lane of the row before: its scan value (carry and
  // fill in, its up candidate not), its diag candidate, the next thread's
  // first-lane H of the row before that, and whether the strip had lanes
  // outside columns 1 .. n_cap in that row
  int a_last = 0, d_last = 0, r_last = 0;
  bool edge_last = true;

  // row r's last lane takes its up candidate `right` + gap, its H and its
  // move (c and gc0 still row r's); the thread's words go out once row r
  // ends a block of 16 rows
  auto finish_last = [&](int r, int right, auto edge) {
    constexpr bool kEdge = decltype(edge)::value;
    const int up = right + gap;
    int h, mv;
    if constexpr (kEdge) {
      const int j = r + dlo + k0 + LPT - 1;
      int g[LPT];
      gc_lanes(g);
      h = (j >= 1 && j <= n_cap) ? max(a_last, up) : a_last;
      if (j < 0 || j > n_cap) h = kNeg - g[LPT - 1];
      mv = (h == d_last) ? 0 : ((h == up) ? 1 : 2);
      if (j < 1 || j > n_cap) mv = 3;
    } else {
      h = max(a_last, up);
      mv = (h == d_last) ? 0 : ((h == up) ? 1 : 2);
    }
    const int p = (r - 1) & 15;
    pack[LPT - 1] |= static_cast<uint32_t>(mv) << (2 * p);
    hp[LPT - 1] = h;
    if (p == 15) {
      if (live) store_words<LPT>(mrow + ((r - 1) >> 4) * W, pack);
#pragma unroll
      for (int u = 0; u < LPT; ++u) pack[u] = 0;
    }
  };
  // the right neighbour's first-lane H of row r: the next thread's by a
  // shuffle a row before, warp + 1's from its ring; NEG past lane W - 1
  auto right_of = [&](int r) {
    const int hr = has_right ? await_row(first_in + (r & (R - 1)), r) : kNeg;
    return band_end ? kNeg : (lane == 31 ? hr : r_last);
  };

  // one row of the strip; `edge` (std::true_type) where some lane of the
  // strip lies outside columns 1 .. n_cap, so that the rows in between
  // skip the tests of column 0 and of the matrix's edges
  auto row = [&](int i, auto edge) {
    constexpr bool kEdge = decltype(edge)::value;
    const int qc = qs[i - 1];
    const int other = qc == kPad ? kNeg : mismatch;  // tc != qc, tc real
    const int jb = i + dlo + k0;  // column of the thread's first lane
    if (i > 1) {
      // the window slides one column a row: lane k takes lane k + 1's
      // column value of the row before, the last lane reads its own
#pragma unroll
      for (int u = 0; u + 1 < LPT; ++u) c[u] = c[u + 1];
      c[LPT - 1] = kEdge ? col32_at(cs, jb + LPT - 2, n_cap) : cs[jb + LPT - 2];
    }
    gc0 += c[0] >> 8;
    // the next thread's first lane of the previous row: the up candidate
    // of this thread's last lane, taken when the next row starts
    const int above_last = __shfl_down_sync(kFull, hp[0], 1);
    int g[LPT];
    if constexpr (kEdge) gc_lanes(g);
    // per lane: diag and up candidates and the scan value, the best of
    // them; inside the matrix the move needs only the scan value and which
    // of diag and up won
    int diag_c[LPT], up_c[LPT], a[LPT], own[LPT], up_won[LPT];
#pragma unroll
    for (int u = 0; u < LPT; ++u) {
      const int tc = c[u] & 15;
      // PAD against a real base NEG, PAD against PAD a match
      const int sub = tc == qc ? match : (tc == kPad ? kNeg : other);
      diag_c[u] = hp[u] + sub - (c[u] >> 8);
      int cand = diag_c[u];
      if (u + 1 < LPT) {
        up_c[u] = hp[u + 1] + gap;
        up_won[u] = diag_c[u] < up_c[u];
        cand = max(cand, up_c[u]);
      }
      if constexpr (kEdge) {
        const int j = jb + u;
        if (j == 0) cand = i * gap;
        if (j < 0 || j > n_cap) cand = kNeg - g[u];
      }
      a[u] = own[u] = cand;
    }
    strip_incl_max<LPT>(a, lane);

    // the carry: the max over every lane left of the strip
    const int carry = has_left ? await_row(carry_in + (i & (R - 1)), i)
                               : INT_MIN;
    if (lane == 31 && has_right)
      publish(carry_out + (i & (R - 1)), i, max(carry, a[LPT - 1]));
    const int p = (i - 1) & 15;
#pragma unroll
    for (int u = 0; u + 1 < LPT; ++u) {
      int h = max(max(a[u], carry), kScanFill);
      int mv;
      if constexpr (kEdge) {
        const int j = jb + u;
        if (j < 0 || j > n_cap) h = kNeg - g[u];
        mv = (h == diag_c[u]) ? 0 : ((h == up_c[u]) ? 1 : 2);
        if (j < 1 || j > n_cap) mv = 3;
      } else {
        // h > own: the deletion chain won (h above both candidates)
        mv = h != own[u] ? 2 : up_won[u];
      }
      pack[u] |= static_cast<uint32_t>(mv) << (2 * p);
      hp[u] = h;
    }
    a_last = max(max(a[LPT - 1], carry), fill_last);
    d_last = diag_c[LPT - 1];
    r_last = above_last;
    edge_last = kEdge;
    if (lane == 0 && has_left) publish(first_out + (i & (R - 1)), i, hp[0]);
  };

  for (int i = 1; i <= m_cap; ++i) {
    if (i > 1) {
      const int right = right_of(i - 2);
      if (edge_last)
        finish_last(i - 1, right, std::true_type{});
      else
        finish_last(i - 1, right, std::false_type{});
    }
    const int jw = i + dlo + warp * S;  // column of the strip's first lane
    if (jw >= 1 && jw + S - 1 <= n_cap)
      row(i, std::false_type{});
    else
      row(i, std::true_type{});
  }
  finish_last(m_cap, right_of(m_cap - 1), std::true_type{});
  // H at the end lane: hg plus gc at its column, n_cap
#pragma unroll
  for (int u = 0; u < LPT; ++u)
    if (k0 + u == n_cap - m_cap - dlo)
      score[b] = hp[u] + gc_at(bits, n_cap, n_cap, gap);
}

}  // namespace

// band lanes per thread of the strip kernel at band width W > 256 and B
// items (geometry.sweep_lanes): eight where W is a multiple of 256 and
// the strips of eight still put 16 warps or more on each of the H100's 132
// SMs (the items of an SM one block each), where fewer instructions a
// cell win; else four, where more warps an item hide the row's latency
// (timed on the card, PERF.md)
static int strip_lanes(int W, int B) {
  const int items_per_sm = (B + 131) / 132;
  return (W % 256 == 0 && (W / 256) * items_per_sm >= 16) ? 8 : 4;
}

// warps per item of the strip kernel: strips of 32 * LPT lanes, the last
// one cut at W
static int strip_warps(int W, int B) {
  const int S = 32 * strip_lanes(W, B);
  return (W + S - 1) / S;
}

// shared bytes per block: the warp kernel's kSweepWarps slices of codes
// (W <= 256), or the strip kernel's hand-off rings and codes
// (geometry.sweep_launch)
extern "C" size_t rtt_nw_sweep_smem(int m_cap, int n_cap, int W, int B) {
  if (W <= 256) return static_cast<size_t>(kSweepWarps) * (m_cap + n_cap);
  return static_cast<size_t>(16 * kSweepRing) * strip_warps(W, B) +
         4 * n_cap + m_cap;
}

template <typename K>
static int raise_smem(K kernel, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem)));
}

template <int LPT>
static int launch_sweep(const uint8_t* q4, const uint8_t* t4,
                        const uint8_t* dcb, int32_t* moves, int32_t* score,
                        int B, int m_cap, int n_cap, int W, int match,
                        int mismatch, int gap, int span,
                        cudaStream_t stream) {
  const size_t smem = rtt_nw_sweep_smem(m_cap, n_cap, W, B);
  if (int e = raise_smem(nw_sweep_strip_kernel<LPT>, smem)) return e;
  nw_sweep_strip_kernel<LPT><<<B, 32 * strip_warps(W, B), smem, stream>>>(
      q4, t4, dcb, moves, score, m_cap, n_cap, W, match, mismatch, gap, span);
  return RTT_LAUNCH_STATUS();
}

template <int LPT>
static int launch_sweep_warp(const uint8_t* q4, const uint8_t* t4,
                             const uint8_t* dcb, int32_t* moves,
                             int32_t* score, int B, int m_cap, int n_cap,
                             int match, int mismatch, int gap, int span,
                             cudaStream_t stream) {
  const size_t smem = rtt_nw_sweep_smem(m_cap, n_cap, 32 * LPT, B);
  if (int e = raise_smem(nw_sweep_warp_kernel<LPT>, smem)) return e;
  const int blocks = (B + kSweepWarps - 1) / kSweepWarps;
  nw_sweep_warp_kernel<LPT><<<blocks, 32 * kSweepWarps, smem, stream>>>(
      q4, t4, dcb, moves, score, B, m_cap, n_cap, match, mismatch, gap,
      span);
  return RTT_LAUNCH_STATUS();
}

// q4 (B, m_cap/2) u8, t4 (B, n_cap/2) u8, dcb (B, n_cap/8) u8 ->
// moves (B, m_cap/16, W) i32, score (B,) i32. Requires W a multiple of
// 32 up to 4096 (the bindings take multiples of 64 above 1024 and of 128
// above 2048), m_cap % 16 == 0, n_cap % 32 == 0, dlo <= 0. W <= 256
// always runs the warp kernel, wider bands the strip kernel.
extern "C" int rtt_nw_sweep(const uint8_t* q4, const uint8_t* t4,
                            const uint8_t* dcb, int32_t* moves,
                            int32_t* score, int B, int m_cap, int n_cap,
                            int W, int match, int mismatch, int gap,
                            int span, cudaStream_t stream) {
  if (B == 0) return 0;
#define RTT_WARP_CASE(L)                                                  \
  case L:                                                                 \
    return launch_sweep_warp<L>(q4, t4, dcb, moves, score, B, m_cap,      \
                                n_cap, match, mismatch, gap, span, stream);
  if (W <= 256) {
    switch (W / 32) {
      RTT_WARP_CASE(1)
      RTT_WARP_CASE(2)
      RTT_WARP_CASE(3)
      RTT_WARP_CASE(4)
      RTT_WARP_CASE(5)
      RTT_WARP_CASE(6)
      RTT_WARP_CASE(7)
      RTT_WARP_CASE(8)
      default:
        return static_cast<int>(cudaErrorInvalidValue);
    }
  }
#undef RTT_WARP_CASE
  switch (strip_lanes(W, B)) {
    case 4:
      return launch_sweep<4>(q4, t4, dcb, moves, score, B, m_cap, n_cap, W,
                             match, mismatch, gap, span, stream);
    case 8:
      return launch_sweep<8>(q4, t4, dcb, moves, score, B, m_cap, n_cap, W,
                             match, mismatch, gap, span, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* rtt_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

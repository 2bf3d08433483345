// Banded Myers/Hyyro bit-parallel edit-distance sweep.
//
// Replaces racon_tpu/ops/myers_kernel.py::myers_sweep_t (body
// _myers_sweep_kernel) and its Peq build build_peq_win_T, folded in here.
// Band lane k of row i is target column j = i + dlo + k, W bits in
// nw = W/32 words. Per row: Eq is the W-bit window of the query code's Peq
// plane at bit i + dlo - 1 + guard; PV/MV/Eq are cleared at and below the
// j = 0 lane kz = -(i + dlo); the multi-word add XP + PV carries across
// words; the j = 0 column's vertical delta is forced to +1; the row emits
// DIAG = Eq | ~D0 and UP = HP; PV/MV shift one bit down for the next row
// with PV's top bit filled with 1 and MV's with 0. Planes are laid out
// (B, m_cap, 2, nw) uint32 -- the reference's myers_sweep_ref returns the
// same words as (m_cap, 2, nw, B).
//
// Design on the H100: one warp per item and one item per block
// (geometry.myers_sweep_launch), so the align stage's chunk of up to 1024
// items covers all 132 SMs. Each lane owns WPL consecutive
// words (WPL = 1 up to W = 1024, 2 at 2048, 4 at 4096). The item's six
// Peq planes (n_cap + W + 64 bits each) are built in shared memory from
// the nibble codes. What bounds it: the per-row dependent chain of the
// DP state -- latency, at a few warps per SM -- and the plane stores
// (W/4 bytes a row, coalesced): at (10240,1024) 2.6 MB an item. What the
// design does about the chain:
//  - Eq leaves it: the next row's Eq words are loaded and funnel-shifted
//    while this row's chain runs (a register double buffer). The query
//    codes sit in registers, one 32-bit word of 8 codes a lane (256 rows
//    a warp, the next 256 loaded a chunk ahead); a row's code is one
//    shuffle, also off the chain.
//  - The band shift is one shuffle, not four. The reference shifts HP
//    and HN up one bit and then PVn and MVn down one; composed, that is
//    D0 shifted down: with D0s = D0 >> 1 (bit 31 from the next word's
//    bit 0), PV' = HN | ~(D0s | HP) and MV' = D0s & HP, the top bit of
//    the band forced to 1 and 0.
//  - The cross-word carry is a ripple inside a lane plus one pair of warp
//    ballots: with lane-level generate G and propagate P as 32-bit masks,
//    the carries into all lanes are ((G|P) + G) ^ (G|P) ^ G.
//  - The rows 1..-dlo, where the j = 0 lane lies in the band, run the
//    masks; the rows below run without them.
// Words at or above nw (W < 1024 leaves lanes idle; W = 1120 a word)
// compute garbage that only ever moves up -- carries and ballot bits go
// toward higher lanes, and the one shuffle feeds the band's top bit,
// which is forced -- and are never stored.
#include "common.cuh"

namespace {

using namespace rtt;

constexpr uint32_t kTopBit = 0x80000000u;

// One lane's word of 8 query codes of the 256-row chunk c (rows 256c + 8
// lane + 1 ..), 0 past the row's m_cap/2 bytes (a multiple of 16).
__device__ __forceinline__ uint32_t load_codes(const uint8_t* qrow,
                                               int qbytes, int c, int lane) {
  const int off = c * 128 + lane * 4;
  return off < qbytes ? *reinterpret_cast<const uint32_t*>(qrow + off) : 0u;
}

template <int WPL>
struct SweepState {
  uint32_t PV[WPL], MV[WPL];
  uint32_t raw[WPL + 1];  // Peq words of the current row's Eq window
  int code1;              // query code of the next row
  uint32_t qcur;          // codes of the current 256-row chunk (8 a lane)
  uint32_t qnxt;          // codes of the chunk after it
};

struct SweepGeo {
  const uint32_t* peq;  // the item's six Peq planes (shared memory)
  const uint8_t* qrow;  // the item's query codes (global memory)
  uint32_t* out;        // the item's planes (global memory)
  int nwp, nw, qbytes, dlo, guard, lane;
};

// Query code r (row r + 1) from the chunk the lane words hold.
__device__ __forceinline__ int code_at(uint32_t qcur, int r) {
  return (__shfl_sync(kFull, qcur, (r >> 3) & 31) >> (4 * (r & 7))) & 15;
}

// The lane's WPL Peq words, and the one above them, of row i's Eq window
// (at bit i + dlo - 1 + guard) in the plane of code c; codes past 5 read
// nothing. Rows past m_cap read code 0 in range: the window's top word
// stays below peq_words.
template <int WPL>
__device__ __forceinline__ void load_window(uint32_t (&raw)[WPL + 1],
                                            const SweepGeo& g, int c, int i) {
  const uint32_t* plane =
      g.peq + c * g.nwp + ((i + g.dlo - 1 + g.guard) >> 5);
  const int w0 = g.lane * WPL;
#pragma unroll
  for (int x = 0; x <= WPL; ++x)
    raw[x] = (c < 6 && w0 + x <= g.nw) ? plane[w0 + x] : 0u;
}

// Row i of the sweep, software-pipelined: it funnel-shifts the Eq words
// loaded by the row before, loads row i + 1's and shuffles out row
// i + 2's query code -- each consumed an iteration later, so no load or
// shuffle result is waited for inside the row -- then runs the DP chain.
// EDGE: the j = 0 lane kz = -(i + dlo) may lie at or above band lane 0
// (rows i <= -dlo), so the keep mask and the boundary fix apply; below,
// both are identities and are left out.
template <int WPL, bool EDGE>
__device__ __forceinline__ void sweep_row(SweepState<WPL>& st,
                                          const SweepGeo& g,
                                          const uint32_t (&top)[WPL],
                                          int i) {
  const int r = (i + g.dlo - 1 + g.guard) & 31;
  const int w0 = g.lane * WPL;
  uint32_t eq[WPL];
#pragma unroll
  for (int x = 0; x < WPL; ++x)
    eq[x] = w0 + x < g.nw ? __funnelshift_r(st.raw[x], st.raw[x + 1], r)
                          : 0u;
  load_window<WPL>(st.raw, g, st.code1, i + 1);
  if (((i + 1) & 255) == 0) {  // row i + 2 opens the next chunk
    st.qcur = st.qnxt;
    st.qnxt = load_codes(g.qrow, g.qbytes, ((i + 1) >> 8) + 1, g.lane);
  }
  st.code1 = code_at(st.qcur, i + 1);
  const int kz = -(i + g.dlo);
  uint32_t oh[WPL];
  if constexpr (EDGE) {
#pragma unroll
    for (int x = 0; x < WPL; ++x) {
      const int w = g.lane * WPL + x;
      const uint32_t keep = mask_ge(kz + 1, w);
      st.PV[x] &= keep;
      st.MV[x] &= keep;
      eq[x] &= keep;
      oh[x] = onehot(kz, w);
    }
  }
  uint32_t X[WPL], S[WPL];
  bool gx[WPL], px[WPL];
  bool G = false;
  bool P = true;
#pragma unroll
  for (int x = 0; x < WPL; ++x) {
    X[x] = eq[x] | st.MV[x];
    const uint32_t xp = X[x] & st.PV[x];
    S[x] = xp + st.PV[x];
    gx[x] = S[x] < xp;
    px[x] = S[x] == kFull;
    G = gx[x] || (px[x] && G);
    P = P && px[x];
  }
  // carries into every lane in one add over the lane masks
  const uint32_t Gm = __ballot_sync(kFull, G);
  const uint32_t Am = Gm | __ballot_sync(kFull, P);
  bool c = (((Am + Gm) ^ Am ^ Gm) >> g.lane) & 1u;
  uint32_t D0[WPL], HP[WPL], HN[WPL];
#pragma unroll
  for (int x = 0; x < WPL; ++x) {
    const uint32_t s = S[x] + (c ? 1u : 0u);
    c = gx[x] || (px[x] && c);
    D0[x] = (s ^ st.PV[x]) | X[x];
    HN[x] = st.PV[x] & D0[x];
    HP[x] = st.MV[x] | ~(st.PV[x] | D0[x]);
    if constexpr (EDGE) {
      HP[x] |= oh[x];
      HN[x] &= ~oh[x];
    }
  }
  // the band shift: D0 one bit down, bit 31 from the next word's bit 0
  const uint32_t d0_above = __shfl_down_sync(kFull, D0[0], 1);
#pragma unroll
  for (int x = 0; x < WPL; ++x) {
    const uint32_t next = x < WPL - 1 ? D0[x + 1 < WPL ? x + 1 : x]
                                      : d0_above;
    const uint32_t D0s = __funnelshift_r(D0[x], next, 1);
    st.PV[x] = (HN[x] | ~(D0s | HP[x])) | top[x];
    st.MV[x] = D0s & HP[x] & ~top[x];
  }
  // this row's DIAG and UP words, coalesced across the warp
  uint32_t* orow = g.out + static_cast<size_t>(i - 1) * 2 * g.nw;
  uint32_t diag[WPL];
#pragma unroll
  for (int x = 0; x < WPL; ++x) diag[x] = eq[x] | ~D0[x];
  // vector stores where both planes' rows stay 8- or 16-byte aligned
  if constexpr (WPL == 4) {
    if ((g.nw & 3) == 0 && w0 + 4 <= g.nw) {
      *reinterpret_cast<uint4*>(orow + w0) =
          make_uint4(diag[0], diag[1], diag[2], diag[3]);
      *reinterpret_cast<uint4*>(orow + g.nw + w0) =
          make_uint4(HP[0], HP[1], HP[2], HP[3]);
      return;
    }
  } else if constexpr (WPL == 2) {
    if ((g.nw & 1) == 0 && w0 + 2 <= g.nw) {
      *reinterpret_cast<uint2*>(orow + w0) = make_uint2(diag[0], diag[1]);
      *reinterpret_cast<uint2*>(orow + g.nw + w0) = make_uint2(HP[0], HP[1]);
      return;
    }
  }
#pragma unroll
  for (int x = 0; x < WPL; ++x) {
    if (w0 + x < g.nw) {
      orow[w0 + x] = diag[x];
      orow[g.nw + w0 + x] = HP[x];
    }
  }
}

template <int WPL>
__global__ void __launch_bounds__(32)
    myers_sweep_kernel(const uint8_t* __restrict__ q4,
                       const uint8_t* __restrict__ t4,
                       uint32_t* __restrict__ planes, int m_cap, int n_cap,
                       int W) {
  extern __shared__ uint32_t peq[];
  const int lane = threadIdx.x;
  const int b = blockIdx.x;
  SweepGeo g;
  g.nw = W / 32;
  g.guard = W / 2 + 32;
  g.nwp = (n_cap + 2 * g.guard) / 32;
  g.dlo = n_cap - m_cap - W / 2;
  g.qbytes = m_cap / 2;
  g.lane = lane;
  g.peq = peq;
  g.qrow = q4 + static_cast<size_t>(b) * g.qbytes;
  g.out = planes + static_cast<size_t>(b) * m_cap * 2 * g.nw;

  // Peq planes: bit p of plane c = [t[p - guard] == c]
  const uint8_t* trow = t4 + static_cast<size_t>(b) * (n_cap / 2);
  for (int p = lane; p < g.nwp; p += 32) {
    uint32_t acc[6] = {0, 0, 0, 0, 0, 0};
    for (int bit = 0; bit < 32; ++bit) {
      const int pos = 32 * p + bit - g.guard;
      if (pos < 0 || pos >= n_cap) continue;
      const int c = nib(trow, pos);
#pragma unroll
      for (int cc = 0; cc < 6; ++cc)
        acc[cc] |= static_cast<uint32_t>(c == cc) << bit;
    }
#pragma unroll
    for (int cc = 0; cc < 6; ++cc) peq[cc * g.nwp + p] = acc[cc];
  }
  __syncwarp();

  SweepState<WPL> st;
  uint32_t top[WPL];
#pragma unroll
  for (int x = 0; x < WPL; ++x) {
    const int w = lane * WPL + x;
    st.PV[x] = w < g.nw ? mask_ge(-g.dlo, w) : 0u;
    st.MV[x] = 0u;
    top[x] = w == g.nw - 1 ? kTopBit : 0u;
  }
  st.qcur = load_codes(g.qrow, g.qbytes, 0, lane);
  st.qnxt = load_codes(g.qrow, g.qbytes, 1, lane);
  load_window<WPL>(st.raw, g, code_at(st.qcur, 0), 1);
  st.code1 = code_at(st.qcur, 1);
  const int edge_rows = min(m_cap, -g.dlo);
  for (int i = 1; i <= edge_rows; ++i) sweep_row<WPL, true>(st, g, top, i);
  for (int i = edge_rows + 1; i <= m_cap; ++i)
    sweep_row<WPL, false>(st, g, top, i);
}

template <int WPL>
int launch(const uint8_t* q4, const uint8_t* t4, uint32_t* planes, int B,
           int m_cap, int n_cap, int W, cudaStream_t stream) {
  const int nwp = (n_cap + W + 64) / 32;
  const size_t smem = static_cast<size_t>(6) * nwp * 4;
  if (smem > 48 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  myers_sweep_kernel<WPL><<<B, 32, smem, stream>>>(q4, t4, planes, m_cap,
                                                   n_cap, W);
  return RTT_LAUNCH_STATUS();
}

}  // namespace

// q4 (B, m_cap/2) u8, t4 (B, n_cap/2) u8 -> planes (B, m_cap, 2, W/32)
// i32. Requires W % 32 == 0, W <= 4096, equal caps (dlo = -W/2), m_cap a
// multiple of 32, and the Peq mask of one item within 48 KB of shared
// memory (geometry.myers_fits).
extern "C" int rtt_myers_sweep(const uint8_t* q4, const uint8_t* t4,
                               int32_t* planes, int B, int m_cap, int n_cap,
                               int W, cudaStream_t stream) {
  if (B == 0) return 0;
  uint32_t* p = reinterpret_cast<uint32_t*>(planes);
  const int nw = W / 32;
  if (nw <= 32) return launch<1>(q4, t4, p, B, m_cap, n_cap, W, stream);
  if (nw <= 64) return launch<2>(q4, t4, p, B, m_cap, n_cap, W, stream);
  if (nw <= 128) return launch<4>(q4, t4, p, B, m_cap, n_cap, W, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

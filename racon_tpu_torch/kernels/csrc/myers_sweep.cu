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
// Design on the H100: one warp per item, each lane owning WPL consecutive
// words (WPL = 1 up to W = 1024, 4 at W = 4096). The cross-word carry is a
// ripple inside a lane plus one warp ballot: with lane-level generate G and
// propagate P as 32-bit masks, the carries into all lanes are
// ((G|P) + G) ^ (G|P) ^ G. One-bit shifts cross lanes by shuffle. The
// item's six Peq planes (n_cap + W + 64 bits each) are built in shared
// memory from the nibble codes. What bounds it: ~25 dependent integer ops
// and two shuffles plus a ballot per row -- latency per warp -- and the
// plane stores (W/4 bytes per row), which are coalesced.
#include "common.cuh"

namespace {

using namespace rtt;

template <int WPL>
__global__ void myers_sweep_kernel(const uint8_t* __restrict__ q4,
                                   const uint8_t* __restrict__ t4,
                                   uint32_t* __restrict__ planes, int B,
                                   int m_cap, int n_cap, int W,
                                   int items_per_block) {
  extern __shared__ uint32_t peq_all[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * items_per_block + warp;
  if (b >= B) return;  // whole warps only; no block barrier below
  const int nw = W / 32;
  const int guard = W / 2 + 32;
  const int nwp = (n_cap + 2 * guard) / 32;
  const int dlo = n_cap - m_cap - W / 2;
  uint32_t* peq = peq_all + static_cast<size_t>(warp) * 6 * nwp;

  // Peq planes: bit p of plane c = [t[p - guard] == c]
  const uint8_t* trow = t4 + static_cast<size_t>(b) * (n_cap / 2);
  for (int p = lane; p < nwp; p += 32) {
    uint32_t acc[6] = {0, 0, 0, 0, 0, 0};
    for (int bit = 0; bit < 32; ++bit) {
      const int pos = 32 * p + bit - guard;
      if (pos < 0 || pos >= n_cap) continue;
      const int c = nib(trow, pos);
#pragma unroll
      for (int cc = 0; cc < 6; ++cc)
        acc[cc] |= static_cast<uint32_t>(c == cc) << bit;
    }
#pragma unroll
    for (int cc = 0; cc < 6; ++cc) peq[cc * nwp + p] = acc[cc];
  }
  __syncwarp();

  uint32_t PV[WPL], MV[WPL];
#pragma unroll
  for (int x = 0; x < WPL; ++x) {
    const int w = lane * WPL + x;
    PV[x] = w < nw ? mask_ge(-dlo, w) : 0u;
    MV[x] = 0u;
  }
  const uint8_t* qrow = q4 + static_cast<size_t>(b) * (m_cap / 2);
  uint32_t* out = planes + static_cast<size_t>(b) * m_cap * 2 * nw;

  for (int i = 1; i <= m_cap; ++i) {
    const int qc = nib(qrow, i - 1);
    const int kz = -(i + dlo);
    const int pos0 = i + dlo - 1 + guard;
    const int w0 = pos0 >> 5;
    const int r = pos0 & 31;
    const uint32_t* plane = peq + qc * nwp + w0;

    uint32_t eq[WPL], X[WPL], S[WPL];
    bool gx[WPL], px[WPL];
    bool G = false;
    bool P = true;
#pragma unroll
    for (int x = 0; x < WPL; ++x) {
      const int w = lane * WPL + x;
      uint32_t e = 0u;
      if (w < nw && qc < 6) {
        const uint32_t lo = plane[w];
        const uint32_t hi = plane[w + 1];
        e = r ? ((lo >> r) | (hi << (32 - r))) : lo;
      }
      const uint32_t keep = w < nw ? mask_ge(kz + 1, w) : 0u;
      PV[x] &= keep;
      MV[x] &= keep;
      eq[x] = e & keep;
      X[x] = eq[x] | MV[x];
      const uint32_t xp = X[x] & PV[x];
      S[x] = xp + PV[x];
      gx[x] = S[x] < xp;
      px[x] = S[x] == kFull;
      G = gx[x] || (px[x] && G);
      P = P && px[x];
    }
    if (lane * WPL >= nw) G = P = false;
    // carries into every lane in one add over the lane masks
    const uint32_t Gm = __ballot_sync(kFull, G);
    const uint32_t Am = Gm | __ballot_sync(kFull, P);
    bool c = (((Am + Gm) ^ Am ^ Gm) >> lane) & 1u;
    uint32_t D0[WPL], HP[WPL], HN[WPL];
#pragma unroll
    for (int x = 0; x < WPL; ++x) {
      const int w = lane * WPL + x;
      const uint32_t s = S[x] + (c ? 1u : 0u);
      c = gx[x] || (px[x] && c);
      D0[x] = (s ^ PV[x]) | X[x];
      HN[x] = PV[x] & D0[x];
      HP[x] = MV[x] | ~(PV[x] | D0[x]);
      const uint32_t oh = onehot(kz, w);
      HP[x] |= oh;
      HN[x] &= ~oh;
    }
    // one-bit shifts toward higher bits (bit 0 of word 0 filled with 0)
    const uint32_t hp_below = __shfl_up_sync(kFull, HP[WPL - 1], 1);
    const uint32_t hn_below = __shfl_up_sync(kFull, HN[WPL - 1], 1);
    uint32_t PVn[WPL], MVn[WPL];
#pragma unroll
    for (int x = 0; x < WPL; ++x) {
      const uint32_t hp_prev = x > 0 ? HP[x - 1] : (lane ? hp_below : 0u);
      const uint32_t hn_prev = x > 0 ? HN[x - 1] : (lane ? hn_below : 0u);
      const uint32_t X2 = (HP[x] << 1) | (hp_prev >> 31);
      const uint32_t HNs = (HN[x] << 1) | (hn_prev >> 31);
      PVn[x] = HNs | ~(D0[x] | X2);
      MVn[x] = D0[x] & X2;
    }
    uint32_t* orow = out + static_cast<size_t>(i - 1) * 2 * nw;
#pragma unroll
    for (int x = 0; x < WPL; ++x) {
      const int w = lane * WPL + x;
      if (w < nw) {
        orow[w] = eq[x] | ~D0[x];
        orow[nw + w] = HP[x];
      }
    }
    // one-bit shift toward lower bits for the next row's band
    const uint32_t pv_above = __shfl_down_sync(kFull, PVn[0], 1);
    const uint32_t mv_above = __shfl_down_sync(kFull, MVn[0], 1);
#pragma unroll
    for (int x = 0; x < WPL; ++x) {
      const int w = lane * WPL + x;
      const uint32_t pv_next = x < WPL - 1 ? PVn[x + 1] : pv_above;
      const uint32_t mv_next = x < WPL - 1 ? MVn[x + 1] : mv_above;
      const uint32_t pv_hi = w == nw - 1 ? 1u : (pv_next & 1u);
      const uint32_t mv_hi = w == nw - 1 ? 0u : (mv_next & 1u);
      PV[x] = w < nw ? ((PVn[x] >> 1) | (pv_hi << 31)) : 0u;
      MV[x] = w < nw ? ((MVn[x] >> 1) | (mv_hi << 31)) : 0u;
    }
  }
}

template <int WPL>
int launch(const uint8_t* q4, const uint8_t* t4, uint32_t* planes, int B,
           int m_cap, int n_cap, int W, cudaStream_t stream) {
  const int nwp = (n_cap + W + 64) / 32;
  const size_t per_item = static_cast<size_t>(6) * nwp * 4;
  if (per_item > 48 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  int ipb = static_cast<int>((48 * 1024) / per_item);
  ipb = ipb > 8 ? 8 : ipb;
  const int blocks = (B + ipb - 1) / ipb;
  myers_sweep_kernel<WPL><<<blocks, 32 * ipb, per_item * ipb, stream>>>(
      q4, t4, planes, B, m_cap, n_cap, W, ipb);
  return RTT_LAUNCH_STATUS();
}

}  // namespace

// q4 (B, m_cap/2) u8, t4 (B, n_cap/2) u8 -> planes (B, m_cap, 2, W/32)
// i32. Requires W % 32 == 0, W <= 4096, equal caps (dlo = -W/2), and the
// Peq mask of one item within 48 KB of shared memory.
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

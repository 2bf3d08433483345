"""The work a packed2 or rows walk did, read back from its payload: the
steps or rows each item's walk took, and the distinct move words its path
needs. chip_smoke.py and benchmarks/kernel_ab.py compute the walks'
least-time bounds from these, so that both count the same bytes.

A move word holds 16 query rows of one band lane (the scored sweep's
layout (B, m_cap/16, W)), so a walk that stays on a lane for several
rows, or comes back to a word, needs that word once. Host-side numpy;
payloads may be tensors (copied to the host) or arrays.
"""

from __future__ import annotations

import numpy as np

from .geometry import PACK, REC_UP, band_dlo


def _np(x) -> np.ndarray:
    """A tensor (on any device) or array as a host array."""
    return x.cpu().numpy() if hasattr(x, "cpu") else np.asarray(x)


def walk_units(payload, name: str, m) -> np.ndarray:
    """Per item, the steps (packed2, name "packed_walk": codes other than
    skip, and the escaping step) or rows (rows, "rows_walk": the records
    written, and the escaping row) its walk took."""
    p = _np(payload)
    esc = p[:, -1].astype(np.int64)
    if name == "packed_walk":
        codes = np.stack([(p[:, :-1] >> s) & 3 for s in (0, 2, 4, 6)], -1)
        return (codes != 3).reshape(len(p), -1).sum(1) + esc
    recs = (p[:, :-2] != 0).sum(1)
    return recs + ((esc != 0) & (recs < np.minimum(_np(m), p.shape[1] - 2)))


def packed_path(payload, m, n, cap: int, W: int) -> tuple[int, int]:
    """(steps, distinct move words) of the packed2 walk on this payload
    ((B, S/4 + 1) bytes, m_cap = n_cap = cap). Steps: codes other than
    skip, and the escaping step. Words: each (item, 16-row word-row, lane)
    that a step inside the matrix (i > 0, j > 0) reads, and the word of an
    escape on code 3 (the cell after the last step, inside the band and
    the step budget); a diagonal run inside one word reads it once."""
    p = _np(payload)
    B, S = p.shape[0], 4 * (p.shape[1] - 1)
    if B == 0:
        return 0, 0
    codes = np.stack([(p[:, :-1] >> s) & 3 for s in (0, 2, 4, 6)],
                     -1).reshape(B, S)
    live = codes != 3
    di = (live & (codes != 2)).astype(np.int32)
    dj = (live & (codes != 1)).astype(np.int32)
    dk = (codes == 1).astype(np.int32) - (codes == 2)
    m = _np(m).astype(np.int64)[:, None]
    n = _np(n).astype(np.int64)[:, None]
    k0 = n - m - band_dlo(cap, cap, W)
    # the cell each step leaves, and the cell after the last one
    i = m - np.cumsum(di, 1) + di
    j = n - np.cumsum(dj, 1) + dj
    k = k0 + np.cumsum(dk, 1) - dk
    per_item = (cap // PACK) * W
    item = np.arange(B, dtype=np.int64)[:, None]
    read = live & (i > 0) & (j > 0)
    keys = [(item * per_item + (i - 1) // PACK * W + k)[read]]
    steps = live.sum(1)
    ie = m[:, 0] - di.sum(1)
    je = n[:, 0] - dj.sum(1)
    ke = k0[:, 0] + dk.sum(1)
    code3 = ((p[:, -1] != 0) & (steps < S) & (ie > 0) & (je > 0)
             & (ke >= 0) & (ke < W))
    e = np.flatnonzero(code3)
    keys.append(e * per_item + (ie[e] - 1) // PACK * W + ke[e])
    nsteps = int(steps.sum() + (p[:, -1] != 0).sum())
    return nsteps, int(np.unique(np.concatenate(keys)).size)


def rows_path(payload, m, n, cap: int, W: int) -> tuple[int, int]:
    """(rows walked, distinct move words) of the rows walk on this payload
    ((B, cap + 2) bytes, m_cap = n_cap = cap), traced from its records:
    per row the lanes from the current one down to the deletion run's exit
    (the lane of column 0 is UP without a read); an escaping row, the word
    it stands on where its lane is in the band."""
    p = _np(payload)
    B = p.shape[0]
    dlo = band_dlo(cap, cap, W)
    m = _np(m).astype(np.int64)
    top = np.minimum(m, cap)
    k = _np(n).astype(np.int64) - m - dlo
    alive = np.ones(B, bool)
    per_item = (cap // PACK) * W
    words, rows = [], 0
    for i in range(int(top.max(initial=0)), 0, -1):
        act = alive & (top >= i)
        rec = p[:, i - 1].astype(np.int64)
        base = (i - 1) // PACK * W
        esc = act & (rec == 0)
        alive &= ~esc
        e = np.flatnonzero(esc & (k >= 0) & (k < W))
        words.append(e * per_item + base + k[e])
        b = np.flatnonzero(act & (rec != 0))
        rows += int(act.sum())
        kk, left = k[b], rec[b] >> 2
        cnt = left + 1 - (kk - left == -(i + dlo))
        first = np.repeat(np.cumsum(cnt) - cnt, cnt)
        lanes = np.repeat(kk, cnt) - (np.arange(int(cnt.sum())) - first)
        words.append(np.repeat(b, cnt) * per_item + base + lanes)
        k[b] = kk - left + ((rec[b] & 3) == REC_UP)
    nwords = np.unique(np.concatenate(words)).size if words else 0
    return rows, int(nwords)

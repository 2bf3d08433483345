"""The warp designs of the packed2 walk (kernels/csrc/packed_walk.cu, J4)
and the rows walk (kernels/csrc/rows_walk.cu, K6) as numpy models, held
byte for byte (tolerance 0: integer walks) against the plain versions
packed_walk_plain / rows_walk_plain, which are held here against the JAX
package's walk_moves_device(packed=True) and walk_rows_ref on the same
moves.

packed2: one warp an item streams 16-row word-rows into a ring of slots,
each a window of lanes centred on the walk's lane when it is fetched (a
lane outside it is read from the moves); each link of its chain inside
the matrix is a run of diagonal codes (leading zero 2-bit fields) or one
up or left step; the walk along row 0 or column 0 comes last, in one go;
code words are staged in a buffer that is copied out whenever it fills;
then the 0xFF tail and the flag.
rows: a ring of word-rows; the row step by the highest "not LEFT" bit at
or below the walk's lane in bit planes of its 32-lane group, read before
it is known that the group is in planes this word-row; the out-of-line
step that turns a group into bit planes (a five-step shuffle transpose)
at its first use in a word-row and takes two more groups down; records
flushed 32 rows at a time. Every payload byte of the models starts as
0x55, so a byte that the design never writes shows. Moves come from the
port's plain sweep, and from random and hand-made move words that reach
every rule: all-PAD items, m < 16 and m not a multiple of 16, a small
step budget, k leaving the band, code 3, row 0 and column 0, deletion
runs of exactly 63 and 64 lanes and runs across 32-lane groups. The
launch geometry mirrors the kernels' constants."""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from racon_tpu.ops.nw_kernel import (encode, pack_codes4, pack_delbits,
                                     walk_moves_device, walk_rows_ref)
from racon_tpu_torch.ops import geometry
from racon_tpu_torch.ops import nw_kernel as port
from racon_tpu_torch.ops.batch import to_device

torch.set_num_threads(2)
ACGT = np.frombuffer(b"ACGT", np.uint8)
M32 = 0xFFFFFFFF
SENTINEL = 0x55
_CSRC = Path(geometry.__file__).parents[1] / "kernels" / "csrc"


def _clz32(x):
    return 32 - int(x).bit_length()


# ------------------------------------------------------------ the models


def packed_warp_model(moves, m, n, *, m_cap, n_cap, w_band, max_steps,
                      lanes=None, slots=None, stage_bytes=None):
    """packed_walk.cu's warp, item by item: lanes, slots and stage_bytes
    default to the kernel's (PACKED_WALK_LANES, PACKED_WALK_SLOTS,
    PACKED_WALK_STAGE)."""
    W, S = w_band, max_steps
    L = min(W, lanes or geometry.PACKED_WALK_LANES)
    G = slots or geometry.PACKED_WALK_SLOTS
    SW = (stage_bytes or geometry.PACKED_WALK_STAGE) // 4
    dlo = geometry.band_dlo(m_cap, n_cap, W)
    rows = m_cap // 16
    words = np.asarray(moves).astype(np.int64) & M32
    B = len(m)
    out = np.full((B, S // 4 + 1), SENTINEL, np.uint8)
    for b in range(B):
        i, j = int(m[b]), int(n[b])
        k = j - i - dlo
        ring = np.zeros((G, L), np.int64)
        base = [0] * G
        stage = np.zeros(SW, np.uint32)

        def fetch(r):
            if 0 <= r < rows:
                lo = min(max(k - L // 2, 0), W - L) & ~3
                base[r % G] = lo
                ring[r % G] = words[b, r, lo:lo + L]

        def emit(wi, acc):
            stage[wi % SW] = acc
            if wi % SW == SW - 1:
                p0 = 4 * (wi - (SW - 1))
                out[b, p0:p0 + 4 * SW] = stage.view(np.uint8)

        rtop = (i - 1) >> 4 if i >= 1 else 0
        for g in range(G - 1):
            fetch(rtop - g)
        s, acc, esc = 0, 0, False
        for r in range(rtop, -1, -1):
            fetch(r - (G - 1))
            slot, lo = r % G, base[r % G]
            while i > 16 * r and j > 0 and s < S:
                if not 0 <= k < W:
                    esc = True
                    break
                off = k - lo
                word = int(ring[slot, off] if 0 <= off < L
                           else words[b, r, k])
                sh = 2 * ((i - 1) & 15)
                x = ((word << (30 - sh)) & M32) | ((1 << (30 - sh)) - 1)
                mv = x >> 30
                if mv == 3:
                    esc = True
                    break
                n_ = 1 if mv else min(_clz32(x) >> 1, j, S - s)
                acc |= mv << (2 * (s & 15))
                if (s + n_) >> 4 != s >> 4:
                    emit(s >> 4, acc)
                    acc = 0
                s += n_
                i -= 0 if mv == 2 else n_
                j -= 0 if mv == 1 else n_
                k += (mv == 1) - (mv == 2)
            if esc or i == 0 or j == 0 or s >= S:
                break
        if not esc:
            c = 1 if j == 0 else 2
            n_ = min(i if j == 0 else j, S - s)
            if c == 1:
                i -= n_
            else:
                j -= n_
            for _ in range(n_):
                acc |= c << (2 * (s & 15))
                if s & 15 == 15:
                    emit(s >> 4, acc)
                    acc = 0
                s += 1
        wi = s >> 4
        p0, p1 = 4 * (wi & ~(SW - 1)), 4 * wi
        if s & 15:
            stage[wi % SW] = (acc | (M32 << (2 * (s & 15)))) & M32
            p1 = min(p1 + 4, S // 4)
        out[b, p0:p1] = stage.view(np.uint8)[:p1 - p0]
        out[b, p1:S // 4] = 0xFF
        out[b, S // 4] = esc or i != 0 or j != 0
    return out


def transpose32(x):
    """common.cuh's transpose32 over a warp: x[t] is lane t's word; lane c
    gets bit t = bit c of x[t]."""
    x = [int(v) & M32 for v in x]
    s = 16
    for mk in (0x0000FFFF, 0x00FF00FF, 0x0F0F0F0F, 0x33333333, 0x55555555):
        y = [x[lane ^ s] for lane in range(32)]
        x = [((x[l] & ~mk & M32) | ((y[l] >> s) & mk)) if l & s
             else ((x[l] & mk) | ((y[l] & mk) << s)) & M32
             for l in range(32)]
        s >>= 1
    return x


def _onehot(pos, w):
    rel = pos - 32 * w
    return 1 << rel if 0 <= rel < 32 else 0


def _mask_ge(pos, w):
    sh = pos - 32 * w
    return M32 if sh <= 0 else (0 if sh >= 32 else (M32 << sh) & M32)


def rows_warp_model(moves, m, n, *, m_cap, n_cap, w_band, seed=0):
    """rows_walk.cu's warp, item by item. The bit planes start each
    word-row as noise, so a group read before it is transposed shows."""
    W = w_band
    nw = W // 32
    G = geometry.ROWS_WALK_SLOTS
    dlo = geometry.band_dlo(m_cap, n_cap, W)
    words = np.asarray(moves).astype(np.int64) & M32
    noise = np.random.default_rng(seed)
    B = len(m)
    out = np.full((B, m_cap + 2), SENTINEL, np.uint8)
    for b in range(B):
        top = min(max(int(m[b]), 0), m_cap)
        kvec = int(n[b]) - int(m[b]) - dlo
        ring = np.zeros((G, W), np.int64)

        def fetch(g):
            if g >= 0:
                ring[g % G] = words[b, g]

        gtop = (top - 1) >> 4 if top >= 1 else -1
        for q in range(G - 1):
            fetch(gtop - q)
        out[b, (top + 31) & ~31:m_cap] = 0
        esc, rec, i = False, [0] * 32, top
        for g in range(gtop, -1, -1):
            fetch(g - (G - 1))
            raw = ring[g % G]
            planes = noise.integers(0, 1 << 32, W)
            wlo = min(max((kvec >> 5) - 30, 0), max(nw - 32, 0))
            done = 0

            def step_slow(done, kvec, kz, r):
                if not 0 <= kvec < W:
                    return -1, done
                w = kvec >> 5
                for gw in range(w, max(w - 3, -1), -1):
                    rel = gw - wlo
                    if not (0 <= rel < 32 and done >> rel & 1):
                        planes[32 * gw:32 * gw + 32] = transpose32(
                            raw[32 * gw:32 * gw + 32])
                        if 0 <= rel < 32:
                            done |= 1 << rel
                    lo, hi = (int(v) for v in planes[32 * gw + 2 * r:
                                                     32 * gw + 2 * r + 2])
                    oh = _onehot(kz, gw)
                    below = (M32 >> (31 - (kvec & 31)) if gw == w
                             else _mask_ge(kvec - 63, gw))
                    nl = ((~hi & M32) | lo | oh) & below
                    if nl:
                        pos = nl.bit_length() - 1
                        code = 1 if oh >> pos & 1 else \
                            (hi >> pos & 1) << 1 | (lo >> pos & 1)
                        return (32 * gw + pos) << 2 | code, done
                return -1, done

            for r in range(15, -1, -1):
                i = 16 * g + r + 1
                if i > top:
                    continue
                kz = -(i + dlo)
                # the fast path reads its group's planes before it knows
                # that they are this word-row's
                w = min((kvec & M32) >> 5, nw - 1)
                lo, hi = (int(v) for v in planes[32 * w + 2 * r:
                                                 32 * w + 2 * r + 2])
                oh = _onehot(kz, w)
                nl = ((~hi & M32) | lo | oh) & (M32 >> (31 - (kvec & 31)))
                rel = w - wlo
                if nl and 0 <= kvec < W and 0 <= rel < 32 \
                        and done >> rel & 1:
                    pos = nl.bit_length() - 1
                    k_exit = 32 * w + pos
                    code = 1 if oh >> pos & 1 else \
                        (hi >> pos & 1) << 1 | (lo >> pos & 1)
                else:
                    pk, done = step_slow(done, kvec, kz, r)
                    if pk < 0:
                        esc = True
                        break
                    k_exit, code = pk >> 2, pk & 3
                if code == 3:
                    esc = True
                    break
                rec[(i - 1) & 31] = ((geometry.REC_UP if code == 1
                                      else geometry.REC_DIAG)
                                     | (kvec - k_exit) << 2)
                kvec = k_exit + (code == 1)
            if esc:
                break
            if (16 * g) & 31 == 0:
                hi_row = min(16 * g + 32, m_cap)
                out[b, 16 * g:hi_row] = rec[:hi_row - 16 * g]
                rec = [0] * 32
        if esc:
            g0 = (i - 1) & ~31
            hi_row = min(g0 + 32, m_cap)
            out[b, g0:hi_row] = rec[:hi_row - g0]
            out[b, :g0] = 0
        jfin = dlo + kvec
        out[b, m_cap] = min(max(jfin, 0), 255)
        out[b, m_cap + 1] = esc or jfin < 0 or jfin > 255
    return out


# -------------------------------------------------------------- inputs


def _sweep_batch(seed, B, cap, w, scores):
    """B mutated read pairs through the port's plain sweep: every 7th item
    all PAD, every 5th short of its target by W/2 + 40 bases (leaves the
    band), lengths not multiples of 16 and one under 16 rows. Returns
    (moves, m, n) as CPU tensors."""
    rng = np.random.default_rng(seed)
    q8 = np.full((B, cap), 5, np.int8)
    t8 = np.full((B, cap), 5, np.int8)
    dc8 = np.full((B, cap), scores[2], np.int8)
    m = np.zeros(B, np.int32)
    n = np.zeros(B, np.int32)
    for b in range(B):
        if b % 7 == 6:
            continue
        tl = 13 if b == 2 else int(rng.integers(cap // 3, cap))
        t = rng.choice(ACGT, tl)
        q = t[rng.random(tl) >= 0.04]
        ins = np.flatnonzero(rng.random(len(q)) < 0.04)
        q = np.insert(q, ins, rng.choice(ACGT, len(ins)))
        sub = rng.random(len(q)) < 0.04
        q[sub] = rng.choice(ACGT, int(sub.sum()))
        if b % 5 == 4:
            q = q[: max(len(q) - w // 2 - 40, 1)]
        q = q[:cap]
        q8[b, : len(q)] = encode(q)
        t8[b, :tl] = encode(t)
        m[b], n[b] = len(q), tl
        if scores[0] > 0:
            dc8[b, :tl][rng.random(tl) < 0.3] = 0
    g = to_device(pack_codes4(q8), pack_codes4(t8), pack_delbits(dc8), m, n,
                  m_cap=cap, n_cap=cap, device="cpu")
    moves, _ = port.nw_sweep(g.q4, g.t4, g.dcb, m_cap=cap, n_cap=cap,
                             w_band=w, match=scores[0], mismatch=scores[1],
                             gap=scores[2])
    return moves, g.m, g.n


def _words(codes):
    """(B, cap, W) 2-bit codes -> (B, cap/16, W) int32 move words."""
    B, cap, W = codes.shape
    c = codes.reshape(B, cap // 16, 16, W).astype(np.int64)
    w = (c << (2 * np.arange(16))[None, None, :, None]).sum(2)
    return torch.from_numpy((w & M32).astype(np.uint32).view(np.int32))


def _random_batch(seed, B, cap, w, p):
    """Random move words (codes 0..3 drawn with probabilities p) and
    corners (m, n) with k in the band: m of 0 (all PAD, n = 0), under 16
    and not a multiple of 16 among them, n from m - W/2 to m + W/2."""
    rng = np.random.default_rng(seed)
    codes = rng.choice(4, size=(B, cap, w), p=p)
    m = rng.integers(1, cap + 1, B)
    m[::5] = rng.integers(1, 16, len(m[::5]))
    n = np.clip(m + rng.integers(-w // 2, w // 2, B), 0, cap)
    m[3::7], n[3::7] = 0, 0
    return (_words(codes), torch.from_numpy(m.astype(np.int32)),
            torch.from_numpy(n.astype(np.int32)))


def _deletion_runs(w=128, cap=160):
    """Moves that are DIAG everywhere but one row R, whose lanes k0 - run +
    1 .. k0 are LEFT (LEFT down to lane 0 where the run is longer), so that
    the walk, which stands at k0 down to row R, takes a run of exactly
    `run` deletions there (64 or more: an escape); runs end inside a
    32-lane group, at its edge and across one or two groups; then a row
    whose exit is code 3, and items whose walk climbs column 0 (its lane
    counts as UP) or leaves the band by UP steps."""
    dlo = geometry.band_dlo(cap, cap, w)
    items = []
    for run in (0, 1, 31, 32, 33, 62, 63, 64, 70):
        for k0 in (64, 69, 95, 127):
            items.append((run, k0, 2, 97))
    items += [(5, 100, 3, 120), (40, 127, 3, 50)]  # the exit's code is 3
    codes = np.zeros((len(items) + 2, cap, w), np.int64)
    m = np.zeros(len(codes), np.int32)
    n = np.zeros(len(codes), np.int32)
    for b, (run, k0, exit_code, R) in enumerate(items):
        m[b] = 131 + b % 3
        n[b] = m[b] + dlo + k0
        codes[b, R - 1, max(k0 - run + 1, 0):k0 + 1] = 2
        if run and exit_code == 3 and k0 - run >= 0:
            codes[b, R - 1, k0 - run] = 3
    # n = 0: the walk climbs column 0 over DIAG codes; UP codes
    # everywhere: UP steps take k out of the band
    b = len(items)
    m[b], n[b] = 40, 0
    codes[b + 1] = 1
    m[b + 1], n[b + 1] = 40, 40 + dlo + 120
    return (_words(codes), torch.from_numpy(m), torch.from_numpy(n))


# ------------------------------------------------------------- packed2


def _packed_ref(moves, m, n, cap, w, S):
    codes, esc = walk_moves_device(
        jnp.asarray(moves.numpy()), jnp.asarray(m.numpy()),
        jnp.asarray(n.numpy()), m_cap=cap, n_cap=cap, w_band=w,
        max_steps=S, packed=True)
    return np.concatenate([np.asarray(codes),
                           np.asarray(esc).astype(np.uint8)[:, None]], 1)


def _check_packed(moves, m, n, cap, w, S, **design):
    geo = dict(m_cap=cap, n_cap=cap, w_band=w)
    plain = port.packed_walk_plain(moves, m, n, **geo, max_steps=S).numpy()
    assert np.array_equal(plain, _packed_ref(moves, m, n, cap, w, S))
    got = packed_warp_model(moves.numpy(), m.numpy(), n.numpy(), **geo,
                            max_steps=S, **design)
    assert np.array_equal(got, plain)
    return plain


@pytest.mark.parametrize("cap,w,scores,design", [
    (256, 128, (5, -4, -8), {}),
    (640, 128, (0, -1, -1), {}),
    (640, 128, (5, -4, -8), dict(lanes=32, slots=4, stage_bytes=16)),
    (512, 256, (0, -1, -1), dict(lanes=64, slots=8, stage_bytes=8)),
    (512, 256, (5, -4, -8), dict(lanes=256, slots=4, stage_bytes=64))])
def test_packed_model_on_sweep_moves(cap, w, scores, design):
    """The kernel's ring and staging at the consensus and align scores,
    and narrow windows (lanes outside them read from the moves), short
    rings and small staging buffers (many copy-outs) on the same walks."""
    moves, m, n = _sweep_batch(cap + w + scores[0], 15, cap, w, scores)
    plain = _check_packed(moves, m, n, cap, w,
                          geometry.walk_steps(cap, cap, w), **design)
    assert 0 < plain[:, -1].sum() < len(m)  # some escape, most do not


@pytest.mark.parametrize("S,p,design", [
    (12, (0.9, 0.04, 0.05, 0.01), {}),
    (36, (0.9, 0.04, 0.05, 0.01), dict(stage_bytes=4)),
    (100, (0.95, 0.02, 0.03, 0.0), dict(lanes=32, slots=4, stage_bytes=8)),
    (None, (0.85, 0.07, 0.08, 0.0), dict(lanes=32, slots=4, stage_bytes=8)),
    (None, (0.85, 0.07, 0.08, 0.0), {}),
    (None, (0.97, 0.0, 0.0, 0.03), dict(stage_bytes=16))])
def test_packed_model_on_random_moves(S, p, design):
    """Random codes (a step budget of 12, 36 (not a multiple of 16) and
    100 steps cuts walks short; code 3 escapes; UP and LEFT runs take k
    out of the band; walks end on row 0 or column 0) on 40 items, one of
    them all PAD, some with m < 16."""
    cap, w = 160, 64
    moves, m, n = _random_batch(len(p) + (S or 0), 40, cap, w, p)
    S = S or geometry.walk_steps(cap, cap, w)
    plain = _check_packed(moves, m, n, cap, w, S, **design)
    assert plain[:, -1].any()


def test_packed_model_on_deletion_runs():
    """The hand-made runs, code 3 exits and column-0 climbs of
    _deletion_runs through the packed walk."""
    moves, m, n = _deletion_runs()
    _check_packed(moves, m, n, 160, 128, geometry.walk_steps(160, 160, 128))


# ---------------------------------------------------------------- rows


def _rows_ref(moves, m, n, cap, w):
    payload, esc = walk_rows_ref(
        jnp.asarray(moves.numpy().transpose(1, 2, 0)),
        jnp.asarray(m.numpy()), jnp.asarray(n.numpy()), m_cap=cap,
        n_cap=cap, w_band=w)
    payload = np.asarray(payload)
    assert np.array_equal(payload[:, -1] != 0, np.asarray(esc))
    return payload


def _check_rows(moves, m, n, cap, w):
    geo = dict(m_cap=cap, n_cap=cap, w_band=w)
    plain = port.rows_walk_plain(moves, m, n, **geo).numpy()
    assert np.array_equal(plain, _rows_ref(moves, m, n, cap, w))
    got = rows_warp_model(moves.numpy(), m.numpy(), n.numpy(), **geo)
    assert np.array_equal(got, plain)
    return plain


@pytest.mark.parametrize("cap,w,scores", [
    (256, 128, (5, -4, -8)), (640, 128, (0, -1, -1)),
    (512, 256, (5, -4, -8)), (288, 1088, (0, -1, -1))])
def test_rows_model_on_sweep_moves(cap, w, scores):
    """The consensus and align scores; at W = 1088 (34 groups of 32
    lanes) some groups fall outside the 32 the model's word-rows track,
    and are transposed again at each use."""
    moves, m, n = _sweep_batch(cap + w + scores[0], 15, cap, w, scores)
    plain = _check_rows(moves, m, n, cap, w)
    assert 0 < plain[:, -1].sum() < len(m)


@pytest.mark.parametrize("p", [(0.3, 0.2, 0.48, 0.02), (0.1, 0.05, 0.85, 0.0),
                               (0.02, 0.01, 0.97, 0.0)])
def test_rows_model_on_random_moves(p):
    """Random codes, LEFT-heavy so that deletion runs cross 32-lane groups,
    pass 63 lanes and take k out of the band; code 3 escapes; 40 items,
    one of them all PAD, some with m < 16."""
    cap, w = 160, 128
    moves, m, n = _random_batch(int(100 * p[2]), 40, cap, w, p)
    plain = _check_rows(moves, m, n, cap, w)
    assert plain[:, -1].any()


def test_rows_model_on_deletion_runs():
    """Runs of exactly 0 .. 64 and 70 deletions at 32-lane group edges:
    63 is taken, 64 and 70 escape; a code 3 exit escapes; a climb up
    column 0 and UP steps out of the band."""
    moves, m, n = _deletion_runs()
    plain = _check_rows(moves, m, n, 160, 128)
    runs = [run for run in (0, 1, 31, 32, 33, 62, 63, 64, 70)
            for _ in range(4)]
    for b, run in enumerate(runs):
        assert plain[b, -1] == (run >= 64), (b, run)
        if run < 64:
            assert plain[b, 96] >> 2 == run  # row R = 97's record
    assert plain[len(runs):len(runs) + 2, -1].all()  # code 3
    assert plain[-2:, -1].tolist() == [0, 1]  # column 0; out of the band


def test_rows_model_past_tracked_groups():
    """At W = 2048 (64 groups) a word-row's walk tracks the 32 groups from
    30 below its first lane's; runs of exactly 63 deletions in each of 16
    rows carry the walk from lane 2047 to lane 1039 and, in the next item,
    from lane 1600 (group 50: groups 20 .. 51 tracked) to lane 592, past
    the tracked groups' lower end, where each use transposes its group
    again."""
    cap, w = 2048, 2048
    dlo = geometry.band_dlo(cap, cap, w)
    codes = np.zeros((2, cap, w), np.uint8)
    m = np.array([304, 1008], np.int32)  # column 0's lane stays below
    for b, k0 in enumerate((2047, 1600)):
        n_rows = 16 + 16 * b
        lanes = np.arange(w)
        for r in range(n_rows):  # row m - r: exit 63 lanes below
            row = codes[b, m[b] - 1 - r]
            row[:] = 2
            row[(lanes - (k0 - 63 * (r + 1))) % 64 == 0] = 0
    n = (m + dlo + np.array([2047, 1600])).astype(np.int32)
    moves = _words(codes)
    plain = _check_rows(moves, torch.from_numpy(m), torch.from_numpy(n),
                        cap, w)
    assert (plain[0, 304 - 16:304] >> 2 == 63).all()
    assert (plain[1, 1008 - 16:1008] >> 2 == 63).all()


# ------------------------------------------- the work a walk's path needs


def _packed_path_direct(moves, m, n, cap, w, S):
    """(steps, distinct move words) of the packed2 walk, walked straight
    over the moves: a step inside the matrix reads (item, word-row,
    lane); an escape on code 3 reads its word; the escaping step and a
    walk cut at S count one step more."""
    words = moves.numpy().astype(np.int64) & M32
    dlo = geometry.band_dlo(cap, cap, w)
    seen, steps = set(), 0
    for b in range(len(m)):
        i, j = int(m[b]), int(n[b])
        k, s, esc = j - i - dlo, 0, False
        while (i > 0 or j > 0) and s < S:
            if i == 0:
                mv = 2
            elif j == 0:
                mv = 1
            else:
                if not 0 <= k < w:
                    esc = True
                    break
                seen.add((b, (i - 1) // 16, k))
                mv = int(words[b, (i - 1) // 16, k] >> (2 * ((i - 1) & 15))
                         ) & 3
                if mv == 3:
                    esc = True
                    break
            s += 1
            i -= mv != 2
            j -= mv != 1
            k += (mv == 1) - (mv == 2)
        steps += s + (esc or i != 0 or j != 0)
    return steps, len(seen)


def _rows_path_direct(moves, m, n, cap, w):
    """(rows, distinct move words) of the rows walk, walked straight over
    the moves: per row the lanes from the walk's one down to its exit
    (the lane of column 0 is UP, unread; at most 63 deletions); an
    escaping row counts the word it stands on."""
    words = moves.numpy().astype(np.int64) & M32
    dlo = geometry.band_dlo(cap, cap, w)
    seen, rows = set(), 0
    for b in range(len(m)):
        k = int(n[b]) - int(m[b]) - dlo
        for i in range(min(int(m[b]), cap), 0, -1):
            rows += 1
            if not 0 <= k < w:
                break
            kz, read, exit_ = -(i + dlo), [], None
            for lane in range(k, max(k - 63, 0) - 1, -1):
                if lane == kz:
                    exit_ = (lane, 1)
                    break
                read.append((b, (i - 1) // 16, lane))
                code = int(words[b, (i - 1) // 16, lane]
                           >> (2 * ((i - 1) & 15))) & 3
                if code != 2:
                    exit_ = (lane, code)
                    break
            if exit_ is None or exit_[1] == 3:
                seen.add((b, (i - 1) // 16, k))
                break
            seen.update(read)
            k = exit_[0] + (exit_[1] == 1)
    return rows, len(seen)


@pytest.mark.parametrize("batch", ["sweep_consensus", "sweep_align",
                                   "random", "random_short", "runs"])
def test_walk_work_counts_the_path(batch):
    """ops/walk_work's counts from the payloads (the steps or rows, and the
    distinct move words that the bounds of chip_smoke.py and kernel_ab.py
    charge) equal a walk straight over the moves, on sweep moves, random
    codes with a full and a short step budget, and the deletion runs."""
    from racon_tpu_torch.ops import walk_work

    if batch.startswith("sweep"):
        cap, w = 256, 128
        scores = (5, -4, -8) if batch == "sweep_consensus" else (0, -1, -1)
        moves, m, n = _sweep_batch(41, 15, cap, w, scores)
    elif batch.startswith("random"):
        cap, w = 160, 64
        moves, m, n = _random_batch(5, 40, cap, w, (0.85, 0.07, 0.07, 0.01))
    else:
        cap, w = 160, 128
        moves, m, n = _deletion_runs()
    S = 36 if batch == "random_short" else geometry.walk_steps(cap, cap, w)
    geo = dict(m_cap=cap, n_cap=cap, w_band=w)
    packed = port.packed_walk_plain(moves, m, n, **geo, max_steps=S)
    assert walk_work.packed_path(packed, m, n, cap, w) == \
        _packed_path_direct(moves, m, n, cap, w, S)
    rows = port.rows_walk_plain(moves, m, n, **geo)
    assert walk_work.rows_path(rows, m, n, cap, w) == \
        _rows_path_direct(moves, m, n, cap, w)
    steps = walk_work.walk_units(packed, "packed_walk", m)
    assert steps.sum() == _packed_path_direct(moves, m, n, cap, w, S)[0]


def test_transpose32_model():
    """The five-step shuffle transpose is the 32 x 32 bit transpose."""
    rng = np.random.default_rng(3)
    x = rng.integers(0, 1 << 32, 32)
    bits = (x[:, None] >> np.arange(32)) & 1  # [t, c]
    want = (bits.T << np.arange(32)).sum(1)
    assert transpose32(x) == [int(v) for v in want]


# ------------------------------------------------------------- geometry


def _constant(src, name):
    return int(re.search(rf"{name} = (\d+);", src).group(1))


def test_walk_constants_mirror_the_kernels():
    """ops/geometry.py's packed2 and rows walk constants are the
    kernels' own."""
    src = (_CSRC / "packed_walk.cu").read_text()
    assert _constant(src, "kPackedWarps") == geometry.PACKED_WALK_WARPS
    assert _constant(src, "kWindowLanes") == geometry.PACKED_WALK_LANES
    assert _constant(src, "kStageBytes") == geometry.PACKED_WALK_STAGE
    assert _constant(src, "kPackedSlots") == geometry.PACKED_WALK_SLOTS
    src = (_CSRC / "rows_walk.cu").read_text()
    assert _constant(src, "kRowsWarps") == geometry.ROWS_WALK_WARPS
    assert _constant(src, "kRowsSlots") == geometry.ROWS_WALK_SLOTS


@pytest.mark.parametrize("B,w,blocks,threads,smem", [
    (25, 4096, 25, 32, 16 * 512 + 512 + 64),
    (204, 2048, 204, 32, 16 * 512 + 512 + 64),
    (4, 64, 4, 32, 16 * 256 + 512 + 64)])
def test_packed_walk_launch(B, w, blocks, threads, smem):
    """One warp an item and a block each, so that the align chunk of 25
    items at W = 4096 takes 25 SMs and the consensus chunk of 204 one
    wave; a 16-slot ring of 128-lane windows (the whole row at W =
    64)."""
    assert geometry.packed_walk_launch(B, w) == (blocks, threads, smem)


@pytest.mark.parametrize("B,w,blocks,smem", [
    (409, 1024, 205, 2 * 5 * 4096), (4096, 128, 2048, 2 * 5 * 512),
    (4097, 128, 2049, 2 * 5 * 512), (1, 4096, 1, 2 * 5 * 16384)])
def test_rows_walk_launch(B, w, blocks, smem):
    """Two warps (items) a block, a ragged B rounding up to a block whose
    second warp returns at once; each warp four word-rows and the planes
    of one (past 48 KB from W = 1024 on, where the launcher raises the
    limit; 160 KB at W = 4096, within the H100's 227 KB)."""
    assert geometry.rows_walk_launch(B, w) == (blocks, 64, smem)
    assert smem <= geometry.SMEM_BLOCK_MAX

"""Native consensus stage: packs WindowSet into columnar blobs and runs the
C++ star-POA batch (layer alignment + graph merge + heaviest bundle) across a
thread pool. Also reused by the TPU stage, which passes device-computed
alignments via ops_blob."""

from __future__ import annotations

import numpy as np

from . import bindings
from ..utils.phred import PHRED_OFFSET


def pack_windows(windows):
    """WindowSet -> columnar blobs for rt_consensus_batch.

    Returns dict with backbone blob/off/weights, layer CSR + blobs, win ids.
    Layer weights: phred-33 when the layer has quality, else 1s; backbone
    weights: target quality - 33, else 0s (the reference's dummy '!').
    """
    n_win = windows.num_windows
    bb_parts = []
    bbw_parts = []
    bb_off = np.zeros(n_win + 1, np.int64)
    for w in range(n_win):
        bb = windows.backbone(w)
        bq = windows.backbone_quality(w)
        bb_parts.append(bb)
        if bq is None:
            bbw_parts.append(np.zeros(len(bb), np.int32))
        else:
            bbw_parts.append(bq.astype(np.int32) - PHRED_OFFSET)
        bb_off[w + 1] = bb_off[w] + len(bb)

    n_lay = len(windows.lay_win)
    lay_parts = []
    layw_parts = []
    lay_off = np.zeros(n_lay + 1, np.int64)
    for l in range(n_lay):
        d = windows.layer_data(l)
        q = windows.layer_quality(l)
        lay_parts.append(d)
        if q is None:
            layw_parts.append(np.ones(len(d), np.int32))
        else:
            layw_parts.append(q.astype(np.int32) - PHRED_OFFSET)
        lay_off[l + 1] = lay_off[l] + len(d)

    return {
        "bb_blob": (np.concatenate(bb_parts) if bb_parts
                    else np.zeros(0, np.uint8)),
        "bb_off": bb_off,
        "bbw_blob": (np.concatenate(bbw_parts) if bbw_parts
                     else np.zeros(0, np.int32)),
        "win_id": windows.win_target.astype(np.int64),
        "win_rank": windows.win_rank.astype(np.int32),
        "layer_off": windows.win_layer_off.astype(np.int64),
        "lay_blob": (np.concatenate(lay_parts) if lay_parts
                     else np.zeros(0, np.uint8)),
        "lay_data_off": lay_off,
        "layw_blob": (np.concatenate(layw_parts) if layw_parts
                      else np.zeros(0, np.int32)),
        "lay_begin": windows.lay_begin.astype(np.int32),
        "lay_end": windows.lay_end.astype(np.int32),
    }


def run_consensus(windows, cfg, packed, ops_blob=None, ops_off=None):
    from ..core.windows import WINDOW_TYPE_TGS
    win_len = np.diff(packed["bb_off"])
    capacity = win_len * 3 + 512
    out_blob, out_off, out_len, out_pol = bindings.consensus_batch(
        packed["bb_blob"], packed["bb_off"], packed["bbw_blob"],
        packed["win_id"], packed["win_rank"], packed["layer_off"],
        packed["lay_blob"], packed["lay_data_off"], packed["layw_blob"],
        packed["lay_begin"], packed["lay_end"], ops_blob, ops_off,
        windows.window_type == WINDOW_TYPE_TGS, cfg.trim, cfg.match,
        cfg.mismatch, cfg.gap, cfg.num_threads, capacity,
        passes=cfg.refine_passes, cand_frac=cfg.candidate_frac,
        cand_min=cfg.candidate_min)
    consensus = []
    raw = out_blob.tobytes()
    for w in range(windows.num_windows):
        o = int(out_off[w])
        consensus.append(raw[o : o + int(out_len[w])])
    return consensus, [bool(p) for p in out_pol]


class NativeConsensusStage:
    def __init__(self, cfg):
        self.cfg = cfg

    def consensus_windows(self, windows, cfg, logger):
        packed = pack_windows(windows)
        result = run_consensus(windows, cfg, packed)
        logger.bar_progress("[racon::Polisher::polish] generating consensus",
                            windows.num_windows, windows.num_windows)
        return result

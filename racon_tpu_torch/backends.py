"""Backend registry of the port: cuda (hand-written CUDA kernels), native
(the port's C++ host runtime) and python (numpy oracle).

"auto" means cuda. Both raise BackendUnavailable when no GPU is visible:
the port never falls back to the host by itself. "native" and "python"
run only when asked for by name.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from .core.breakpoints import breaking_points_from_ops
from .models.polish_model import PolisherConfig
from .native import loader
from .ops import nw_host, poa_host

BACKENDS = ("auto", "cuda", "native", "python")


class BackendUnavailable(RuntimeError):
    pass


def resolve_backend(name: str) -> str:
    """The concrete backend a run uses for `name`."""
    if name not in BACKENDS:
        raise BackendUnavailable(
            f"unknown backend {name!r} (choose from {', '.join(BACKENDS)})")
    if name in ("auto", "cuda"):
        if not torch.cuda.is_available():
            raise BackendUnavailable(
                f"{name} backend needs a GPU but no CUDA device is available")
        if not loader.available():
            raise BackendUnavailable(
                "cuda backend needs the native runtime, which did not build")
        return "cuda"
    if name == "native" and not loader.available():
        raise BackendUnavailable(
            "native backend requested but the native runtime did not build")
    return name


def get_align_stage(cfg, device=None):
    """Stage for cfg.backend (already resolved). `device` overrides the
    cuda backend's device; device="cpu" runs the kernels' plain versions
    and exists for the tests."""
    if cfg.backend == "cuda":
        from .ops.align_stage import TorchAlignStage

        return TorchAlignStage(cfg, device or "cuda")
    if cfg.backend == "native":
        from .native.align_stage import NativeAlignStage

        return NativeAlignStage(cfg)
    if cfg.backend == "python":
        return PyAlignStage(cfg)
    raise BackendUnavailable(f"unresolved backend {cfg.backend!r}")


def get_consensus_stage(cfg, device=None):
    if cfg.backend == "cuda":
        from .ops.consensus_stage import TorchConsensusStage

        return TorchConsensusStage(cfg, device or "cuda")
    if cfg.backend == "native":
        from .native.consensus_stage import NativeConsensusStage

        return NativeConsensusStage(cfg)
    if cfg.backend == "python":
        return PyConsensusStage(cfg)
    raise BackendUnavailable(f"unresolved backend {cfg.backend!r}")


# ---------------------------------------------------------------------- #
# python oracle stages (racon_tpu/backends.py:69-146)
# ---------------------------------------------------------------------- #


class PyAlignStage:
    """Edit-distance NW on host numpy; emits breaking points by walking the
    op list (reference edlib role, src/overlap.cpp:192-224)."""

    def __init__(self, cfg: PolisherConfig):
        self.cfg = cfg

    def breaking_points(self, overlaps, indices, sequences, window_length,
                        logger) -> list[np.ndarray]:
        # the oracle is full-matrix O(m*n) per overlap: real datasets take
        # hours. Warn instead of silently hanging
        cells = sum(
            (int(overlaps.q_end[i]) - int(overlaps.q_begin[i]))
            * (int(overlaps.t_end[i]) - int(overlaps.t_begin[i]))
            for i in indices)
        if cells > 2 * 10**9:
            sys.stderr.write(
                "[racon::] warning: python oracle backend selected for "
                f"{len(indices)} overlaps (~{cells / 1e9:.1f}G DP cells); "
                "this may take hours — use --backend native or cuda\n")
        out = []
        step = max(1, len(indices) // 20)
        for k, i in enumerate(indices):
            qid = int(overlaps.q_id[i])
            strand = bool(overlaps.strand[i])
            q_begin = int(overlaps.q_begin[i])
            q_end = int(overlaps.q_end[i])
            q_length = int(overlaps.q_length[i])
            t_begin = int(overlaps.t_begin[i])
            t_end = int(overlaps.t_end[i])
            if strand:
                src = sequences.reverse_complement(qid)
                q = src[q_length - q_end : q_length - q_begin]
            else:
                q = sequences.data(qid)[q_begin:q_end]
            t = sequences.data(int(overlaps.t_id[i]))[t_begin:t_end]
            _, ops = nw_host.nw_align(q, t, 0, -1, -1)
            out.append(breaking_points_from_ops(
                ops, strand, q_begin, q_end, q_length, t_begin, t_end,
                window_length))
            if (k + 1) % step == 0:
                logger.bar("[racon::Polisher::initialize] aligning overlaps")
        return out


class PyConsensusStage:
    def __init__(self, cfg: PolisherConfig):
        self.cfg = cfg

    def consensus_windows(self, windows, cfg: PolisherConfig, logger):
        from .core.windows import WINDOW_TYPE_TGS

        consensus: list[bytes] = []
        polished: list[bool] = []
        tgs = windows.window_type == WINDOW_TYPE_TGS
        if len(windows.lay_win) > 50_000:
            sys.stderr.write(
                "[racon::] warning: python oracle backend selected for "
                f"{windows.num_windows} windows / {windows.num_layers} "
                "layers; this may take hours — use --backend native or "
                "cuda\n")
        step = max(1, windows.num_windows // 20)
        for wi in range(windows.num_windows):
            layers = []
            for li in windows.layer_indices(wi):
                layers.append((windows.layer_data(int(li)),
                               windows.layer_quality(int(li)),
                               int(windows.lay_begin[li]),
                               int(windows.lay_end[li])))
            cons, ok = poa_host.consensus_window(
                windows.backbone(wi), windows.backbone_quality(wi), layers,
                tgs, cfg.trim, cfg.match, cfg.mismatch, cfg.gap,
                window_id=int(windows.win_target[wi]),
                rank=int(windows.win_rank[wi]), passes=cfg.refine_passes,
                cand_frac=cfg.candidate_frac, cand_min=cfg.candidate_min)
            consensus.append(cons)
            polished.append(ok)
            if (wi + 1) % step == 0:
                logger.bar("[racon::Polisher::polish] generating consensus")
        return consensus, polished

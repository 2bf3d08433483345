"""Polishing model configuration.

The "model" of this framework is the consensus pipeline: scoring parameters,
windowing geometry, filtering thresholds, and backend selection (device
kernels vs native host vs pure python). Defaults match the reference CLI
(src/main.cpp:51-62)."""

from __future__ import annotations

import enum
from dataclasses import dataclass


class PolisherType(enum.Enum):
    kC = 0  # contig polishing: keep only the longest overlap per query
    kF = 1  # fragment correction: keep all dual/self overlaps


@dataclass
class PolisherConfig:
    type: PolisherType = PolisherType.kC
    window_length: int = 500
    quality_threshold: float = 10.0
    error_threshold: float = 0.3
    trim: bool = True
    match: int = 3
    mismatch: int = -5
    gap: int = -4
    num_threads: int = 1
    # backend: "auto" and "cuda" run the CUDA kernels on a GPU (and raise
    # without one); "native" (host C++) and "python" (numpy oracle) run
    # only when named
    backend: str = "auto"
    # iterative star-POA refinement (see native/src/poa.hpp RefineParams):
    # pass 1 aligns layers to the raw backbone; later passes re-align to the
    # previous consensus expanded with high-support insertion candidates as
    # zero-deletion-cost columns. 4 passes beats the reference's consensus
    # accuracy on its golden dataset (see PLAN.md quality gate).
    refine_passes: int = 4
    candidate_frac: float = 0.15
    candidate_min: int = 2
    # device batching caps (cudapoa-inspired shape budget,
    # reference: src/cuda/cudabatch.cpp:56-59, src/cuda/cudapolisher.cpp:226)
    # accelerator-path depth cap per window (reference GPU path:
    # MAX_DEPTH_PER_WINDOW=200, src/cuda/cudapolisher.cpp:226); the native
    # CPU path uses all layers, like the reference's CPU path. Length caps
    # are handled by the stage tier ladders.
    max_window_depth: int = 200
    band_width: int = 0  # 0 = auto (10% of mean overlap length, even-ified,
    #                      reference: src/cuda/cudapolisher.cpp:150-174)

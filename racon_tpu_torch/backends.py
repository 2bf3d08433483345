"""Backend registry of the port: cuda (hand-written CUDA kernels) > native
(the shared C++ runtime) > python (numpy oracle).

"auto" resolves once, before any stage exists: cuda when a GPU is
visible, else native (python where the native runtime cannot build).
An explicit "cuda" without a GPU is an error, never a silent fallback.
"""

from __future__ import annotations

import torch

BACKENDS = ("auto", "cuda", "native", "python")


class BackendUnavailable(RuntimeError):
    pass


def resolve_backend(name: str) -> str:
    """The concrete backend a run uses for `name`."""
    from racon_tpu.native import loader

    if name not in BACKENDS:
        raise BackendUnavailable(
            f"unknown backend {name!r} (choose from {', '.join(BACKENDS)})")
    if name == "auto":
        if torch.cuda.is_available():
            return "cuda"
        return "native" if loader.available() else "python"
    if name == "cuda":
        if not torch.cuda.is_available():
            raise BackendUnavailable(
                "cuda backend requested but no CUDA device is available")
        if not loader.available():
            raise BackendUnavailable(
                "cuda backend needs the native runtime, which did not build")
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
        from racon_tpu.native.align_stage import NativeAlignStage

        return NativeAlignStage(cfg)
    if cfg.backend == "python":
        from racon_tpu.backends import PyAlignStage

        return PyAlignStage(cfg)
    raise BackendUnavailable(f"unresolved backend {cfg.backend!r}")


def get_consensus_stage(cfg, device=None):
    if cfg.backend == "cuda":
        from .ops.consensus_stage import TorchConsensusStage

        return TorchConsensusStage(cfg, device or "cuda")
    if cfg.backend == "native":
        from racon_tpu.native.consensus_stage import NativeConsensusStage

        return NativeConsensusStage(cfg)
    if cfg.backend == "python":
        from racon_tpu.backends import PyConsensusStage

        return PyConsensusStage(cfg)
    raise BackendUnavailable(f"unresolved backend {cfg.backend!r}")

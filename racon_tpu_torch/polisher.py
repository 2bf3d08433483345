"""Polisher of the port: racon_tpu's orchestration (parse, align, window,
consensus, stitch) with the stages of racon_tpu_torch.backends.

`initialize` is inherited unchanged. Its warm-up thread asks
racon_tpu.backends for stages, which touches jax only under the "tpu" and
"auto" backends; the port resolves the backend before the Polisher exists,
so that thread only builds native or python stage objects.
`_find_breaking_points` and `polish` are re-written without the multi-host
(dist) and prewarm paths, which import jax.
"""

from __future__ import annotations

from dataclasses import replace

import numpy as np

from racon_tpu import polisher as _base
from racon_tpu.core.breakpoints import breaking_points_from_cigar
from racon_tpu.core.windows import stitch
from racon_tpu.models.polish_model import PolisherConfig, PolisherType

from .backends import get_align_stage, get_consensus_stage, resolve_backend


def create_polisher(sequences_path: str, overlaps_path: str, target_path: str,
                    config: PolisherConfig, device=None) -> "Polisher":
    """Validate the configuration and open the parsers (reference:
    src/polisher.cpp:55-160). The backend is resolved here ("auto" ->
    cuda or native). device=None puts the cuda backend on the current GPU;
    device="cpu" runs the kernels' plain PyTorch versions (tests only)."""
    if device is None or config.backend != "cuda":
        config = replace(config, backend=resolve_backend(config.backend))
    base = _base.create_polisher(sequences_path, overlaps_path, target_path,
                                 config)
    return Polisher(base.sparser, base.oparser, base.tparser, config, device)


class Polisher(_base.Polisher):
    def __init__(self, sparser, oparser, tparser, config: PolisherConfig,
                 device=None):
        super().__init__(sparser, oparser, tparser, config)
        self.device = device
        self.align_stage = None
        self.consensus_stage = None

    def _find_breaking_points(self, overlaps) -> list[np.ndarray]:
        """Align the overlaps without a CIGAR on the configured stage;
        SAM records that carry one are walked directly."""
        stage = get_align_stage(self.config, self.device)
        self.align_stage = stage
        w = self.config.window_length
        out: list[np.ndarray | None] = [None] * len(overlaps)
        need_align: list[int] = []
        for i in range(len(overlaps)):
            if overlaps.cigars[i]:
                out[i] = breaking_points_from_cigar(
                    overlaps.cigars[i], bool(overlaps.strand[i]),
                    int(overlaps.q_begin[i]), int(overlaps.q_end[i]),
                    int(overlaps.q_length[i]), int(overlaps.t_begin[i]),
                    int(overlaps.t_end[i]), w)
            else:
                need_align.append(i)
        if need_align:
            aligned = stage.breaking_points(overlaps, need_align,
                                            self.sequences, w, self.logger)
            for i, bp in zip(need_align, aligned):
                out[i] = bp
        self.logger.log("[racon::Polisher::initialize] aligned overlaps")
        return out

    def polish(self, drop_unpolished_sequences: bool
               ) -> list[tuple[bytes, bytes]]:
        cfg = self.config
        self.logger.log()
        stage = get_consensus_stage(cfg, self.device)
        self.consensus_stage = stage
        consensus, polished = stage.consensus_windows(self.windows, cfg,
                                                      self.logger)
        dst = stitch(consensus, polished, self.windows, self.sequences,
                     self.targets_coverages, cfg.type == PolisherType.kF,
                     drop_unpolished_sequences)
        self.logger.log("[racon::Polisher::polish] generated consensus")
        return dst

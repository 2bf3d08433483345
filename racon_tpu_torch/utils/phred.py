"""PHRED quality helpers. Weights are (ascii - 33), the same convention the
reference feeds to its POA engines (src/cuda/cudabatch.cpp:182-191; spoa
quality handling via racon src/window.cpp:105-112)."""

import numpy as np

PHRED_OFFSET = 33
DUMMY_QUAL = ord("!")  # '!' == phred 0; reference dummy window quality


def weights_from_quality(q: np.ndarray) -> np.ndarray:
    """ascii uint8 quality -> integer weights (q - 33)."""
    return q.astype(np.int32) - PHRED_OFFSET

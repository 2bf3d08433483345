"""The port's int16 plain sweep against the reference's big-tier kernel
nw_band_batch_t8big running in int16 (RACON_TPU_DP16=1, interpret mode),
exactly: at (256,128) with the consensus scores, as tests/test_dp16.py
runs it, and at 0/-1/-1, the align stage's scores, whose scored route runs
t8big at its eligible (2560,512) tier. Beside tests/test_torch_dp16.py so
that the interpreted kernels split across two test workers."""

import pytest

from racon_tpu.ops import nw_kernel as jnk
from tests.test_torch_dp16 import reference_pair

import numpy as np


@pytest.mark.parametrize("cap,w,scores,seed", [(256, 128, (5, -4, -8), 5),
                                               (128, 64, (0, -1, -1), 9)])
def test_plain16_matches_t8big_interpret(monkeypatch, cap, w, scores, seed):
    (gm, gs), (wm, ws) = reference_pair(monkeypatch, jnk.nw_band_batch_t8big,
                                        cap, w, scores, seed)
    assert np.array_equal(gm, wm)
    assert np.array_equal(gs, ws)

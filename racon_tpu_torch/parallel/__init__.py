from .mesh import (  # noqa: F401
    window_mesh,
    sharded_nw_band_batch,
    polish_step_sharded,
)

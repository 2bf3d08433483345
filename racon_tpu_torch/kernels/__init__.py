"""Hand-written CUDA kernels of the port (sources in csrc/, built by
build.py at first use) and their launch counters.

Each wrapper in racon_tpu_torch/ops adds one to its entry here where it
launches its kernel and nowhere else, so a run can show that its main path
went through the kernels and not through the plain PyTorch versions.
"""

LAUNCHES = {"nw_sweep": 0, "rle_walk": 0, "myers_sweep": 0, "myers_walk": 0,
            "nw_sweep_block": 0, "nw_sweep_wide": 0, "packed_walk": 0,
            "rows_walk": 0, "nw_sweep_t": 0, "nw_ablate": 0,
            "nw_sweep16": 0, "nw_sweep_block16": 0, "pack_gather": 0,
            "myers_moves": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0

"""One process of a multi-process polish, with a report of what it ran.

    python -m torch.distributed.run --standalone --nproc-per-node 2 \\
        -m racon_tpu_torch.testing.dist_polish --report DIR -- \\
        --backend cuda -t 4 reads.fasta ovl.paf draft.fasta

or, without torchrun, one such command per rank with --init-method
file:///path --world-size N --rank R. Each process brings the gloo group
up (parallel/dist.initialize), then drives create_polisher -> initialize
-> polish with the CLI's own arguments (those after "--"), and writes
DIR/rank<R>.json: the world size and rank, the current CUDA device and
local_devices(), the consensus stage's device, the mesh, the kernel
launches, the overlaps its align stage aligned and the windows its
consensus stage polished (where the stage counts them), the seconds of
initialize() and polish(), and of those the seconds this process took
to build or load the kernels (at their first launch, inside
initialize()). Rank 0 writes the FASTA to DIR/polished.fasta;
every other rank must get no records. Every rank then takes the group
down together (parallel/dist.shutdown) before it exits. --device cpu runs the cuda backend
on the kernels' plain versions and --cpu-mesh K pins a mesh of K CPU
devices (parallel/mesh.set_active_mesh), the tests' way to run dist x
mesh without a GPU.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import sys
import time


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--report", required=True, help="output directory")
    ap.add_argument("--init-method", default=None)
    ap.add_argument("--world-size", type=int, default=None)
    ap.add_argument("--rank", type=int, default=None)
    ap.add_argument("--device", default=None)
    ap.add_argument("--cpu-mesh", type=int, default=0)
    ap.add_argument("polish", nargs=argparse.REMAINDER,
                    help="raconx-torch arguments, after --")
    args = ap.parse_args(sys.argv[1:] if argv is None else argv)
    racon_argv = args.polish[1:] if args.polish[:1] == ["--"] else args.polish

    from ..parallel import dist, mesh

    dist.initialize(args.init_method, args.world_size, args.rank)
    if not dist.is_active():
        sys.stderr.write("dist_polish: the process group did not come up\n")
        return 1
    if args.cpu_mesh:
        mesh.set_active_mesh(["cpu"] * args.cpu_mesh)

    try:
        rc = _polish_and_report(args, racon_argv)
    except BaseException:
        dist.shutdown(wait=False)
        raise
    dist.shutdown()
    return rc


def _polish_and_report(args, racon_argv) -> int:
    import torch

    from .. import cli
    from ..kernels import LAUNCHES, build, reset_launches
    from ..parallel import dist, mesh
    from ..polisher import create_polisher

    pargs = cli.parser().parse_args(racon_argv)
    cfg = cli.make_config(pargs)
    reset_launches()
    with contextlib.redirect_stderr(io.StringIO()):
        t0 = time.perf_counter()
        p = create_polisher(*pargs.inputs, cfg, device=args.device)
        p.initialize()
        t1 = time.perf_counter()
        out = p.polish(not pargs.include_unpolished)
        t2 = time.perf_counter()
    rank = dist.process_index()
    cuda = torch.cuda.is_available()
    active = mesh.active_mesh()
    report = dict(
        world_size=dist.process_count(), rank=rank,
        current_device=torch.cuda.current_device() if cuda else None,
        local_devices=[str(d) for d in dist.local_devices()],
        stage_device=str(getattr(p.consensus_stage, "device", None)),
        mesh=None if active is None else [str(d) for d in active],
        launches=dict(LAUNCHES),
        align_items=getattr(p.align_stage, "stats", {}).get("items"),
        consensus_windows=getattr(p.consensus_stage, "n_windows", None),
        initialize_s=t1 - t0, polish_s=t2 - t1,
        kernel_load_s=build.build_seconds, records=len(out))
    os.makedirs(args.report, exist_ok=True)
    with open(os.path.join(args.report, f"rank{rank}.json"), "w") as f:
        json.dump(report, f)
    if rank == 0:
        with open(os.path.join(args.report, "polished.fasta"), "wb") as f:
            for name, data in out:
                f.write(b">" + name + b"\n" + data + b"\n")
    elif out:
        sys.stderr.write(f"dist_polish: rank {rank} got {len(out)} "
                         "records\n")
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())

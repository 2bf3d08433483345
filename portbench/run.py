"""The port's benchmark: one run of one cell.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

Runs from the root of a checkout of the repository, on a machine with
an NVIDIA GPU (it exits 2 and prints no result without one). The cell's
configuration, traffic and metrics are found by the names in
BENCHMARK.json (portbench/spec.py). Earlier lines of standard output
describe the host, each job and the reference's work; the last is the
result object. The numbers the check compares, each beside its limit,
are the last lines of standard error and the last key of the result.
"""

import time

T_ORIGIN = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
# the kernels' and native runtime's build directories sit inside the
# checkout (racon_tpu_torch/*/build); keep torch's own caches there too
os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                      os.path.join(ROOT, "portbench", ".cache", "torch_ext"))
os.environ.setdefault("TRITON_CACHE_DIR",
                      os.path.join(ROOT, "portbench", ".cache", "triton"))
os.environ.setdefault("USE_FLAX", "0")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="portbench/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = ap.parse_args(argv)

    from portbench import harness, spec

    bench = spec.load_benchmark(ROOT)
    cell = spec.cell(bench, a.workload)
    cfg = spec.config(bench, cell["config"], ROOT)
    traffic = spec.traffic(cell["traffic"], ROOT)

    import torch

    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell["chips"]:
        sys.stderr.write(f"portbench: the cell needs {cell['chips']} CUDA "
                         "device(s); none usable here\n")
        return 2
    rec = harness.run_cell(
        a.workload, cfg, traffic, a.seed, a.seconds, bool(a.trace),
        T_ORIGIN, metrics=spec.metrics_for(bench, a.workload, bool(a.trace)),
        root=ROOT, log=lambda s: print(s, flush=True))
    lines = rec.pop("_lines")
    bad = harness.forbidden_modules()
    if bad:
        sys.stderr.write("portbench: loaded in this process: "
                         + ", ".join(bad) + "\n")
        return 3
    sys.stderr.write("\n".join(lines) + "\n")
    sys.stderr.flush()
    print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

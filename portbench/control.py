"""The check's controls at a cell's own size: the plain reference put in
the program's place with one guarantee the configuration states broken,
judged by the check's own comparison (`check.compare`) against the
reference as the configuration states it, on the windows the check
samples from each seed. Each must come out not correct on every seed.

- `depth5`: each window's consensus from at most 5 of its layers where
  the configuration states up to 200 (`--max-window-depth`): a
  shallower cap is the step a later change could be tempted to take,
  since the merge's time grows with the layers;
- `refine1`: one refinement pass where the configuration states four
  (`--refine-passes`): part of the consensus's mathematics left out.

(The int16 DP is no lower-precision control: byte-equal to int32 by
design.)

    python3 portbench/control.py --workload correct_kf_ava \\
        --seeds 2147483001 2147483002 2147483003 --out control.json

Needs no card: the controls are the reference alone. The program's own
readings on the same numbers come from the cell's runs.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from portbench import check, harness, hostinfo, spec  # noqa: E402
from portbench.reference import racon  # noqa: E402

CONTROLS = {"depth5": {"max_window_depth": 5},
            "refine1": {"refine_passes": 1}}


def control_numbers(workload: str, seed: int, root: str = spec.ROOT,
                    genome_bp: int | None = None,
                    procs: int | None = None) -> list[dict]:
    """One record a control: the check's numbers and its verdict."""
    bench = spec.load_benchmark(root)
    cell = spec.cell(bench, workload)
    cfg = spec.config(bench, cell["config"], root)
    traffic = spec.traffic(cell["traffic"], root)
    pcfg = cfg["polisher"]
    procs = procs or hostinfo.usable_cores()
    work = tempfile.mkdtemp(prefix="portbench-control-")
    try:
        paths = harness.make_inputs(work, cfg, traffic,
                                    genome_bp or cfg["genome_bp"], seed)
        t0 = time.perf_counter()
        job = racon.load_job(paths["reads"], paths["overlaps"],
                             paths["targets"], pcfg["window_length"],
                             pcfg["error_threshold"], pcfg["type"] == "kF")
        regions = check.sample_windows(job, seed,
                                       traffic["check"]["regions"],
                                       traffic["check"]["windows"])
        ref = check.reference_answers(job, regions, pcfg, procs)
        t_ref = time.perf_counter() - t0
        out = []
        for name, change in CONTROLS.items():
            t1 = time.perf_counter()
            got = check.window_answers(job, ref, dict(pcfg, **change),
                                       procs)
            answer = {"layers": {w: ref[w][0] for w in ref},
                      "consensus": {w: c for w, (c, _) in got.items()},
                      "polished": {w: p for w, (_, p) in got.items()},
                      "records": None}
            numbers, _ = check.compare(job, ref, [answer],
                                       pcfg["drop_unpolished_sequences"])
            out.append({"workload": workload, "seed": seed,
                        "control": name, "windows": len(ref),
                        "numbers": numbers,
                        "correct": check.verdict(numbers),
                        "reference_s": t_ref,
                        "control_s": time.perf_counter() - t1})
        return out
    finally:
        shutil.rmtree(work, ignore_errors=True)


def main(argv=None):
    ap = argparse.ArgumentParser(prog="portbench/control.py")
    ap.add_argument("--workload", action="append", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--out", required=True)
    a = ap.parse_args(argv)
    out = []
    for wl in a.workload:
        for s in a.seeds:
            for r in control_numbers(wl, s):
                print(json.dumps(r), flush=True)
                out.append(r)
    with open(a.out, "w") as f:
        json.dump(out, f, indent=1)
    return 0 if not any(r["correct"] for r in out) else 1


if __name__ == "__main__":
    sys.exit(main())

"""The strip sweeps against variants of themselves, on one card, timed in
turns: the scored sweep's int32 strip kernel (K2 and K5,
kernels/csrc/nw_sweep.cu at W > 256) and the int16 one (K2-16,
kernels/csrc/nw_sweep16.cu at W > 256, RACON_TPU_DP16=1):

    python -m racon_tpu_torch.benchmarks.strip_ab [--kernel int32 int16]
        [--trap POLLS] [--json PATH]

Each variant is this checkout's sources with one line rewritten, built
like kernel_ab.py's builds (nvcc, plain C launchers, ctypes), every build
started at once. int32: "rule" as it is; "lpt4" and "lpt8" with
strip_lanes fixed at four and eight band lanes a thread, the two sides of
its rule; "noscan" without the five shuffles of the warp scan and
"nowait" without the hand-off waits (common.cuh's await_row), which time
what those parts cost and give wrong bytes. int16: "rule" as it is; "p2",
"p4" and "p8" with strip16_pairs fixed at two, four or eight s16x2 pairs
a thread (strips of 128, 256 or 512 band lanes). With --trap, every build
takes -DRTT_WAIT_POLLS=POLLS, so that a hand-off wait that never ends
traps instead of hanging the card (a first call after a change to a
kernel). Per shape (kernel_ab.py's items, seed 7 for int32 at K2's and
K5's shapes, seed 16 for int16; the align scores with every deletion bit
set, the consensus scores with 30 % free deletion columns): the variants
that keep the bytes against this checkout's int32 strip kernel on every
item, then CUDA-event ms (mean of 3 launches after a warm-up) in the
order of the variants and back, the int16 ones between two timings of
the int32 kernel; us a query row. Also ptxas's registers and spills of
each build's strip kernels.

Needs nvcc and a CUDA device (exit 2 without one). Prints the card's
name and power limit first and one JSON line last.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile

import numpy as np

from .kernel_ab import ARCH, CSRC, cuda_ms, items, load, ptr

SCORES = {"consensus": (5, -4, -8), "align": (0, -1, -1)}
_LANES = "static int strip_lanes(int W, int B) {"
_PAIRS = "static int strip16_pairs(int W, int B) {"


def _fixed(file: str, rule: str, n: int) -> list:
    return [(file, rule, f"{rule}\n  return {n};")]


# per kernel: its source, its variants (edits as (file, old, new)), those
# that keep the bytes, its shapes (cap, W, B, scores) and the seed of its
# items
KERNELS = {
    "int32": {
        "source": "nw_sweep.cu",
        "variants": {
            "rule": [],
            "lpt4": _fixed("nw_sweep.cu", _LANES, 4),
            "lpt8": _fixed("nw_sweep.cu", _LANES, 8),
            "noscan": [("nw_sweep.cu",
                        "  for (int s = 1; s < 32; s <<= 1) v = max(v, "
                        "__shfl_up_sync(kFull, v, s));\n", "")],
            "nowait": [("common.cuh",
                        "  while (!__all_sync(kFull, static_cast<int>(v >> "
                        "32) >= row)) {", "  while (false) {")]},
        "exact": ("rule", "lpt4", "lpt8"),
        "shapes": ((10240, 1024, 4, "align"), (10240, 1024, 409, "align"),
                   (5120, 1024, 8, "consensus"),
                   (5120, 1024, 819, "consensus"),
                   (10240, 2048, 16, "consensus"),
                   (10240, 2048, 204, "consensus"),
                   (10240, 4096, 4, "align"), (40960, 4096, 25, "align")),
        "seed": 7},
    "int16": {
        "source": "nw_sweep16.cu",
        "variants": {"rule": [],
                     "p2": _fixed("nw_sweep16.cu", _PAIRS, 2),
                     "p4": _fixed("nw_sweep16.cu", _PAIRS, 4),
                     "p8": _fixed("nw_sweep16.cu", _PAIRS, 8)},
        "exact": ("rule", "p2", "p4", "p8"),
        "shapes": ((2560, 512, 1024, "align"), (2560, 512, 528, "align"),
                   (2560, 512, 264, "align"), (2560, 512, 132, "align"),
                   (640, 288, 37, "consensus"), (5120, 1024, 8, "align"),
                   (5120, 1024, 1024, "align")),
        "seed": 16},
}
REF = "int32"  # this checkout's int32 strip kernel, unedited


def start_build(kernel: str, name: str, tmp: str, trap: int | None):
    """Start nvcc on `kernel`'s source with variant `name`'s edits (none
    for the reference) into tmp. Returns (process, library path)."""
    from torch.utils.cpp_extension import CUDA_HOME

    spec = KERNELS[kernel]
    src = os.path.join(tmp, f"{kernel}_{name}")
    shutil.copytree(CSRC, src)
    for file, old, new in spec["variants"].get(name, []):
        path = os.path.join(src, file)
        text = open(path).read()
        if old not in text:
            raise SystemExit(f"strip_ab: {kernel} variant {name} no longer "
                             "applies")
        open(path, "w").write(text.replace(old, new))
    so = src + ".so"
    nvcc = os.path.join(CUDA_HOME or "/usr/local/cuda", "bin", "nvcc")
    flags = [f"-DRTT_WAIT_POLLS={trap}"] if trap else []
    return subprocess.Popen(
        [nvcc, ARCH, "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
         "-Xptxas", "-v", *flags, "-o", so,
         os.path.join(src, spec["source"])],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), so


def finish_build(label: str, proc, so: str) -> tuple[ctypes.CDLL, dict]:
    """The built library and ptxas's {kernel: (registers, spill bytes)}
    of its strip kernels."""
    out, _ = proc.communicate()
    if proc.returncode:
        raise SystemExit(f"strip_ab: the {label} build failed:\n{out}")
    regs, kernel, spill = {}, None, 0
    for line in out.splitlines():
        m = re.search(r"Compiling entry function '\w*strip_kernelILi(\d+)",
                      line)
        if m:
            kernel = f"strip<{m.group(1)}>"
        m = re.search(r"(\d+) bytes spill stores", line)
        if kernel and m:
            spill = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if kernel and m:
            regs[kernel] = (int(m.group(1)), spill)
            kernel = None
    return load(so), regs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--kernel", nargs="+", choices=list(KERNELS),
                    default=list(KERNELS), help="time only these kernels")
    ap.add_argument("--trap", type=int, help="build with "
                    "-DRTT_WAIT_POLLS=TRAP (a wait traps after that many "
                    "polls)")
    ap.add_argument("--json", help="also write the result rows here")
    args = ap.parse_args()

    import torch

    from racon_tpu_torch.ops.batch import to_device
    from racon_tpu_torch.ops.geometry import (scan_span, sweep16_pairs,
                                              sweep_lanes)

    if not torch.cuda.is_available():
        sys.stderr.write("strip_ab: no CUDA device\n")
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    rules = {"int32": sweep_lanes, "int16": sweep16_pairs}
    stream = lambda: ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    rows, ptxas = [], {}
    with tempfile.TemporaryDirectory() as tmp:
        procs = {REF: start_build("int32", "ref", tmp, args.trap)}
        for kernel in args.kernel:
            for name in KERNELS[kernel]["variants"]:
                procs[f"{kernel}_{name}"] = start_build(kernel, name, tmp,
                                                        args.trap)
        libs = {}
        for label, (proc, so) in procs.items():
            libs[label], ptxas[label] = finish_build(label, proc, so)
            print(f"[ptxas] {label}: {ptxas[label]} (registers, spill "
                  "bytes)", flush=True)
        for kernel in args.kernel:
            spec = KERNELS[kernel]
            names = list(spec["variants"])
            rng = np.random.default_rng(spec["seed"])
            for cap, W, B, kind in spec["shapes"]:
                sc = SCORES[kind]
                q4, t4, m, n = items(rng, B, cap, W)
                dcb = np.packbits(rng.random((B, cap)) >= 0.3, axis=1,
                                  bitorder="little")
                if kind == "align":
                    dcb[:] = 0xFF
                g = to_device(q4, t4, dcb, m, n, m_cap=cap, n_cap=cap,
                              device="cuda")
                # geometry.dp_consts's fill; the int16 gate holds it
                neg = -((2 * cap) * max(map(abs, sc)) + 64)
                if kernel == "int16" and 2 * -neg > 30000:
                    raise SystemExit(f"({cap},{W}) {sc}: outside the int16 "
                                     "gate")
                nmv = B * (cap // 16) * W
                buf = torch.empty(nmv + B, dtype=torch.int32, device="cuda")

                def run(label):
                    head = (ptr(g.q4), ptr(g.t4), ptr(g.dcb), ptr(buf),
                             ptr(buf[nmv:]), B, cap, cap, W, *sc,
                             scan_span(W))
                    if label == REF or kernel == "int32":
                        rc = libs[label].rtt_nw_sweep(*head, stream())
                    else:
                        rc = libs[label].rtt_nw_sweep16(*head, neg,
                                                        stream())
                    if rc:
                        raise SystemExit(f"{label}: launch error {rc}")

                run(REF)
                torch.cuda.synchronize()
                want = buf.clone()
                for name in spec["exact"]:
                    buf.fill_(0x55)
                    run(f"{kernel}_{name}")
                    torch.cuda.synchronize()
                    if not torch.equal(buf, want):
                        bad = (buf != want).nonzero()[:4].flatten().tolist()
                        raise SystemExit(f"{kernel} {name} ({cap},{W}) "
                                         f"B={B}: differs from the int32 "
                                         f"strip kernel at {bad}")
                del want
                order = names + names[::-1]
                if kernel != "int32":
                    order = [REF] + order + [REF]
                times = {}
                for name in order:
                    label = name if name == REF else f"{kernel}_{name}"
                    times.setdefault(name, []).append(
                        cuda_ms(lambda: run(label), reps=3))
                ms = {k: sum(v) / len(v) for k, v in times.items()}
                row = {"kernel": kernel, "shape": [cap, W], "B": B,
                       "scores": kind, "rule": rules[kernel](W, B),
                       "exact": list(spec["exact"]), "ms": ms,
                       "ms_runs": times,
                       "us_per_row": {k: 1e3 * v / cap
                                      for k, v in ms.items()}}
                print(f"{kernel} ({cap},{W}) B={B} {kind} (rule "
                      f"{row['rule']}; {', '.join(spec['exact'])} "
                      "byte-equal to the int32 strip kernel): " + ", ".join(
                          f"{k} {v:.4f} ms ({1e3 * v / cap:.4f} us a row)"
                          for k, v in ms.items()), flush=True)
                rows.append(row)
                del buf, g
                torch.cuda.empty_cache()
    line = json.dumps({"device": torch.cuda.get_device_name(0),
                       "ptxas": ptxas, "rows": rows})
    if args.json:
        with open(args.json, "w") as f:
            f.write(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())

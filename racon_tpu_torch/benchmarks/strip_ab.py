"""The scored sweep's strip kernel (K2 and K5, kernels/csrc/nw_sweep.cu at
W > 256) against variants of itself, on one card, timed in turns:

    python -m racon_tpu_torch.benchmarks.strip_ab [--json PATH]

Each variant is this checkout's nw_sweep.cu with one line rewritten,
built like kernel_ab.py's builds (nvcc, plain C launchers, ctypes):
"rule" as it is; "lpt4" and "lpt8" with strip_lanes fixed at four and
eight band lanes a thread, the two sides of its rule; "noscan" without
the five shuffles of the warp scan and "nowait" without the hand-off
waits, which time what those parts cost and give wrong bytes. Per shape
(kernel_ab.py's K2 and K5 shapes and inputs, seed 7): rule, lpt4 and
lpt8 byte for byte on every item, then CUDA-event ms (mean of 3 launches
after a warm-up) in the order of VARIANTS and back, and us a query row.
Also ptxas's registers and spills of each build's strip kernels.

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

from .kernel_ab import ARCH, CSRC, cuda_ms, items, ptr

VARIANTS = ("rule", "lpt4", "lpt8", "noscan", "nowait")
_RULE = "static int strip_lanes(int W, int B) {"
_EDITS = {
    "rule": [],
    "lpt4": [(_RULE, _RULE + "\n  return 4;")],
    "lpt8": [(_RULE, _RULE + "\n  return 8;")],
    "noscan": [("  for (int s = 1; s < 32; s <<= 1) v = max(v, "
                "__shfl_up_sync(kFull, v, s));\n", "")],
    "nowait": [("  while (!__all_sync(kFull, static_cast<int>(v >> 32) >= "
                "row)) {", "  while (false) {")],
}
SHAPES = ((10240, 1024, 4, "align"), (10240, 1024, 409, "align"),
          (5120, 1024, 8, "consensus"), (5120, 1024, 819, "consensus"),
          (10240, 2048, 16, "consensus"), (10240, 2048, 204, "consensus"),
          (10240, 4096, 4, "align"), (40960, 4096, 25, "align"))
SCORES = {"consensus": (5, -4, -8), "align": (0, -1, -1)}


def build(name: str, tmp: str) -> tuple[ctypes.CDLL, dict]:
    """nw_sweep.cu with variant `name`'s edits into tmp/name.so; ptxas's
    {kernel: (registers, spill bytes)} of its strip kernels."""
    from torch.utils.cpp_extension import CUDA_HOME

    src = os.path.join(tmp, name)
    shutil.copytree(CSRC, src)
    path = os.path.join(src, "nw_sweep.cu")
    text = open(path).read()
    for old, new in _EDITS[name]:
        if old not in text:
            raise SystemExit(f"strip_ab: variant {name} no longer applies")
        text = text.replace(old, new)
    open(path, "w").write(text)
    so = os.path.join(tmp, name + ".so")
    nvcc = os.path.join(CUDA_HOME or "/usr/local/cuda", "bin", "nvcc")
    out = subprocess.run([nvcc, ARCH, "-std=c++17", "-O3", "-shared",
                          "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-o", so,
                          path], capture_output=True, text=True, check=True)
    regs, kernel = {}, None
    for line in out.stderr.splitlines():
        m = re.search(r"Compiling entry function '\w*strip_kernelILi(\d+)", line)
        if m:
            kernel = f"strip<{m.group(1)}>"
        m = re.search(r"(\d+) bytes spill stores", line)
        if kernel and m:
            spill = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if kernel and m:
            regs[kernel] = (int(m.group(1)), spill)
            kernel = None
    lib = ctypes.CDLL(so)
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.rtt_nw_sweep.argtypes = [P] * 5 + [I] * 8 + [P]
    lib.rtt_nw_sweep.restype = I
    return lib, regs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--json", help="also write the result rows here")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        sys.stderr.write("strip_ab: no CUDA device\n")
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    from racon_tpu_torch.ops.batch import to_device
    from racon_tpu_torch.ops.geometry import scan_span, sweep_lanes

    stream = lambda: ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    rows, ptxas = [], {}
    with tempfile.TemporaryDirectory() as tmp:
        libs = {}
        for name in VARIANTS:
            libs[name], ptxas[name] = build(name, tmp)
            print(f"ptxas {name}: {ptxas[name]} (registers, spill bytes)",
                  flush=True)
        rng = np.random.default_rng(7)
        for cap, W, B, kind in SHAPES:
            sc = SCORES[kind]
            q4, t4, m, n = items(rng, B, cap, W)
            dcb = np.packbits(rng.random((B, cap)) >= 0.3, axis=1,
                              bitorder="little")
            if kind == "align":
                dcb[:] = 0xFF
            g = to_device(q4, t4, dcb, m, n, m_cap=cap, n_cap=cap,
                          device="cuda")
            nmv = B * (cap // 16) * W
            buf = torch.empty(nmv + B, dtype=torch.int32, device="cuda")

            def run(lib):
                rc = lib.rtt_nw_sweep(ptr(g.q4), ptr(g.t4), ptr(g.dcb),
                                      ptr(buf), ptr(buf[nmv:]), B, cap, cap,
                                      W, *sc, scan_span(W), stream())
                if rc:
                    raise SystemExit(f"rtt_nw_sweep: error {rc}")

            outs = []
            for name in ("rule", "lpt4", "lpt8"):
                buf.fill_(0x55)
                run(libs[name])
                torch.cuda.synchronize()
                outs.append(buf.clone())
            if not all(torch.equal(outs[0], o) for o in outs[1:]):
                raise SystemExit(f"({cap},{W}) B={B}: lpt4 or lpt8 differs")
            del outs
            times = {name: [] for name in VARIANTS}
            for name in VARIANTS + VARIANTS[::-1]:
                times[name].append(cuda_ms(lambda: run(libs[name]), reps=3))
            ms = {k: sum(v) / len(v) for k, v in times.items()}
            row = {"shape": [cap, W], "B": B, "scores": kind,
                   "rule_lanes": sweep_lanes(W, B), "ms_runs": times,
                   "ms": ms,
                   "us_per_row": {k: 1e3 * v / cap for k, v in ms.items()}}
            print(f"({cap},{W}) B={B} ({kind}, rule: {row['rule_lanes']} "
                  "lanes a thread): " + ", ".join(
                      f"{k} {v:.3f} ms ({1e3 * v / cap:.4f} us a row)"
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

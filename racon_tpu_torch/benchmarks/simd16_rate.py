"""What sm_90a makes of the packed 16x2 integer operations, and at what
rate the card issues them, for the int16 sweeps (kernels/csrc/
nw_sweep16.cu):

    python -m racon_tpu_torch.benchmarks.simd16_rate [SOURCE.cu ...]
        [--sass-dir DIR]

1. SASS: each source (by default simd16_rate.cu beside this file and
   kernels/csrc/nw_sweep16.cu) compiled to a cubin for sm_90a and read
   with cuobjdump -sass; per kernel, the count of each opcode (with its
   .S16x2 / .U16x2 modifiers), one line per kernel; with --sass-dir, each
   source's whole listing to DIR/<n>_<source>.sass (n its place in the
   list), to count a row loop's instructions from.
2. Rates: simd16_rate.cu's kernels, one per operation, each thread running
   8 chains of it (each also pays one LOP3 a step to mix in its
   neighbour chain, so an operation issued at the LOP3's rate shows as
   half of it); instructions per second over the whole
   card (CUDA events around one launch after a warm-up), and the same as
   a fraction of the INT32 rate of chip_smoke.py's bound model (132 SMs x
   64 lanes x 1.98 GHz = 16.73 T/s).

Needs nvcc and a CUDA device (exit 2 without one). Prints the card's
name and power limit first.
"""

from __future__ import annotations

import argparse
import collections
import ctypes
import os
import re
import subprocess
import sys
import tempfile

_HERE = os.path.dirname(os.path.abspath(__file__))
PROBE = os.path.join(_HERE, "simd16_rate.cu")
CSRC = os.path.join(_HERE, "..", "kernels", "csrc")
SWEEP16 = os.path.join(CSRC, "nw_sweep16.cu")
ARCH = "-gencode=arch=compute_90a,code=sm_90a"
OPS = ("iadd (32-bit)", "max (32-bit)", "__vadd2", "__vsub2", "__vmaxs2",
       "__vminu2", "__vcmpeq2 (+xor)", "__viaddmax_s16x2",
       "__vimax3_s16x2", "__viaddmax_s32", "__byte_perm", "lop3")
INT32_OPS_PER_S = 132 * 64 * 1.98e9


def _tool(name: str) -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    return os.path.join(CUDA_HOME or "/usr/local/cuda", "bin", name)


def sass_opcodes(src: str, tmp: str,
                 listing: str | None = None) -> dict[str, collections.Counter]:
    """{kernel name: Counter of SASS opcodes} of `src` built for sm_90a;
    the listing also written to `listing` when given."""
    cubin = os.path.join(tmp, os.path.basename(src) + ".cubin")
    subprocess.run([_tool("nvcc"), ARCH, "-std=c++17", "-O3", "-cubin",
                    "-I", CSRC, "-o", cubin, src], check=True)
    sass = subprocess.run([_tool("cuobjdump"), "-sass", cubin], check=True,
                          capture_output=True, text=True).stdout
    if listing:
        with open(listing, "w") as f:
            f.write(sass)
    out: dict[str, collections.Counter] = {}
    name = None
    for line in sass.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name = m.group(1)
            out[name] = collections.Counter()
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][\w.]*)",
                     line)
        if m and name:
            out[name][m.group(1)] += 1
    return out


def kernel_name(mangled: str) -> str:
    """name<template arguments> of the kernel in a mangled symbol: its
    length-prefixed identifier that ends in "_kernel" (the hashes of an
    anonymous namespace hold digits too, so the length decides)."""
    for m in re.finditer(r"(?=(\d{1,3})([A-Za-z_]\w*))", mangled):
        n, ident = int(m.group(1)), m.group(2)
        if len(ident) >= n and ident[:n].endswith("_kernel"):
            t = re.match(r"I((?:L[a-z]\d+E)+)E", ident[n:])
            args = re.findall(r"L[a-z](\d+)E", t.group(1)) if t else []
            return ident[:n] + (f"<{','.join(args)}>" if args else "")
    return mangled


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        sys.stderr.write("simd16_rate: no CUDA device\n")
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip().splitlines()
    print(smi[0] if smi else torch.cuda.get_device_name(0), flush=True)
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("sources", nargs="*", default=[PROBE, SWEEP16])
    ap.add_argument("--sass-dir", help="write each source's SASS here")
    args = ap.parse_args()
    if args.sass_dir:
        os.makedirs(args.sass_dir, exist_ok=True)
    with tempfile.TemporaryDirectory() as tmp:
        for n, src in enumerate(args.sources):
            listing = (os.path.join(args.sass_dir,
                                    f"{n}_{os.path.basename(src)}.sass")
                       if args.sass_dir else None)
            for kernel, ops in sass_opcodes(src, tmp, listing).items():
                simd = {k: v for k, v in sorted(ops.items())
                        if re.search(r"VI|PRMT|IMNMX|LOP3|IADD|SHFL|VABS|"
                                     r"ISETP|SEL|IMAD|SHF|STS|LDS|STG",
                                     k)}
                print(f"[sass] {os.path.basename(src)} "
                      f"{kernel_name(kernel)}: {sum(ops.values())} "
                      f"instructions; {simd}", flush=True)
        lib_path = os.path.join(tmp, "librate.so")
        subprocess.run([_tool("nvcc"), ARCH, "-std=c++17", "-O3", "-shared",
                        "-Xcompiler", "-fPIC", "-o", lib_path, PROBE],
                       check=True)
        lib = ctypes.CDLL(lib_path)
        lib.rtt_rate.argtypes = [ctypes.c_int, ctypes.c_void_p] + \
            [ctypes.c_int] * 3
        lib.rtt_rate.restype = ctypes.c_float
        blocks, threads, iters = 132 * 16, 256, 4096
        out = torch.empty(blocks * threads, dtype=torch.int32, device="cuda")
        n_ops = blocks * threads * iters * lib.rtt_rate_chains()
        for op in range(lib.rtt_rate_ops()):
            ms = lib.rtt_rate(op, ctypes.c_void_p(out.data_ptr()), blocks,
                              threads, iters)
            if ms <= 0:
                raise RuntimeError(f"rate kernel {OPS[op]} failed")
            rate = n_ops / (ms * 1e-3)
            print(f"[rate] {OPS[op]}: {ms:.3f} ms, {rate / 1e12:.2f} T "
                  f"instructions/s per thread = {rate / INT32_OPS_PER_S:.3f}"
                  f" of the INT32 model", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Build-on-demand loader for the port's native C++ runtime.

The library is compiled from racon_tpu_torch/native/src with g++ the first
time it is needed, into racon_tpu_torch/native/build/ (gitignored). Its
file name carries a hash of the sources, the compiler flags and this
host's CPU (model and flags from /proc/cpuinfo), so a library built with
-march=native on another machine, or from other sources, is never loaded:
it simply has another name. Each process compiles to a temporary file of
its own and renames it into place, under a file lock, so concurrent
builders (test workers) neither collide nor build twice. No pybind11: the
C API is consumed through ctypes.

build_poa_bench() builds the star-POA merge micro-benchmark
(native/bench/poa_bench.cpp, with src/poa.cpp and src/align.cpp) into the
same directory the same way; `python -m racon_tpu_torch.native.loader
poa_bench` builds it and prints its path.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import subprocess
import sys
import threading

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "src")
_POA_BENCH = os.path.join(_HERE, "bench", "poa_bench.cpp")
BUILD_DIR = os.path.join(_HERE, "build")
# extra flags, e.g. RACON_TPU_NATIVE_CXXFLAGS="-fsanitize=address -g" for
# sanitizer builds (run python under LD_PRELOAD=libasan.so)
_FLAGS = ("-O3", "-march=native", "-std=c++17", "-shared", "-fPIC",
          "-pthread")

_lock = threading.Lock()
_lib = None
_tried = False


def _sources() -> list[str]:
    if not os.path.isdir(_SRC):
        return []
    return sorted(os.path.join(_SRC, f) for f in os.listdir(_SRC)
                  if f.endswith((".cpp", ".hpp")))


def _cpu_signature() -> bytes:
    """The CPU model and feature flags of this host (what -march=native
    compiles for), from the first processor entry of /proc/cpuinfo."""
    keep = (b"vendor_id", b"model name", b"flags", b"Features", b"CPU part")
    try:
        with open("/proc/cpuinfo", "rb") as f:
            text = f.read()
    except OSError:
        return os.uname().machine.encode()
    first = text.split(b"\n\n", 1)[0]
    return b"\n".join(line for line in first.splitlines()
                      if line.split(b":", 1)[0].strip() in keep)


def _hashed(stem: str, suffix: str, sources: list[str],
            flags: list[str]) -> str:
    """BUILD_DIR/<stem>_<hash><suffix>: the hash covers `sources`, `flags`
    and this CPU."""
    h = hashlib.sha256()
    for s in sources:
        h.update(os.path.basename(s).encode() + b"\0")
        with open(s, "rb") as f:
            h.update(f.read())
    h.update("\0".join(flags).encode())
    h.update(_cpu_signature())
    return os.path.join(BUILD_DIR, f"{stem}_{h.hexdigest()[:16]}{suffix}")


def lib_path(sources: list[str], flags: list[str]) -> str:
    """Where the library built from `sources` with `flags` on this CPU
    lives."""
    return _hashed("libracon_host", ".so", sources, flags)


def _extra_flags() -> list[str]:
    return os.environ.get("RACON_TPU_NATIVE_CXXFLAGS", "").split()


def build(verbose: bool = False) -> str | None:
    """Path of the built library (building it if needed), None on
    failure."""
    sources = _sources()
    if not sources:
        return None
    flags = [*_FLAGS, *_extra_flags()]
    return _compile(lib_path(sources, flags), flags,
                    [s for s in sources if s.endswith(".cpp")], ["-lz"],
                    verbose)


def build_poa_bench(verbose: bool = False) -> str | None:
    """Path of the poa_bench executable (building it if needed), None on
    failure. Its sources: bench/poa_bench.cpp, src/poa.cpp, src/align.cpp
    and their headers."""
    sources = [_POA_BENCH, *(os.path.join(_SRC, f) for f in (
        "align.cpp", "align.hpp", "common.hpp", "poa.cpp", "poa.hpp"))]
    flags = ["-O3", "-march=native", "-std=c++17", "-pthread", "-I", _SRC,
             *_extra_flags()]
    return _compile(_hashed("poa_bench", "", sources, flags), flags,
                    [s for s in sources if s.endswith(".cpp")], [], verbose)


def _compile(target: str, flags: list[str], cpp: list[str],
             libs: list[str], verbose: bool) -> str | None:
    """g++ `flags` `cpp` `libs` into `target`, unless it exists: into a
    temporary file of this process, renamed into place under the build
    directory's lock. Returns target, or None if the build failed."""
    if os.path.exists(target):
        return target
    os.makedirs(BUILD_DIR, exist_ok=True)
    with open(os.path.join(BUILD_DIR, "build.lock"), "w") as fl:
        fcntl.flock(fl, fcntl.LOCK_EX)
        if os.path.exists(target):  # built by another process meanwhile
            return target
        tmp = f"{target}.{os.getpid()}.tmp"
        cmd = ["g++", *flags, "-o", tmp, *cpp, *libs]
        try:
            res = subprocess.run(cmd, capture_output=True, text=True,
                                 timeout=600)
        except (OSError, subprocess.TimeoutExpired) as e:
            sys.stderr.write(f"[racon_tpu_torch::native] build failed: {e}\n")
            return None
        if res.returncode != 0:
            sys.stderr.write("[racon_tpu_torch::native] build failed:\n"
                             f"{res.stderr}\n")
            if os.path.exists(tmp):
                os.remove(tmp)
            return None
        os.replace(tmp, target)
    if verbose:
        sys.stderr.write(f"[racon_tpu_torch::native] built {target}\n")
    return target


def get() -> ctypes.CDLL | None:
    global _lib, _tried
    with _lock:
        if _lib is not None:
            return _lib
        if _tried:
            return None
        _tried = True
        path = build()
        if path is None:
            return None
        try:
            _lib = ctypes.CDLL(path)
        except OSError as e:
            sys.stderr.write(f"[racon_tpu_torch::native] load failed: {e}\n")
            return None
        return _lib


def available() -> bool:
    return get() is not None


if __name__ == "__main__":
    if sys.argv[1:] != ["poa_bench"]:
        sys.exit("usage: python -m racon_tpu_torch.native.loader poa_bench")
    path = build_poa_bench(verbose=True)
    if path is None:
        sys.exit(1)
    print(path)

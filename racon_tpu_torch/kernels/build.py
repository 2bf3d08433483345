"""Build and load the port's CUDA kernels at first use.

Sources live in racon_tpu_torch/kernels/csrc: four .cu files with plain C
launchers (nw_sweep, rle_walk, myers_sweep, myers_walk) and one small
binding, bindings.cpp, the only file that includes torch/extension.h. They
are compiled for sm_90a into racon_tpu_torch/kernels/build/ (gitignored)
by torch.utils.cpp_extension.load. Where ninja is missing, nvcc builds the
.cu files alone into a shared library that ctypes loads.

Nothing here runs at import time: `kernels()` builds on the first call
(under a thread lock and an inter-process file lock) and raises if the
build fails -- there is no fallback to the plain PyTorch versions.
"""

from __future__ import annotations

import ctypes
import fcntl
import os
import shutil
import subprocess
import threading
import time

import torch

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(_HERE, "build")
KERNEL_SOURCES = ("nw_sweep.cu", "rle_walk.cu", "myers_sweep.cu",
                  "myers_walk.cu")
ARCH_FLAGS = ["-gencode=arch=compute_90a,code=sm_90a"]
_NAME = "racon_tpu_torch_kernels"

_lock = threading.Lock()
_kernels = None
build_seconds: float | None = None  # wall time of this process's build


class KernelBuildError(RuntimeError):
    pass


def kernels():
    """The loaded kernel module: `nw_sweep`, `rle_walk`, `myers_sweep` and
    `myers_walk`, each taking CUDA tensors (outputs preallocated by the
    caller) and launching on the current stream."""
    global _kernels, build_seconds
    with _lock:
        if _kernels is None:
            os.makedirs(BUILD_DIR, exist_ok=True)
            t0 = time.perf_counter()
            with open(os.path.join(BUILD_DIR, "build.flock"), "w") as fl:
                fcntl.flock(fl, fcntl.LOCK_EX)
                try:
                    _kernels = _build()
                finally:
                    fcntl.flock(fl, fcntl.LOCK_UN)
            build_seconds = time.perf_counter() - t0
        return _kernels


def _build():
    from torch.utils import cpp_extension

    if cpp_extension.is_ninja_available():
        # load()'s own baton file: a build killed mid-way leaves it behind
        # and load() would wait on it forever; the flock held here means no
        # other build of ours is running
        stale = os.path.join(BUILD_DIR, "lock")
        if os.path.exists(stale):
            os.remove(stale)
        sources = [os.path.join(CSRC, s)
                   for s in KERNEL_SOURCES + ("bindings.cpp",)]
        try:
            return cpp_extension.load(
                name=_NAME, sources=sources, build_directory=BUILD_DIR,
                extra_cflags=["-O2"],
                extra_cuda_cflags=["-O3", "-std=c++17", *ARCH_FLAGS],
                verbose=False)
        except (RuntimeError, OSError) as e:
            raise KernelBuildError(f"kernel build failed: {e}") from e
    return _CtypesKernels(_build_nvcc())


def _build_nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    nvcc = (os.path.join(CUDA_HOME, "bin", "nvcc") if CUDA_HOME
            else shutil.which("nvcc"))
    if not nvcc or not os.path.exists(nvcc):
        raise KernelBuildError("nvcc not found: cannot build the kernels")
    lib = os.path.join(BUILD_DIR, f"lib{_NAME}.so")
    cmd = [nvcc, *ARCH_FLAGS, "-std=c++17", "-O3", "-shared",
           "-Xcompiler", "-fPIC", "-o", lib + ".tmp",
           *(os.path.join(CSRC, s) for s in KERNEL_SOURCES)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise KernelBuildError(f"nvcc failed:\n{res.stderr}")
    os.replace(lib + ".tmp", lib)
    return lib


class _CtypesKernels:
    """The C launchers bound through ctypes, with the same checks and
    call signatures as the PyTorch binding in csrc/bindings.cpp."""

    def __init__(self, path: str):
        lib = ctypes.CDLL(path)
        P, I = ctypes.c_void_p, ctypes.c_int
        sigs = {"rtt_nw_sweep": [P] * 5 + [I] * 8 + [P],
                "rtt_rle_walk": [P] * 4 + [I] * 5 + [P],
                "rtt_myers_sweep": [P] * 3 + [I] * 4 + [P],
                "rtt_myers_walk": [P] * 4 + [I] * 4 + [P]}
        for name, argtypes in sigs.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = I
        lib.rtt_error_string.argtypes = [I]
        lib.rtt_error_string.restype = ctypes.c_char_p
        self._lib = lib

    @staticmethod
    def _check(t, name, dtype, shape):
        if not t.is_cuda:
            raise ValueError(f"{name} must be a CUDA tensor")
        if t.dtype != dtype:
            raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                             f"expected {tuple(shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        return ctypes.c_void_p(t.data_ptr()) if t.numel() else None

    def _call(self, fn, *args):
        rc = fn(*args, ctypes.c_void_p(
            torch.cuda.current_stream().cuda_stream))
        if rc != 0:
            raise RuntimeError("kernel launch failed: "
                               + self._lib.rtt_error_string(rc).decode())

    def nw_sweep(self, q4, t4, dcb, moves, score, m_cap, n_cap, W, match,
                 mismatch, gap, span):
        B = q4.shape[0]
        if not (W % 32 == 0 and W <= 1024 and m_cap % 16 == 0
                and n_cap % 32 == 0 and n_cap - m_cap - W // 2 <= 0):
            raise ValueError("nw_sweep: unsupported geometry")
        ptrs = [self._check(q4, "q4", torch.uint8, (B, m_cap // 2)),
                self._check(t4, "t4", torch.uint8, (B, n_cap // 2)),
                self._check(dcb, "dcb", torch.uint8, (B, n_cap // 8)),
                self._check(moves, "moves", torch.int32,
                            (B, m_cap // 16, W)),
                self._check(score, "score", torch.int32, (B,))]
        self._call(self._lib.rtt_nw_sweep, *ptrs, B, m_cap, n_cap, W, match,
                   mismatch, gap, span)

    def rle_walk(self, moves, m, n, payload, m_cap, n_cap, W, E):
        B = moves.shape[0]
        ptrs = [self._check(moves, "moves", torch.int32,
                            (B, m_cap // 16, W)),
                self._check(m, "m", torch.int32, (B,)),
                self._check(n, "n", torch.int32, (B,)),
                self._check(payload, "payload", torch.uint8, (B, E + 1))]
        self._call(self._lib.rtt_rle_walk, *ptrs, B, m_cap, n_cap, W, E)

    def myers_sweep(self, q4, t4, planes, m_cap, n_cap, W):
        B = q4.shape[0]
        if not (W % 32 == 0 and W <= 4096 and m_cap == n_cap):
            raise ValueError("myers_sweep: unsupported geometry")
        ptrs = [self._check(q4, "q4", torch.uint8, (B, m_cap // 2)),
                self._check(t4, "t4", torch.uint8, (B, n_cap // 2)),
                self._check(planes, "planes", torch.int32,
                            (B, m_cap, 2, W // 32))]
        self._call(self._lib.rtt_myers_sweep, *ptrs, B, m_cap, n_cap, W)

    def myers_walk(self, planes, m, n, payload, m_cap, n_cap, W):
        B = planes.shape[0]
        ptrs = [self._check(planes, "planes", torch.int32,
                            (B, m_cap, 2, W // 32)),
                self._check(m, "m", torch.int32, (B,)),
                self._check(n, "n", torch.int32, (B,)),
                self._check(payload, "payload", torch.uint8,
                            (B, m_cap + 2))]
        self._call(self._lib.rtt_myers_walk, *ptrs, B, m_cap, n_cap, W)

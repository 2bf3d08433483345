"""Build and load the port's CUDA kernels at first use.

Sources live in racon_tpu_torch/kernels/csrc: ten .cu files with plain
C launchers (nw_sweep, nw_sweep16, rle_walk, rows_walk, packed_walk,
myers_sweep, myers_walk, nw_sweep_t, pack_gather, myers_moves), their
headers (common.cuh, sweep_scan.cuh), and
one small binding, bindings.cpp, the only file that includes
torch/extension.h. They are compiled for sm_90a into
racon_tpu_torch/kernels/build/ (gitignored) by
torch.utils.cpp_extension.load. Where ninja is missing, nvcc builds the
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
KERNEL_SOURCES = ("nw_sweep.cu", "nw_sweep16.cu", "rle_walk.cu", "rows_walk.cu",
                  "packed_walk.cu", "myers_sweep.cu", "myers_walk.cu",
                  "nw_sweep_t.cu", "pack_gather.cu", "myers_moves.cu")
ARCH_FLAGS = ["-gencode=arch=compute_90a,code=sm_90a"]
_NAME = "racon_tpu_torch_kernels"

_lock = threading.Lock()
_kernels = None
build_seconds: float | None = None  # wall time of this process's build


class KernelBuildError(RuntimeError):
    pass


def kernels():
    """The loaded kernel module: `nw_sweep`, `nw_sweep16`, `rle_walk`,
    `rows_walk`, `packed_walk`, `myers_sweep`, `myers_walk`,
    `nw_sweep_t`, `pack_gather` and `myers_moves`, each
    taking CUDA tensors on one device (outputs preallocated by the caller)
    and launching under that device, on its current stream."""
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
                "rtt_nw_sweep16": [P] * 5 + [I] * 9 + [P],
                "rtt_rle_walk": [P] * 4 + [I] * 5 + [P],
                "rtt_rows_walk": [P] * 4 + [I] * 4 + [P],
                "rtt_packed_walk": [P] * 4 + [I] * 5 + [P],
                "rtt_myers_sweep": [P] * 3 + [I] * 4 + [P],
                "rtt_myers_walk": [P] * 4 + [I] * 4 + [P],
                "rtt_nw_sweep_t": [P] * 5 + [I] * 9 + [P],
                "rtt_pack_gather": [P, I, P, I, P, I] + [P] * 4 + [I] * 3
                + [P],
                "rtt_myers_moves": [P] * 3 + [I] * 4 + [P]}
        for name, argtypes in sigs.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = I
        lib.rtt_error_string.argtypes = [I]
        lib.rtt_error_string.restype = ctypes.c_char_p
        self._lib = lib

    @staticmethod
    def _check(t, name, dtype, shape, device):
        if not t.is_cuda:
            raise ValueError(f"{name} must be a CUDA tensor")
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, the launch on "
                             f"{device}")
        if t.dtype != dtype:
            raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                             f"expected {tuple(shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        return ctypes.c_void_p(t.data_ptr()) if t.numel() else None

    @staticmethod
    def _device(first, name):
        """The device of a launch: its first tensor's, a CUDA one."""
        if not first.is_cuda:
            raise ValueError(f"{name} must be a CUDA tensor")
        return first.device

    def _call(self, fn, device, *args):
        """fn under `device` (so the launcher's cudaFuncSetAttribute calls
        apply to it), on that device's current stream."""
        with torch.cuda.device(device):
            rc = fn(*args, ctypes.c_void_p(
                torch.cuda.current_stream(device).cuda_stream))
        if rc != 0:
            raise RuntimeError("kernel launch failed: "
                               + self._lib.rtt_error_string(rc).decode())

    def nw_sweep(self, q4, t4, dcb, moves, score, m_cap, n_cap, W, match,
                 mismatch, gap, span):
        B = q4.shape[0]
        dev = self._device(q4, "q4")
        lanes = 1 if W <= 1024 else (2 if W <= 2048 else 4)
        if not (W % (32 * lanes) == 0 and W <= 4096
                and m_cap % 16 == 0 and n_cap % 32 == 0
                and n_cap - m_cap - W // 2 <= 0):
            raise ValueError("nw_sweep: unsupported geometry")
        ptrs = [self._check(q4, "q4", torch.uint8, (B, m_cap // 2), dev),
                self._check(t4, "t4", torch.uint8, (B, n_cap // 2), dev),
                self._check(dcb, "dcb", torch.uint8, (B, n_cap // 8), dev),
                self._check(moves, "moves", torch.int32,
                            (B, m_cap // 16, W), dev),
                self._check(score, "score", torch.int32, (B,), dev)]
        self._call(self._lib.rtt_nw_sweep, dev, *ptrs, B, m_cap, n_cap, W,
                   match, mismatch, gap, span)

    def nw_sweep16(self, q4, t4, dcb, moves, score, m_cap, n_cap, W, match,
                   mismatch, gap, span, neg):
        B = q4.shape[0]
        dev = self._device(q4, "q4")
        if not (W % 32 == 0 and 0 < W <= 1024 and m_cap % 16 == 0
                and n_cap % 32 == 0 and n_cap - m_cap - W // 2 <= 0
                and -15000 <= neg < 0):
            raise ValueError("nw_sweep16: unsupported geometry")
        ptrs = [self._check(q4, "q4", torch.uint8, (B, m_cap // 2), dev),
                self._check(t4, "t4", torch.uint8, (B, n_cap // 2), dev),
                self._check(dcb, "dcb", torch.uint8, (B, n_cap // 8), dev),
                self._check(moves, "moves", torch.int32,
                            (B, m_cap // 16, W), dev),
                self._check(score, "score", torch.int32, (B,), dev)]
        self._call(self._lib.rtt_nw_sweep16, dev, *ptrs, B, m_cap, n_cap, W,
                   match, mismatch, gap, span, neg)

    def rle_walk(self, moves, m, n, payload, m_cap, n_cap, W, E):
        B = moves.shape[0]
        dev = self._device(moves, "moves")
        ptrs = [self._check(moves, "moves", torch.int32,
                            (B, m_cap // 16, W), dev),
                self._check(m, "m", torch.int32, (B,), dev),
                self._check(n, "n", torch.int32, (B,), dev),
                self._check(payload, "payload", torch.uint8, (B, E + 1),
                            dev)]
        self._call(self._lib.rtt_rle_walk, dev, *ptrs, B, m_cap, n_cap, W, E)

    def rows_walk(self, moves, m, n, payload, m_cap, n_cap, W):
        B = moves.shape[0]
        dev = self._device(moves, "moves")
        ptrs = [self._check(moves, "moves", torch.int32,
                            (B, m_cap // 16, W), dev),
                self._check(m, "m", torch.int32, (B,), dev),
                self._check(n, "n", torch.int32, (B,), dev),
                self._check(payload, "payload", torch.uint8,
                            (B, m_cap + 2), dev)]
        self._call(self._lib.rtt_rows_walk, dev, *ptrs, B, m_cap, n_cap, W)

    def packed_walk(self, moves, m, n, payload, m_cap, n_cap, W, S):
        B = moves.shape[0]
        dev = self._device(moves, "moves")
        if S % 4:
            raise ValueError("packed_walk: step budget must be a multiple "
                             "of 4")
        ptrs = [self._check(moves, "moves", torch.int32,
                            (B, m_cap // 16, W), dev),
                self._check(m, "m", torch.int32, (B,), dev),
                self._check(n, "n", torch.int32, (B,), dev),
                self._check(payload, "payload", torch.uint8,
                            (B, S // 4 + 1), dev)]
        self._call(self._lib.rtt_packed_walk, dev, *ptrs, B, m_cap, n_cap,
                   W, S)

    def myers_sweep(self, q4, t4, planes, m_cap, n_cap, W):
        B = q4.shape[0]
        dev = self._device(q4, "q4")
        if not (W % 32 == 0 and W <= 4096 and m_cap == n_cap):
            raise ValueError("myers_sweep: unsupported geometry")
        ptrs = [self._check(q4, "q4", torch.uint8, (B, m_cap // 2), dev),
                self._check(t4, "t4", torch.uint8, (B, n_cap // 2), dev),
                self._check(planes, "planes", torch.int32,
                            (B, m_cap, 2, W // 32), dev)]
        self._call(self._lib.rtt_myers_sweep, dev, *ptrs, B, m_cap, n_cap, W)

    def myers_walk(self, planes, m, n, payload, m_cap, n_cap, W):
        B = planes.shape[0]
        dev = self._device(planes, "planes")
        ptrs = [self._check(planes, "planes", torch.int32,
                            (B, m_cap, 2, W // 32), dev),
                self._check(m, "m", torch.int32, (B,), dev),
                self._check(n, "n", torch.int32, (B,), dev),
                self._check(payload, "payload", torch.uint8,
                            (B, m_cap + 2), dev)]
        self._call(self._lib.rtt_myers_walk, dev, *ptrs, B, m_cap, n_cap, W)

    def nw_sweep_t(self, q, tp, gcp, moves, score, m_cap, n_cap, W, match,
                   mismatch, gap, span, variant):
        B = q.shape[0]
        dev = self._device(q, "q")
        if not (W % 32 == 0 and 0 < W <= 1024 and m_cap % 128 == 0
                and 2 * (n_cap - m_cap) + W >= 0):
            raise ValueError("nw_sweep_t: unsupported geometry")
        if not 0 <= variant <= 4:
            raise ValueError(f"nw_sweep_t: unknown variant {variant}")
        ptrs = [self._check(q, "q", torch.int32, (B, m_cap), dev),
                self._check(tp, "tp", torch.int32, (B, n_cap + 2 * W), dev),
                self._check(gcp, "gcp", torch.int32, (B, n_cap + 1 + 2 * W),
                            dev),
                self._check(moves, "moves", torch.int32,
                            (B, m_cap // 16, W), dev),
                self._check(score, "score", torch.int32, (B,), dev)]
        self._call(self._lib.rtt_nw_sweep_t, dev, *ptrs, B, m_cap, n_cap, W,
                   match, mismatch, gap, span, variant)

    def pack_gather(self, qb, tb, db, meta, q4, t4, dcb, m_cap, n_cap):
        B = meta.shape[0]
        dev = self._device(meta, "meta")
        if not (m_cap % 8 == 0 and n_cap % 32 == 0 and m_cap > 0
                and n_cap > 0):
            raise ValueError("pack_gather: unsupported geometry")
        blobs = []
        for t, name in ((qb, "qblob"), (tb, "tblob"), (db, "dcblob")):
            if t.ndim != 1 or t.shape[0] >= 2 ** 31:
                raise ValueError(f"{name} must be 1-D, under 2^31 words")
            blobs += [self._check(t, name, torch.int32, t.shape, dev),
                      t.shape[0]]
        ptrs = [self._check(meta, "meta", torch.int32, (B, 4), dev),
                self._check(q4, "q4", torch.uint8, (B, m_cap // 2), dev),
                self._check(t4, "t4", torch.uint8, (B, n_cap // 2), dev),
                self._check(dcb, "dcb", torch.uint8, (B, n_cap // 8), dev)]
        self._call(self._lib.rtt_pack_gather, dev, *blobs, *ptrs, B, m_cap,
                   n_cap)

    def myers_moves(self, planes, m, moves, m_cap, n_cap, W):
        B = planes.shape[0]
        dev = self._device(planes, "planes")
        if not (W % 32 == 0 and W > 0 and m_cap % 16 == 0):
            raise ValueError("myers_moves: unsupported geometry")
        ptrs = [self._check(planes, "planes", torch.int32,
                            (B, m_cap, 2, W // 32), dev),
                self._check(m, "m", torch.int32, (B,), dev),
                self._check(moves, "moves", torch.int32,
                            (B, m_cap // 16, W), dev)]
        self._call(self._lib.rtt_myers_moves, dev, *ptrs, B, m_cap, n_cap,
                   W)

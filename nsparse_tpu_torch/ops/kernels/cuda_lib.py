"""Builds and loads the port's Hopper kernels (``csrc/*.cu``).

The kernels are compiled at first use with ``nvcc`` for ``sm_90a``, one
shared library with a plain C interface per source, all sources at once
(``buildlib.build_shared`` in parallel threads), and loaded with ctypes.
Nothing here runs at import time: the CPU tests import every module on a
machine without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import threading
import types
import typing
from concurrent.futures import ThreadPoolExecutor

import torch

from nsparse_tpu_torch.buildlib import PKG_DIR, build_shared
from nsparse_tpu_torch.utils import profiling

CSRC_DIR = os.path.join(PKG_DIR, "csrc")
SOURCES = ("gather.cu", "expand.cu", "fused_class.cu", "runcopy.cu",
           "gather_subset.cu", "scatter_tiles.cu", "spmv_dia.cu",
           "spmv_bsr.cu", "spgemm_bsr.cu", "windowed_gather.cu",
           "build_bank.cu", "gather_tiles8.cu", "spgemm_hash.cu")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_I32 = ctypes.c_int
_I64_ARRAY = ctypes.POINTER(_I64)  # a host array, read by the entry point
_SIGNATURES = {
    "nsp_gather": [_P, _I64, _P, _P, _I64, _P],
    "nsp_expand": [_P, _P, _P, _P, _P, _P, _I64, _P, _P],
    "nsp_expand_pieces": [_P, _P, _P, _P, _P, _I32, _I64, _I32, _P, _P],
    "nsp_fused_class": [_P, _P, _P, _P, _P, _I64, _I32, _I32, _I32, _P],
    "nsp_fused_class_v2": [
        _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I64, _I32, _I32, _I32,
        _I32, _I32, _P,
    ],
    "nsp_runcopy": [_P, _P, _P, _P, _I64, _P, _I64, _P],
    "nsp_gather_subset": [_P, _I64, _P, _P, _I64, _I64, _P, _I64, _P, _P],
    "nsp_scatter_tiles": [_P, _P, _I64, _P, _I64, _P],
    "nsp_spmv_dia": [_P, _I64, _P, _I32, _P, _I64, _P, _I64, _P],
    "nsp_spmv_bsr": [_P, _P, _P, _I64, _P, _I64, _P, _I64, _P],
    "nsp_spgemm_bsr": [_P, _P, _P, _P, _P, _I64, _I32, _P, _P],
    "nsp_windowed_gather": [_P, _I64, _P, _I32, _I64, _P, _I32, _P],
    "nsp_build_bank": [_P, _I64, _P, _I64, _I64, _I32, _I32, _P, _P],
    "nsp_gather_tiles8": [_P, _I64, _P, _I64, _P, _P],
    "nsp_runcopy_kfold": [_P, _P, _P, _P, _P, _P, _I64, _P, _I64, _P],
    "nsp_hash_bin": [_P, _P, _P, _P, _I32, _I64, _I64, _I64_ARRAY, _I32,
                     _I32, _P, _P, _P, _P, _P],
    "nsp_hash_scatter": [_P, _I64, _P, _I32, _P, _P],
    "nsp_hash_symbolic": [_I32, _I64, _I32, _P, _P, _P, _P, _P, _I64, _P,
                          _P, _P, _I64, _P, _P],
    "nsp_hash_numeric": [_I32, _I64, _I32, _P, _P, _P, _P, _P, _P, _P, _I64,
                         _P, _P, _P, _I64, _P, _P, _P, _P],
}
_F32_ONLY = {"nsp_runcopy_kfold"}  # K4's K-fold mode sums in float only
# entry points that take no values: one build, no dtype suffix
_INDEX_ONLY = {"nsp_hash_bin", "nsp_hash_scatter", "nsp_hash_symbolic"}


def nvcc() -> str:
    return shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"


class _KernelLib:
    """The loaded kernel library, built once per process."""

    def __init__(self):
        self._lock = threading.Lock()
        self._lib = None

    def get(self):
        with self._lock:
            if self._lib is None:
                self._lib = self._load()
            return self._lib

    @staticmethod
    def _load():
        """Every entry point of every source, as attributes of one
        namespace."""
        header = [os.path.join(CSRC_DIR, "common.cuh")]

        def build(src):
            return build_shared(
                f"libnsparse_{os.path.splitext(src)[0]}",
                [os.path.join(CSRC_DIR, src)], [nvcc(), *NVCC_FLAGS],
                timeout=900, deps=header,
            )

        with ThreadPoolExecutor(len(SOURCES)) as pool:
            libs = list(pool.map(build, SOURCES))
        types_of = {"nsp_error_string": ([ctypes.c_int], ctypes.c_char_p),
                    "nsp_fused_class_geom": (
                        [_I32, _I32, _I64, _I32, _I32, _I32,
                         ctypes.POINTER(_I32)], ctypes.c_int),
                    "nsp_hash_geom": (
                        [_I32, _I32, _I32, _I64, _I32,
                         ctypes.POINTER(_I32)], ctypes.c_int)}
        for name, argtypes in _SIGNATURES.items():
            for suffix in _suffixes(name):
                types_of[name + suffix] = (argtypes, ctypes.c_int)
        fns = {}
        for lib in libs:
            for name, (argtypes, restype) in types_of.items():
                if hasattr(lib, name):
                    fn = getattr(lib, name)
                    fn.argtypes, fn.restype = argtypes, restype
                    fns[name] = fn
        missing = sorted(set(types_of) - set(fns))
        if missing:
            raise RuntimeError(f"kernel entry points not built: {missing}")
        return types.SimpleNamespace(**fns)


KERNELS = _KernelLib()


def _suffixes(name: str) -> tuple:
    if name in _INDEX_ONLY:
        return ("",)
    return ("_f32",) if name in _F32_ONLY else ("_f32", "_f64")


_SUFFIX = {torch.float32: "_f32", torch.float64: "_f64"}


def check(rc: int, what: str) -> None:
    """Raise when a C entry point returned a CUDA error."""
    if rc != 0:
        msg = KERNELS.get().nsp_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")


# -- the launch path ---------------------------------------------------------
#
# What a launch costs the host beyond the C call itself (chip_smoke.py's
# launch-cost phase times each step): one validation pass over the
# arguments, a dict lookup of the entry point, the raw current stream, and
# a device switch only when the tensors lie on another card.

_RESOLVED = {}  # (name, dtype): the C entry point


def resolve(name: str, dtype: torch.dtype):
    """The C entry point ``name`` for values of ``dtype`` (None for the
    entry points that take no values), looked up in the kernel library
    once per (name, dtype)."""
    fn = _RESOLVED.get((name, dtype))
    if fn is None:
        suffix = "" if name in _INDEX_ONLY else _SUFFIX.get(dtype)
        if suffix is None:
            raise TypeError(f"{name}: values must be float32 or float64, "
                            f"got {dtype}")
        fn = _RESOLVED[name, dtype] = getattr(KERNELS.get(), name + suffix)
    return fn


class Scratch(typing.NamedTuple):
    """A kernel's own device buffer (counts, offsets) in any dtype: passed
    as its data pointer, checked for its device and layout as a tensor
    argument is, never for its dtype."""

    t: torch.Tensor


def validate(what: str, *args) -> tuple[int, torch.dtype | None, list]:
    """(device index, value dtype, ``args`` with each tensor replaced by
    its data pointer) for C arguments ``args``; the tensors among them
    must be contiguous on one CUDA device, indices int32 (or int16) and
    values of one float dtype, or this raises.  A ``Scratch`` buffer may
    hold any dtype."""
    device, dtype, one_device, c_args = None, None, True, []
    for t in args:
        if not isinstance(t, torch.Tensor):
            if type(t) is not Scratch:
                c_args.append(t)
                continue
            t, dt = t.t, torch.int32  # its dtype is not checked
        else:
            dt = t.dtype  # dtypes are singletons: compared by identity
        c_args.append(t.data_ptr())
        if not t.is_contiguous():
            raise ValueError(f"{what}: tensors must be contiguous")
        if dt is not torch.int32 and dt is not dtype and dt is not torch.int16:
            if not dt.is_floating_point:
                raise ValueError(f"{what}: index arrays must be int32 or "
                                 "int16")
            if dtype is not None:
                raise TypeError(f"{what}: values must share one dtype, got "
                                f"{dtype} and {dt}")
            dtype = dt
        index = t.get_device() if t.is_cuda else -1
        if device is None:
            device = index
        one_device = one_device and index == device
    if device is None:
        raise ValueError(f"{what}: no tensor to launch on")
    if device < 0 or not one_device:
        tensors = [a.t if type(a) is Scratch else a for a in args]
        devices = sorted({str(t.device) for t in tensors
                          if isinstance(t, torch.Tensor)})
        raise ValueError(f"{what}: all tensors must be on one CUDA device, "
                         f"got {devices}")
    return device, dtype, c_args


def _current_device() -> int:
    return torch._C._cuda_getDevice()


def _set_device(index: int) -> None:
    torch._C._cuda_setDevice(index)


def _raw_stream(index: int) -> int:
    """The handle of PyTorch's current stream on device ``index``."""
    return torch._C._cuda_getCurrentRawStream(index)


def launch(what: str, name: str, *args, _recorded: bool = False) -> None:
    """Call the C entry point ``name`` with ``args`` and PyTorch's current
    stream, on the device of the tensors in ``args``; each tensor is
    passed as its data pointer.  The tensors are checked (``validate``)
    before the kernel library is touched; a CUDA error raises.

    While the recorder is on (``utils.profiling``), the launch's host time
    adds to the span ``launch`` (in the aggregates only, never in the
    profiler's trace) and a launch that returned to the counter
    ``launch.<name>``."""
    if profiling.RECORDING and not _recorded:
        with profiling.span("launch", trace=False):
            launch(what, name, *args, _recorded=True)
        profiling.count("launch." + name)
        return
    device, dtype, c_args = validate(what, *args)
    fn = _RESOLVED.get((name, dtype)) or resolve(name, dtype)
    current = _current_device()
    if current == device:
        rc = fn(*c_args, _raw_stream(device))
    else:
        _set_device(device)
        try:
            rc = fn(*c_args, _raw_stream(device))
        finally:
            _set_device(current)
    if rc:
        check(rc, what)

"""Host planner and Matrix Market parser, loaded through ctypes.

Counterpart of ``nsparse_tpu/native/__init__.py``.  The C++ sources,
``planner.cpp`` and ``mmio.cpp`` in this directory, are byte-for-byte
copies of the JAX package's, so the port builds from its own files into
its build directory (the JAX package's ``shuffle.cpp``, the Benes router,
is not copied: the port routes no masks).  Everything has a numpy
fallback, used when the sources or ``g++`` are missing or when a caller
passes ``native=False``.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

from nsparse_tpu_torch.buildlib import build_shared

_SRC_DIR = os.path.dirname(os.path.abspath(__file__))
_SOURCES = ("planner.cpp", "mmio.cpp")


class _HostLib:
    """The loaded library, built once per process (``None`` when it
    cannot be built)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._lib = None
        self._tried = False

    def get(self):
        with self._lock:
            if not self._tried:
                self._tried = True
                self._lib = self._load()
            return self._lib

    @staticmethod
    def _load():
        srcs = [os.path.join(_SRC_DIR, s) for s in _SOURCES]
        if not all(os.path.exists(s) for s in srcs):
            return None
        try:
            lib = build_shared(
                "libnsparse_host", srcs,
                ["g++", "-O3", "-march=native", "-shared", "-fPIC",
                 "-std=c++17", "-pthread"],
                timeout=300,
            )
        except (OSError, subprocess.SubprocessError):
            return None
        i32 = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
        i64 = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
        lib.nsp_spgemm_plan.restype = ctypes.c_int64
        lib.nsp_spgemm_plan.argtypes = [
            i32, i32, ctypes.c_int64,   # rpt_a, col_a, m
            i32, i32,                   # rpt_b, col_b
            i32, i32, i32,              # apos, bpos, out_pos
            i32, i32, i64,              # c_rpt, c_col, prodoff scratch
            ctypes.c_int64,             # P
        ]
        lib.nsp_read_mtx.restype = ctypes.c_int64
        lib.nsp_read_mtx.argtypes = [
            ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int64),
        ]
        lib.nsp_fill_mtx.restype = ctypes.c_int
        lib.nsp_fill_mtx.argtypes = [
            i64, i64, np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS"),
        ]
        lib.nsp_free_mtx.restype = None
        lib.nsp_free_mtx.argtypes = []
        return lib


HOST_LIB = _HostLib()


def spgemm_plan_host(rpt_a, col_a, deg_a, rpt_b, col_b, deg_b, m, n, nnz_a):
    """Host SpGEMM symbolic phase: expansion + per-row column sort + dedup.

    Returns (apos, bpos, out_pos, c_rpt, c_col, p_total, c_nnz), the first
    five as exactly sized int32 arrays — the JAX package's
    ``spgemm_plan_host``, output for output.  Runs the C++ planner, or
    :func:`spgemm_plan_host_numpy` when the library is missing or fails.
    """
    args = (rpt_a, col_a, deg_a, rpt_b, col_b, deg_b, m, n, nnz_a)
    return spgemm_plan_host_native(*args) or spgemm_plan_host_numpy(*args)


def spgemm_plan_host_native(rpt_a, col_a, deg_a, rpt_b, col_b, deg_b, m, n,
                            nnz_a):
    """The C++ planner's outputs (as :func:`spgemm_plan_host`), or None
    when the library is missing or the planner fails."""
    lib = HOST_LIB.get()
    if lib is None:
        return None
    rpt_a = np.ascontiguousarray(rpt_a, dtype=np.int32)
    rpt_b = np.ascontiguousarray(rpt_b, dtype=np.int32)
    col_a32 = np.ascontiguousarray(col_a[:nnz_a], dtype=np.int32)
    col_b32 = np.ascontiguousarray(col_b, dtype=np.int32)
    p_total = int(np.asarray(deg_b)[col_a32].sum())
    apos = np.empty(max(p_total, 1), dtype=np.int32)
    bpos = np.empty(max(p_total, 1), dtype=np.int32)
    out_pos = np.empty(max(p_total, 1), dtype=np.int32)
    c_rpt = np.empty(m + 1, dtype=np.int32)
    c_col = np.empty(max(p_total, 1), dtype=np.int32)
    prodoff = np.empty(m + 1, dtype=np.int64)
    c_nnz = lib.nsp_spgemm_plan(
        rpt_a, col_a32, m, rpt_b, col_b32,
        apos, bpos, out_pos, c_rpt, c_col, prodoff, p_total,
    )
    if c_nnz < 0:
        return None
    return (
        apos[:p_total], bpos[:p_total], out_pos[:p_total],
        c_rpt, c_col[:c_nnz], p_total, int(c_nnz),
    )


def spgemm_plan_host_numpy(rpt_a, col_a, deg_a, rpt_b, col_b, deg_b, m, n,
                           nnz_a):
    """numpy form of :func:`spgemm_plan_host` (same outputs): one global
    stable argsort on a packed (row, col) key."""
    rpt_b = np.asarray(rpt_b, dtype=np.int32)
    col_a32 = np.asarray(col_a[:nnz_a], dtype=np.int32)
    col_b32 = np.asarray(col_b, dtype=np.int32)
    cnt = np.asarray(deg_b)[col_a32]
    p_total = int(cnt.sum())
    off = np.zeros(nnz_a + 1, dtype=np.int64)
    np.cumsum(cnt, out=off[1:])
    k = np.repeat(np.arange(nnz_a, dtype=np.int64), cnt)
    t_in = np.arange(p_total, dtype=np.int64) - off[k]
    row = np.repeat(np.repeat(np.arange(m, dtype=np.int64), deg_a[:m]), cnt)
    bpos = rpt_b[col_a32[k]].astype(np.int64) + t_in
    ccol = col_b32[bpos].astype(np.int64)
    key = row * int(n) + ccol
    order = np.argsort(key, kind="stable")
    ks = key[order]
    new = np.empty(p_total, dtype=bool)
    if p_total:
        new[0] = True
        np.not_equal(ks[1:], ks[:-1], out=new[1:])
    out_pos = (np.cumsum(new) - 1).astype(np.int32)
    c_nnz = int(out_pos[-1]) + 1 if p_total else 0
    c_col = ccol[order][new].astype(np.int32)
    c_counts = np.bincount(row[order][new], minlength=m)
    c_rpt = np.zeros(m + 1, dtype=np.int32)
    np.cumsum(c_counts, out=c_rpt[1:])
    return (
        k[order].astype(np.int32), bpos[order].astype(np.int32), out_pos,
        c_rpt, c_col, p_total, c_nnz,
    )


def read_mtx_native(path: str):
    """Native .mtx parse: (rows, cols, vals, (m, n)), or None when the
    library is missing or the parse fails."""
    lib = HOST_LIB.get()
    if lib is None:
        return None
    m, n, nnz = ctypes.c_int64(), ctypes.c_int64(), ctypes.c_int64()
    rc = lib.nsp_read_mtx(
        path.encode(), ctypes.byref(m), ctypes.byref(n), ctypes.byref(nnz)
    )
    if rc < 0:
        return None
    rows = np.empty(nnz.value, dtype=np.int64)
    cols = np.empty(nnz.value, dtype=np.int64)
    vals = np.empty(nnz.value, dtype=np.float64)
    if nnz.value:
        lib.nsp_fill_mtx(rows, cols, vals)
    lib.nsp_free_mtx()
    return rows, cols, vals, (m.value, n.value)

"""One-shot SpGEMM by per-row hash accumulation (``csrc/spgemm_hash.cu``).

Replaces no TPU kernel: the JAX package forms C = A @ B in one shot by
expanding every product, one global sort and a segmented scan
(``spgemm_plan_device`` and ``spgemm_numeric_sort``), because the TPU has
no scatter atomics.  On the card each row of C is accumulated in a table
in shared memory, in the reference's two phases: a symbolic phase counts
each row's distinct columns, a scan gives C's row pointers, and a
numeric phase accumulates (column, value) pairs, sorts them by column
and writes C.  Rows are binned by their size (the symbolic phase: the
row's products, capped at N; the numeric phase: its nnz) into routes:

- ``pwarp``: 8 lanes a row, a 64-slot table (size <= 32);
- ``warp``: a warp a row, 1,024 slots (size <= 512);
- ``dense``: a block a row with a dense accumulator in shared memory:
  an occupancy bitmap of a slice of N columns (and, numeric, their
  values), sized so two blocks share an SM, one pass over the row's
  products per slice; it needs no probing and no sort (the bitmap gives
  the columns in order).  To ``DENSE_PASSES`` passes (numeric 32,
  symbolic 12) it takes every row past the warp route;
- past that, ``block<T>``, a block a row, a table of T slots in shared
  memory (size <= T / 2), T = 2048, 4096, ... while it fits the 227 KB a
  block may opt in to, and past the largest, the dense route to
  ``TABLE_PASSES`` passes (numeric 320; symbolic none), then ``global``,
  a block a row with its table in device memory (twice the row's size,
  rounded up to a power of two).

The symbolic phase keeps keys only (4 bytes a slot), the numeric phase
keys and values, so an f64 table holds fewer slots.  The numeric tables
sort their slots by a bitonic network; the dense route's bitmap gives
the columns in order.  Sums follow the order of the shared-memory
atomics, so C's values are not bitwise repeatable from run to run.

Two host reads a call: the symbolic histogram (``sync.hash_bins``), and
nnz(C) with the numeric histogram (``sync.c_nnz``).  There is no plain
version here: on the CPU ``spgemm`` takes the device planner's path
(``spgemm_numeric_sort(spgemm_plan_device(a, b), a, b)``), which computes
the same C.
"""

from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from nsparse_tpu_torch.formats.csr import CSR
from nsparse_tpu_torch.ops.kernels import cuda_lib
from nsparse_tpu_torch.ops.spgemm import LANES, _round_up
from nsparse_tpu_torch.utils import profiling
from nsparse_tpu_torch.utils.profiling import host_read, span

SMEM_MAX = 232448  # the 227 KB of shared memory a block may opt in to
SMEM_SM = 233472  # an SM's 228 KB; each block resident on it holds 1 KB
SCRATCH_BYTES = 64 * 4  # a block route's reductions and scans
MAX_BINS = 16  # the info layout of csrc/spgemm_hash.cu
INFO_GLOBAL, INFO_NNZ = MAX_BINS, MAX_BINS + 1
INFO_LEN = 2 * MAX_BINS + 2  # histogram, device-table slots, nnz, cursors
PHASES = ("symbolic", "numeric")
# route kinds, as the C entry points read them
PWARP, WARP, BLOCK, DENSE, GLOBAL = range(5)
PWARP_LANES, PWARP_SLOTS, PWARP_THREADS = 8, 64, 256
WARP_SLOTS, WARP_THREADS = 1024, 128
TAIL_THREADS = 1024
# The dense route's most passes by phase (hash_routes), at the crossovers
# measured on an H100 (tools/hash_variants.py; PERF.md): alone past the
# warp route, and behind the hash blocks
DENSE_PASSES = {"symbolic": 12, "numeric": 32}
TABLE_PASSES = {"symbolic": 12, "numeric": 320}


@dataclasses.dataclass(frozen=True)
class Route:
    """One bin of rows: ``limit`` is the largest size it takes (None for
    the tail, which takes the rest); ``slots`` its table (``dense``: the
    columns of a pass; ``global``: 0, sized per row); ``smem`` its
    dynamic shared memory a block."""

    name: str
    kind: int
    limit: int | None
    slots: int
    threads: int
    smem: int


def hash_routes(phase: str, n_cols: int, val_bytes: int) -> tuple:
    """The routes of ``phase`` for C of ``n_cols`` columns and values of
    ``val_bytes`` bytes, smallest first, the tail last: past the warp
    route, the dense route alone while it takes at most
    ``DENSE_PASSES[phase]`` passes; else the hash blocks, then the dense
    route while it takes at most ``TABLE_PASSES[phase]``, past that tables
    in device memory."""
    if phase not in PHASES:
        raise ValueError(f"unknown phase {phase!r}")
    vb = 0 if phase == "symbolic" else val_bytes
    slot = 4 + vb
    routes = [
        Route("pwarp", PWARP, 32, PWARP_SLOTS, PWARP_THREADS,
              PWARP_THREADS // PWARP_LANES * PWARP_SLOTS * slot),
        Route("warp", WARP, 512, WARP_SLOTS, WARP_THREADS,
              WARP_THREADS // 32 * WARP_SLOTS * slot),
    ]
    dense = dense_route(n_cols, vb)
    passes = -(-n_cols // dense.slots)
    if passes <= DENSE_PASSES[phase]:
        return (*routes, dense)
    routes += block_routes(vb)
    routes.append(dense if passes <= TABLE_PASSES[phase] else
                  Route("global", GLOBAL, None, 0, TAIL_THREADS,
                        SCRATCH_BYTES))
    return tuple(routes)


def block_routes(val_bytes: int) -> list:
    """The hash blocks: ``block<T>``, a table of T slots (keys, and values
    of ``val_bytes``), T = 2048, 4096, ... while it fits the 227 KB a
    block may opt in to; each takes rows of at most T / 2."""
    slot = 4 + val_bytes
    out, t = [], 2048
    while t * slot + SCRATCH_BYTES <= SMEM_MAX:
        out.append(Route(f"block{t}", BLOCK, t // 2, t,
                         min(TAIL_THREADS, t // 4),
                         t * slot + SCRATCH_BYTES))
        t *= 2
    return out


def dense_route(n_cols: int, val_bytes: int, passes: int | None = None):
    """The dense route: N split evenly into ``passes`` slices (multiples
    of 32), by default the fewest whose values (``val_bytes`` each, 0 in
    the symbolic phase) and bitmap let two blocks of 1,024 threads share
    an SM (its 2,048 threads).  On a Graph500 scale-15 product two blocks
    an SM and a second pass over the products beat one block and one pass
    (9.7 against 11.9 ms in f32; f64 11.6 in three passes against 15.2 in
    two)."""
    if passes is None:
        per_block = SMEM_SM // 2 - 1024
        fit = (per_block - SCRATCH_BYTES) * 8 // (8 * val_bytes + 1) \
            // 32 * 32
        passes = max(1, -(-n_cols // fit))
    per_pass = -(-n_cols // passes)
    slice_ = -(-per_pass // 32) * 32
    return Route("dense", DENSE, None, slice_, TAIL_THREADS,
                 slice_ * val_bytes + slice_ // 8 + SCRATCH_BYTES)


def route_of(sizes, routes) -> np.ndarray:
    """Each row's bin (an index into ``routes``; -1 for size 0), as the
    binning kernel assigns it: the first route whose limit is at least the
    size, else the tail."""
    sizes = np.asarray(sizes, dtype=np.int64)
    edges = np.array([r.limit for r in routes[:-1]], dtype=np.int64)
    return np.where(sizes > 0, np.searchsorted(edges, sizes, side="left"),
                    -1)


def _histogram(info: list, routes) -> tuple:
    """(rows per route, their offsets in ``perm``) from the read."""
    counts = [int(c) for c in info[: len(routes)]]
    return counts, np.concatenate([[0], np.cumsum(counts)]).tolist()


def _count_routes(phase: str, routes, counts) -> None:
    """The engagement counters, from the histogram already read: rows by
    route, and the rows whose table lay in device memory (0 included)."""
    for r, c in zip(routes, counts):
        profiling.count(f"spgemm_hash.rows.{phase}.{r.name}", c)
    profiling.count("spgemm_hash.global_rows",
                    counts[-1] if routes[-1].kind == GLOBAL else 0)


def _bin(phase, routes, a, b, row_nnz, size, bins, goff, info, perm):
    """Bin the rows of ``phase`` (the binning kernel, then the scatter)
    by the limits of ``routes``."""
    m, n = a.shape[0], b.shape[1]
    edges = [r.limit for r in routes[:-1]]
    _launch("nsp_hash_bin", a.rpt, a.col, b.rpt, row_nnz,
            PHASES.index(phase), m, n, (ctypes.c_int64 * len(edges))(*edges),
            len(edges), int(routes[-1].kind == GLOBAL), size, bins, goff,
            info)
    _launch("nsp_hash_scatter", bins, m, info, len(routes), perm)


def _launch(name, *args):
    cuda_lib.launch("spgemm_hash", name, *args)


def route_geometry(phase: str, route: Route, val_bytes: int) -> dict:
    """How ``route``'s kernel of ``phase`` runs on the current card
    (built library needed): ``blocks_per_sm`` resident at once,
    ``registers`` and ``spill_bytes`` a thread, ``smem`` bytes a block."""
    got = (ctypes.c_int * 4)()
    rc = cuda_lib.KERNELS.get().nsp_hash_geom(
        PHASES.index(phase), route.kind, val_bytes, route.slots,
        route.threads, got)
    cuda_lib.check(rc, f"spgemm_hash geometry ({phase} {route.name})")
    return dict(blocks_per_sm=got[0], registers=got[1], spill_bytes=got[2],
                smem=got[3])


def spgemm_hash(a, b):
    """C = A @ B for CSR ``a`` and ``b`` on one CUDA card, through the
    hash routes: a CSR with int32 ``rpt`` (M + 1), ``col`` and ``val``
    padded with zeros to nnz(C) rounded up to 128, as a plan's numeric
    phase gives it.  Products and sums stay in the values' dtype.  The
    inputs are checked before anything is launched (CUDA tensors on one
    card, int32 indices, one float dtype); raises ValueError where nnz(C)
    would overflow int32 row pointers."""
    if a.shape[1] != b.shape[0]:
        raise ValueError(f"shape mismatch {a.shape} @ {b.shape}")
    cuda_lib.validate("spgemm_hash", a.rpt, a.col, a.val, b.rpt, b.col,
                      b.val)
    if a.val.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"spgemm_hash: values must be float32 or float64, "
                        f"got {a.val.dtype}")
    m, n = a.shape[0], b.shape[1]
    dev, dtype = a.val.device, a.val.dtype
    vb = a.val.element_size()
    with span("spgemm.hash.bin"):
        routes = hash_routes("symbolic", n, vb)
        info = torch.zeros(2, INFO_LEN, dtype=torch.int64, device=dev)
        rows = torch.empty(4, m, dtype=torch.int32, device=dev)
        size, bins, perm, row_nnz = rows
        goff = cuda_lib.Scratch(torch.empty(m, dtype=torch.int64,
                                            device=dev))
        _bin("symbolic", routes, a, b, row_nnz, size, bins, goff,
             cuda_lib.Scratch(info[0]), perm)
        read = host_read(info[0, : INFO_GLOBAL + 1], "hash_bins")
    counts, starts = _histogram(read, routes)
    if profiling.RECORDING:
        _count_routes("symbolic", routes, counts)
    with span("spgemm.hash.symbolic"):
        gkeys = torch.empty(max(read[INFO_GLOBAL], 1), dtype=torch.int32,
                            device=dev)
        for k, r in enumerate(routes):
            if counts[k]:
                _launch("nsp_hash_symbolic", r.kind, r.slots, r.threads,
                        a.rpt, a.col, b.rpt, b.col,
                        perm[starts[k]: starts[k + 1]], counts[k], size,
                        goff, gkeys, n, row_nnz)
        del gkeys
        routes = hash_routes("numeric", n, vb)
        _bin("numeric", routes, a, b, row_nnz, size, bins, goff,
             cuda_lib.Scratch(info[1]), perm)
        c_rpt = torch.zeros(m + 1, dtype=torch.int32, device=dev)
        torch.cumsum(row_nnz, 0, dtype=torch.int32, out=c_rpt[1:])
        read = host_read(info[1, : INFO_NNZ + 1], "c_nnz")
    nnz = read[INFO_NNZ]
    if nnz >= 2**31:
        raise ValueError(f"nnz(C) = {nnz} overflows int32 row pointers")
    counts, starts = _histogram(read, routes)
    if profiling.RECORDING:
        _count_routes("numeric", routes, counts)
    with span("spgemm.hash.numeric"):
        cap = _round_up(nnz, LANES)
        c_col = torch.empty(cap, dtype=torch.int32, device=dev)
        c_val = torch.empty(cap, dtype=dtype, device=dev)
        if cap > nnz:
            c_col[nnz:].zero_()
            c_val[nnz:].zero_()
        n_global = max(read[INFO_GLOBAL], 1)
        gkeys = torch.empty(n_global, dtype=torch.int32, device=dev)
        gvals = torch.empty(n_global, dtype=dtype, device=dev)
        for k, r in enumerate(routes):
            if counts[k]:
                _launch("nsp_hash_numeric", r.kind, r.slots, r.threads,
                        a.rpt, a.col, a.val, b.rpt, b.col, b.val,
                        perm[starts[k]: starts[k + 1]], counts[k], goff,
                        gkeys, gvals, n, c_rpt, c_col, c_val)
    return CSR(rpt=c_rpt, col=c_col, val=c_val, shape=(m, n), nnz=nnz)

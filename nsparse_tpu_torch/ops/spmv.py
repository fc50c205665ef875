"""Sparse matrix-vector product y = A @ x (counterpart of
``nsparse_tpu/ops/spmv.py``).

- ``spmv_csr``: gather x[col], combine, reduce by row — the semantic
  contract and the path of every semiring on CSR.
- ``spmv_ell``: per width-binned slab ``sum_w val[w, :] * x[col[w, :]]``;
  ``plus_times`` on the card in float32 or float64 is K14 (two launches:
  the slabs, then the rows); elsewhere planned gathers (``flat_gather``:
  K5, K1, K6), or the x-shuffle plans when the ELL carries them, and the
  output permutation as one more planned gather.
- ``spmv_dia``: one pass over the diagonals (K7).
- ``spmv_bsr``: dense tiles; (128, 128) tiles go through K8.

The semiring paths and the segment reductions that the JAX package
leaves to XLA are plain PyTorch here.  Dispatch by format in ``spmv``.
"""

from __future__ import annotations

import torch

from nsparse_tpu_torch.formats.bsr import BSR
from nsparse_tpu_torch.formats.coo import COO
from nsparse_tpu_torch.formats.csr import CSR
from nsparse_tpu_torch.formats.dia import DIA
from nsparse_tpu_torch.formats.ell import ELL
from nsparse_tpu_torch.ops.kernels import dia as dia_kernel
from nsparse_tpu_torch.ops.kernels import spmv_bsr as bsr_kernel
from nsparse_tpu_torch.ops.kernels import spmv_ell as ell_kernel
from nsparse_tpu_torch.ops.kernels.flat_gather import flat_gather
from nsparse_tpu_torch.ops.kernels.shuffle import planned_shuffle
from nsparse_tpu_torch.utils.device import highest_matmul_precision
from nsparse_tpu_torch.utils.profiling import span

_INF = float("inf")

# (scatter_reduce name, combine, identity, elementwise reduce) per
# semiring; the identity fills padded slots and empty rows
SEMIRINGS = {
    "plus_times": ("sum", torch.mul, 0.0, torch.add),
    "min_plus": ("amin", torch.add, _INF, torch.minimum),
    "max_plus": ("amax", torch.add, -_INF, torch.maximum),
    "max_times": ("amax", torch.mul, -_INF, torch.maximum),
}


def _segment_reduce(vals: torch.Tensor, seg: torch.Tensor, n_seg: int,
                    semiring: str) -> torch.Tensor:
    """Reduce ``vals`` (first axis) by segment id ``seg`` into ``n_seg``
    segments; empty segments hold the semiring's identity."""
    red, _, ident, _ = SEMIRINGS[semiring]
    out = torch.full((n_seg, *vals.shape[1:]), ident, dtype=vals.dtype,
                     device=vals.device)
    if red == "sum":
        return out.index_add_(0, seg, vals)
    idx = seg.reshape(-1, *([1] * (vals.dim() - 1))).expand_as(vals)
    return out.scatter_reduce_(0, idx, vals, red, include_self=True)


def _row_ids(a: CSR) -> torch.Tensor:
    m = a.shape[0]
    return torch.repeat_interleave(
        torch.arange(m, device=a.rpt.device), a.rpt.diff(),
        output_size=a.nnz)


def spmv_csr(a: CSR, x: torch.Tensor,
             semiring: str = "plus_times") -> torch.Tensor:
    """y = A (.) x for CSR over a semiring: ``plus_times`` is SpMV,
    ``min_plus`` a shortest-path relaxation, ``max_times`` Viterbi."""
    _, combine, _, _ = SEMIRINGS[semiring]
    nnz = a.nnz
    prod = combine(a.val[:nnz], x[a.col[:nnz].long()])
    return _segment_reduce(prod, _row_ids(a), a.shape[0], semiring)


def _apply_row_splits(a: ELL, y: torch.Tensor, y_all: torch.Tensor,
                      semiring: str) -> torch.Tensor:
    """Fold the extra chunk partials of split rows into y."""
    if a.split_rows is None:
        return y
    _, _, ident, reduce_e = SEMIRINGS[semiring]
    slots = a.split_slots.long()
    part = torch.where(slots >= 0, y_all[slots.clamp(min=0)], ident)
    rows = a.split_rows.long()
    if semiring == "plus_times":
        return y.index_add_(0, rows, part.sum(dim=1))
    red = part[:, 0]
    for c in range(1, slots.shape[1]):
        red = reduce_e(red, part[:, c])
    y[rows] = reduce_e(y[rows], red)
    return y


def spmv_ell(a: ELL, x: torch.Tensor,
             semiring: str = "plus_times") -> torch.Tensor:
    """y = A (.) x for width-binned ELL slabs over a semiring.

    ``plus_times`` with the slabs on the card in float32 or float64 is
    K14 (``ops.kernels.spmv_ell``), whether or not the ELL carries
    x-shuffle plans.  Elsewhere ``plus_times`` reads x through the
    planned gathers: the x-shuffle plans when the ELL has them (a gather
    of the used columns and a fill in column-sorted order, both
    ``flat_gather``, then a permutation to slab order, K1), else one
    ``flat_gather`` per slab fused with the multiply by the slab's
    values.  Other semirings mask padded slots with the identity through
    the row lengths and gather x directly.

    Stages are spans (``utils.profiling``): ``spmv.gather_x`` (the
    x-shuffle plans), ``spmv.slabs`` (each slab's products and sums; K14's
    first launch) and ``spmv.rows`` (the slab outputs to rows, split rows
    folded in; K14's second launch).
    """
    if semiring == "plus_times" and a.vals[0].is_cuda \
            and a.dtype in (torch.float32, torch.float64):
        return ell_kernel.spmv_ell(a, x)
    if semiring != "plus_times":
        _, combine, ident, reduce_e = SEMIRINGS[semiring]
        outs = []
        with span("spmv.slabs"):
            for val, col, ln in zip(a.vals, a.cols, a.lens):
                w = val.shape[0]
                g = combine(val, x[col.long()])
                valid = (torch.arange(w, device=ln.device)[:, None]
                         < ln[None, :])
                g = torch.where(valid, g, ident)
                acc = g[0]
                for wi in range(1, w):
                    acc = reduce_e(acc, g[wi])
                outs.append(acc)
        with span("spmv.rows"):
            y_all = torch.cat(outs)
            return _apply_row_splits(a, y_all[a.pos.long()], y_all,
                                     semiring)

    outs = []
    if a.xsh is not None:
        with span("spmv.gather_x"):
            xg = planned_shuffle(
                a.xsh,
                flat_gather(a.xfill_gp, flat_gather(a.uniq_cols_gp, x)))
        with span("spmv.slabs"):
            off = 0
            for val in a.vals:
                sl = xg[off: off + val.numel()].reshape(val.shape)
                outs.append((val * sl).sum(dim=0))
                off += val.numel()
    else:
        with span("spmv.slabs"):
            for val, gp in zip(a.vals, a.cols_gp):
                g = flat_gather(gp, x, other=val.reshape(-1))
                outs.append(g.reshape(val.shape).sum(dim=0))
    with span("spmv.rows"):
        y_all = torch.cat(outs)
        return _apply_row_splits(a, flat_gather(a.pos_gp, y_all), y_all,
                                 semiring)


def spmv_coo(a: COO, x: torch.Tensor) -> torch.Tensor:
    """y = A @ x for COO (rows in any order)."""
    nnz = a.nnz
    prod = a.val[:nnz] * x[a.col[:nnz].long()]
    return _segment_reduce(prod, a.row[:nnz].long(), a.shape[0],
                           "plus_times")


def spmm_csr(a: CSR, x: torch.Tensor) -> torch.Tensor:
    """Y = A @ X for a dense (N, K) right-hand side."""
    nnz = a.nnz
    prod = a.val[:nnz, None] * x[a.col[:nnz].long()]
    return _segment_reduce(prod, _row_ids(a), a.shape[0], "plus_times")


def spmm_bsr(a: BSR, x: torch.Tensor) -> torch.Tensor:
    """Y = A @ X over dense tiles: (br, bc) @ (bc, K) products in full
    precision (TF32 and other reduced float32 matmul modes are off for
    the einsum whatever the caller set, as JAX's ``Precision.HIGHEST``),
    then a sum per block row."""
    br, bc = a.blocksize
    n = a.shape[1]
    k = x.shape[1]
    nbc = (n + bc - 1) // bc
    xp = torch.nn.functional.pad(x.to(a.dtype), (0, 0, 0, nbc * bc - n))
    xg = xp.reshape(nbc, bc, k)[a.block_col.long()]
    with highest_matmul_precision():
        yb = torch.einsum("krc,kcj->krj", a.data, xg)
    y = torch.zeros(a.n_block_rows, br, k, dtype=a.dtype, device=x.device)
    y.index_add_(0, a.block_row.long(), yb)
    return y.reshape(-1, k)[: a.shape[0]]


def spmm(a, x: torch.Tensor) -> torch.Tensor:
    """Multi-vector product Y = A @ X (dense X of shape (N, K))."""
    if isinstance(a, BSR):
        return spmm_bsr(a, x)
    if isinstance(a, CSR):
        return spmm_csr(a, x)
    raise TypeError(f"spmm supports CSR/BSR, got {type(a)}")


def spmv_dia(a: DIA, x: torch.Tensor,
             semiring: str = "plus_times") -> torch.Tensor:
    """y = A (.) x for DIA.  ``plus_times`` is K7; other semirings treat
    the stored diagonals as the pattern (in-band explicit zeros are
    entries) and give the identity where no diagonal is in range."""
    m, n = a.shape
    if semiring == "plus_times":
        return dia_kernel.spmv_dia(a.vals, a.offsets, x, m, a.off_t)
    _, combine, ident, reduce_e = SEMIRINGS[semiring]
    mp = a.vals.shape[1]
    lo = min(0, min(a.offsets, default=0))
    hi = max(0, max(a.offsets, default=0))
    xp = torch.nn.functional.pad(
        x, (-lo, hi + max(mp - m, 0) + max(m - n, 0)))
    i = torch.arange(mp, device=x.device)
    y = torch.full((mp,), ident, dtype=a.dtype, device=x.device)
    for d, off in enumerate(a.offsets):
        t = combine(a.vals[d], xp[off - lo: off - lo + mp])
        inb = (i + off >= 0) & (i + off < n) & (i < m)
        y = reduce_e(y, torch.where(inb, t, ident))
    return y[:m]


def spmv_bsr(a: BSR, x: torch.Tensor) -> torch.Tensor:
    """y = A @ x for BSR of any blocksize, in plain PyTorch (the JAX
    package's XLA path)."""
    return bsr_kernel.spmv_bsr_plain(a, x)


def spmv(a, x: torch.Tensor, semiring: str = "plus_times") -> torch.Tensor:
    """Format-dispatched SpMV; x is cast to the matrix's dtype.

    ``semiring`` applies to CSR, ELL and DIA; BSR and COO take
    ``plus_times`` only.  A BSR with (128, 128) tiles goes through K8.
    """
    with span("spmv"):
        x = x.to(a.dtype)
        if isinstance(a, CSR):
            return spmv_csr(a, x, semiring=semiring)
        if isinstance(a, COO):
            if semiring != "plus_times":
                raise NotImplementedError(
                    "COO SpMV supports plus_times only")
            return spmv_coo(a, x)
        if isinstance(a, DIA):
            return spmv_dia(a, x, semiring=semiring)
        if isinstance(a, ELL):
            return spmv_ell(a, x, semiring=semiring)
        if isinstance(a, BSR):
            if semiring != "plus_times":
                raise NotImplementedError(
                    "BSR SpMV supports plus_times only")
            if a.blocksize == (bsr_kernel.PB, bsr_kernel.PB):
                return bsr_kernel.spmv_bsr(a, x)
            return spmv_bsr(a, x)
        raise TypeError(f"unsupported format {type(a)}")

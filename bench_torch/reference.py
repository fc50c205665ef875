"""The plain reference and the comparisons that decide ``correct``.

Plain PyTorch on the benchmark's own CSR (``Csr``): nothing here imports
the program or reads what it made.  The SpGEMM reference expands every
product of a block of A's rows, sums the products of each (row, column)
key in float64, and returns C as sorted keys, values and |A||B| (the
scale an entry's rounding is measured against).  The SpMV reference sums
(or, for min-plus, takes the least of) each row's terms in float64.

The control is the same reference one precision below the configuration's
float32: its inputs rounded to TF32 (10 mantissa bits, as the tensor cores
read float32 with TF32 on), products and sums in float32.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

PRODUCT_BLOCK = 1 << 25  # products per block of rows of the SpGEMM reference
TINY = 1e-30
PRECISIONS = ("float64", "tf32")


@dataclasses.dataclass(frozen=True)
class Csr:
    """The benchmark's CSR: int32 ``rpt`` (M+1) and ``col`` (nnz), values
    ``val`` (nnz), canonical (columns sorted within rows, no duplicates)."""

    rpt: torch.Tensor
    col: torch.Tensor
    val: torch.Tensor
    shape: tuple

    @property
    def nnz(self) -> int:
        return int(self.col.numel())


def tf32(t: torch.Tensor) -> torch.Tensor:
    """float32 values rounded to TF32's 10 mantissa bits (to nearest, ties
    away from zero); infinities and NaNs kept."""
    t = t.float().contiguous()
    r = ((t.view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)
    return torch.where(torch.isfinite(t), r, t)


def _cast(t: torch.Tensor, precision: str) -> torch.Tensor:
    if precision not in PRECISIONS:
        raise ValueError(f"unknown precision {precision!r}")
    return t.double() if precision == "float64" else tf32(t)


def row_ids(rpt: torch.Tensor, r0: int = 0, r1: int | None = None
            ) -> torch.Tensor:
    """The row of each entry of rows r0..r1."""
    rpt = rpt.long()
    r1 = rpt.numel() - 1 if r1 is None else r1
    return torch.repeat_interleave(
        torch.arange(r0, r1, device=rpt.device), rpt[r0: r1 + 1].diff())


def _row_blocks(a: Csr, b: Csr, budget: int):
    """Contiguous blocks of A's rows with at most ``budget`` products each
    (a row with more takes a block of its own)."""
    deg_b = b.rpt.long().diff()
    per_entry = deg_b[a.col.long()]
    cum = torch.cat([per_entry.new_zeros(1), per_entry.cumsum(0)])
    row_cum = cum[a.rpt.long()].cpu().numpy()  # products before each row
    m, r0 = a.shape[0], 0
    while r0 < m:
        r1 = int(np.searchsorted(row_cum, row_cum[r0] + budget, "right")) - 1
        r1 = min(max(r1, r0 + 1), m)
        yield r0, r1
        r0 = r1


def _products(a: Csr, b: Csr, r0: int, r1: int):
    """Every product of A's rows r0..r1 with B: its key row * N + column,
    its A value and its B value, in no particular order."""
    rpt_a, rpt_b = a.rpt.long(), b.rpt.long()
    s, e = int(rpt_a[r0]), int(rpt_a[r1])
    ac = a.col[s:e].long()
    cnt = rpt_b[ac + 1] - rpt_b[ac]
    p = int(cnt.sum())
    k = torch.repeat_interleave(torch.arange(e - s, device=ac.device), cnt,
                                output_size=p)
    within = torch.arange(p, device=ac.device) - (cnt.cumsum(0) - cnt)[k]
    bpos = rpt_b[ac][k] + within
    rows = row_ids(a.rpt, r0, r1)[k]
    key = rows * b.shape[1] + b.col.long()[bpos]
    return key, a.val[s:e][k], b.val[bpos]


def spgemm_ref(a: Csr, b: Csr, precision: str = "float64",
               budget: int = PRODUCT_BLOCK):
    """C = A @ B as (sorted keys row * N + column, values, |A||B|), block
    of rows by block of rows.  ``precision``: "float64", or "tf32" for
    the control (its |A||B| is of no use)."""
    keys, vals, scales = [], [], []
    for r0, r1 in _row_blocks(a, b, budget):
        key, av, bv = _products(a, b, r0, r1)
        prod = _cast(av, precision) * _cast(bv, precision)
        ukey, inv = torch.unique(key, sorted=True, return_inverse=True)
        keys.append(ukey)
        vals.append(torch.zeros(ukey.numel(), dtype=prod.dtype,
                                device=prod.device).index_add_(0, inv, prod))
        scales.append(torch.zeros_like(vals[-1]).index_add_(
            0, inv, prod.abs()))
        del key, av, bv, prod, inv
    return torch.cat(keys), torch.cat(vals), torch.cat(scales)


def spgemm_symbolic(a: Csr, b: Csr, budget: int = PRODUCT_BLOCK
                    ) -> tuple[int, int]:
    """(intermediate products P, nnz(C)) of C = A @ B."""
    p = nnz = 0
    for r0, r1 in _row_blocks(a, b, budget):
        key, _, _ = _products(a, b, r0, r1)
        p += key.numel()
        nnz += int(torch.unique(key).numel())
    return p, nnz


def spgemm_gaps(a: Csr, b: Csr, c_rpt, c_col, c_val, c_nnz: int
                ) -> dict[str, float]:
    """How far C (``c_rpt``, ``c_col``, ``c_val``, its first ``c_nnz``
    entries) lies from the reference: ``c_struct``, the entries that break
    the CSR contract (row pointers, canonical order, column range) or lie
    on only one side; ``c_val_gap``, the widest gap of a shared entry's
    value from the reference's, over its |A||B|."""
    m, n = a.shape[0], b.shape[1]
    ref_key, ref_val, ref_scale = spgemm_ref(a, b)
    rpt = c_rpt.long()
    if (rpt.numel() != m + 1 or int(rpt[0]) != 0 or int(rpt[-1]) != c_nnz
            or bool((rpt.diff() < 0).any())):
        return {"c_struct": float(max(ref_key.numel(), 1)),
                "c_val_gap": float("inf")}
    col = c_col[:c_nnz].long()
    val = c_val[:c_nnz].double()
    key = row_ids(rpt) * n + col
    bad = int(((col < 0) | (col >= n)).sum())
    bad += int((key[1:] <= key[:-1]).sum())  # unsorted or repeated
    pos = torch.searchsorted(ref_key, key).clamp(max=max(ref_key.numel() - 1,
                                                          0))
    hit = (ref_key[pos] == key) if ref_key.numel() else torch.zeros_like(
        key, dtype=torch.bool)
    bad += int((~hit).sum())  # entries the reference lacks
    bad += int((~torch.isin(ref_key, key)).sum())  # entries C lacks
    gap = 0.0
    if bool(hit.any()):
        p = pos[hit]
        d = (val[hit] - ref_val[p]).abs() / ref_scale[p].clamp(min=TINY)
        gap = float(torch.nan_to_num(d, nan=float("inf")).max())
    return {"c_struct": float(bad), "c_val_gap": gap}


def spmv_ref(a: Csr, x: torch.Tensor, semiring: str,
             precision: str = "float64"):
    """(y, scale) of y = A (.) x: ``plus_times`` sums a_ij x_j (scale
    |A||x|), ``min_plus`` takes the least a_ij + x_j (scale |y|); an empty
    row holds the semiring's identity."""
    m = a.shape[0]
    rows = row_ids(a.rpt)
    v, xg = _cast(a.val, precision), _cast(x, precision)[a.col.long()]
    if semiring == "plus_times":
        y = torch.zeros(m, dtype=v.dtype, device=v.device).index_add_(
            0, rows, v * xg)
        scale = torch.zeros_like(y).index_add_(0, rows, (v * xg).abs())
        return y, scale
    if semiring == "min_plus":
        y = torch.full((m,), float("inf"), dtype=v.dtype,
                       device=v.device).scatter_reduce_(0, rows, v + xg,
                                                        "amin")
        return y, y.abs()
    raise ValueError(f"no reference for semiring {semiring!r}")


def spmv_gap(a: Csr, x: torch.Tensor, y: torch.Tensor, semiring: str
             ) -> dict[str, float]:
    """``y_gap``: the widest gap of y from the reference, over the row's
    scale (equal infinities agree; NaN or a wrong shape is infinite)."""
    ref, scale = spmv_ref(a, x, semiring)
    if tuple(y.shape) != tuple(ref.shape):
        return {"y_gap": float("inf")}
    y = y.double()
    d = (y - ref).abs() / scale.clamp(min=TINY)
    d[y == ref] = 0.0
    d = torch.nan_to_num(d, nan=float("inf"))
    return {"y_gap": float(d.max()) if d.numel() else 0.0}


def csr_parts(c):
    """(row pointers, columns, values, nnz) of a call's C: the program's
    CSR, or the control's tuple of them."""
    return c if isinstance(c, tuple) else (c.rpt, c.col, c.val, c.nnz)


def spgemm_control(a: Csr, b: Csr):
    """The control in a SpGEMM call's place: C from the TF32 reference,
    as (row pointers, columns, values, nnz)."""
    key, val, _ = spgemm_ref(a, b, "tf32")
    m, n = a.shape[0], b.shape[1]
    rpt = torch.zeros(m + 1, dtype=torch.int32, device=key.device)
    rpt[1:] = torch.bincount(key // n, minlength=m).cumsum(0)
    return rpt, (key % n).int(), val, int(key.numel())

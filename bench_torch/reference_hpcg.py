"""The plain reference of the HPCG cells and the comparisons that decide
their ``correct``.

Plain PyTorch on the benchmark's own CSR (``reference.Csr``), built on
``reference.py``'s pieces (its row blocks, its expansion of a block's
products, its row ids): nothing here imports the program or reads what
it made.

- The Galerkin set-up: each coarse operator A_{l+1} = R_l (A_l P_l), each
  product expanded in blocks of rows, the products of each (row, column)
  key summed, beside the scale |R_l||A_l||P_l| an entry's rounding is
  measured against; each level starts from the reference's own coarser
  operator.  The symbolic pass gives the products and the patterns alone.
- The SpMV is ``reference.spmv_gap``'s (float64, over |A||x|); only
  its float32 control is here.

The control is the same reference one precision below the
configurations' float64: inputs rounded to float32, products and sums in
float32.
"""

from __future__ import annotations

import torch

from reference import (PRODUCT_BLOCK, TINY, Csr, _products, _row_blocks,
                       row_ids)

PRECISIONS = {"float64": torch.float64, "float32": torch.float32}
ROW_BLOCK = 1 << 22  # rows a block of the control's SpMV


def _pattern(m: Csr) -> Csr:
    """``m`` with values of no width, so that ``_products`` gathers none."""
    return Csr(rpt=m.rpt, col=m.col, val=m.col.new_empty(m.nnz, 0),
               shape=m.shape)


def _from_keys(keys: torch.Tensor, val, shape) -> Csr:
    """The CSR of sorted unique keys row * N + column with ``val``."""
    m, n = shape
    rpt = torch.zeros(m + 1, dtype=torch.int32, device=keys.device)
    rpt[1:] = torch.bincount(keys // n, minlength=m).cumsum(0)
    return Csr(rpt=rpt, col=(keys % n).int(), val=val, shape=shape)


def product(a: Csr, b: Csr, dtype, b_scale=None,
            budget: int = PRODUCT_BLOCK):
    """C = A @ B with products and sums in ``dtype``, block of rows by
    block of rows: (sorted keys row * N + column, values, scales).  The
    scale of an entry sums |a| times ``b_scale`` (B's own scale; |B| where
    None) over its products."""
    # B's scale as B's values, expanded as B is (a gather of value and
    # scale side by side, 16 bytes a row, is far slower on a card)
    scale_b = None if b_scale is None else Csr(
        rpt=b.rpt, col=b.col, val=b_scale, shape=b.shape)
    keys, vals, scales = [], [], []
    for r0, r1 in _row_blocks(a, b, budget):
        key, av, bv = _products(a, b, r0, r1)
        av, bv = av.to(dtype), bv.to(dtype)
        bs = bv.abs() if scale_b is None else _products(
            a, scale_b, r0, r1)[2].to(dtype)
        ukey, inv = torch.unique(key, sorted=True, return_inverse=True)
        keys.append(ukey)
        vals.append(torch.zeros(ukey.numel(), dtype=dtype,
                                device=key.device).index_add_(0, inv,
                                                              av * bv))
        scales.append(torch.zeros_like(vals[-1]).index_add_(
            0, inv, av.abs() * bs))
        del key, av, bv, bs, inv
    return torch.cat(keys), torch.cat(vals), torch.cat(scales)


def galerkin(r: Csr, a: Csr, p: Csr, precision: str = "float64"):
    """R (A P) in ``precision``: (its CSR, the scale |R||A||P| of each
    entry)."""
    dtype = PRECISIONS[precision]
    key, val, scale = product(a, p, dtype)
    ap = _from_keys(key, val, (a.shape[0], p.shape[1]))
    del key, val
    key, val, scale = product(r, ap, dtype, b_scale=scale)
    del ap
    return _from_keys(key, val, (r.shape[0], p.shape[1])), scale


def hierarchy(a0: Csr, transfers, precision: str = "float64"):
    """[(A_{l+1}, its scale)] for each (R_l, P_l) of ``transfers``, each
    from the reference's A_l."""
    out, a = [], a0
    for r, p in transfers:
        a, scale = galerkin(r, a, p, precision)
        out.append((a, scale))
    return out


def symbolic(a: Csr, b: Csr, budget: int = PRODUCT_BLOCK):
    """(intermediate products of A @ B, the pattern of C as a CSR with no
    values): ``reference.spgemm_symbolic``, keeping the pattern that the
    next product reads."""
    keys, n_products = [], 0
    pa, pb = _pattern(a), _pattern(b)
    for r0, r1 in _row_blocks(a, b, budget):
        key, _, _ = _products(pa, pb, r0, r1)
        n_products += key.numel()
        keys.append(torch.unique(key))
        del key
    keys = torch.cat(keys)
    return n_products, _from_keys(keys, None, (a.shape[0], b.shape[1]))


def galerkin_symbolic(a0: Csr, transfers):
    """For each level: (products of A·P, nnz(A·P), products of R·(A·P),
    the pattern of A_{l+1})."""
    out, a = [], a0
    for r, p in transfers:
        p_ap, ap = symbolic(a, p)
        p_rap, a = symbolic(r, ap)
        out.append((p_ap, ap.nnz, p_rap, a))
        del ap
    return out


def csr_gaps(ref: Csr, scale: torch.Tensor, c_rpt, c_col, c_val,
             c_nnz: int) -> dict[str, float]:
    """How far C (``c_rpt``, ``c_col``, ``c_val``, its first ``c_nnz``
    entries) lies from the reference's C: ``c_struct``, the entries that
    break the CSR contract (row pointers, canonical order, column range)
    or lie on only one side; ``c_val_gap``, the widest gap of a shared
    entry's value from the reference's, over its scale."""
    m, n = ref.shape
    ref_key = row_ids(ref.rpt) * n + ref.col.long()
    rpt = c_rpt.long()
    if (rpt.numel() != m + 1 or int(rpt[0]) != 0 or int(rpt[-1]) != c_nnz
            or bool((rpt.diff() < 0).any())):
        return {"c_struct": float(max(ref_key.numel(), 1)),
                "c_val_gap": float("inf")}
    col = c_col[:c_nnz].long()
    key = row_ids(rpt) * n + col
    bad = int(((col < 0) | (col >= n)).sum())
    bad += int((key[1:] <= key[:-1]).sum())  # unsorted or repeated
    pos = torch.searchsorted(ref_key, key).clamp(
        max=max(ref_key.numel() - 1, 0))
    hit = (ref_key[pos] == key) if ref_key.numel() else torch.zeros_like(
        key, dtype=torch.bool)
    bad += int((~hit).sum())  # entries the reference lacks
    bad += int((~torch.isin(ref_key, key)).sum())  # entries C lacks
    gap = 0.0
    if bool(hit.any()):
        q = pos[hit]
        d = (c_val[:c_nnz][hit].double() - ref.val[q].double()).abs() / \
            scale[q].double().clamp(min=TINY)
        gap = float(torch.nan_to_num(d, nan=float("inf")).max())
    return {"c_struct": float(bad), "c_val_gap": gap}


def hierarchy_gaps(a0: Csr, transfers, outs) -> dict[str, float]:
    """The gaps of a set-up's coarse operators ``outs`` (each the
    program's CSR, or the control's tuple of its parts) from the float64
    reference's: ``c_struct`` summed, ``c_val_gap`` the widest, over the
    levels."""
    if len(outs) != len(transfers):
        return {"c_struct": float("inf"), "c_val_gap": float("inf")}
    total = {"c_struct": 0.0, "c_val_gap": 0.0}
    for (ref, scale), out in zip(hierarchy(a0, transfers), outs):
        parts = out if isinstance(out, tuple) else (out.rpt, out.col,
                                                     out.val, out.nnz)
        g = csr_gaps(ref, scale, *parts)
        total["c_struct"] += g["c_struct"]
        total["c_val_gap"] = max(total["c_val_gap"], g["c_val_gap"])
        del ref, scale
    return total


def hierarchy_control(a0: Csr, transfers):
    """The control in a set-up call's place: each coarse operator of the
    float32 reference, as (row pointers, columns, values, nnz)."""
    return [(a.rpt, a.col, a.val, a.nnz)
            for a, _ in hierarchy(a0, transfers, "float32")]


def spmv_control(a: Csr, x: torch.Tensor) -> torch.Tensor:
    """The control in a SpMV call's place: y = A x with inputs rounded to
    float32 and products and sums in float32, in blocks of rows."""
    m = a.shape[0]
    y = torch.zeros(m, dtype=torch.float32, device=x.device)
    xf = x.float()
    for r0 in range(0, m, ROW_BLOCK):
        r1 = min(r0 + ROW_BLOCK, m)
        s, e = int(a.rpt[r0]), int(a.rpt[r1])
        y[r0:r1].index_add_(0, row_ids(a.rpt, r0, r1) - r0,
                            a.val[s:e].float() * xf[a.col[s:e].long()])
    return y


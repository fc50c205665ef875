"""Oracles and tolerance checkers (counterpart of
``nsparse_tpu/utils/checking.py``, same tolerances).

- ``ans_check``: fail where ``|y - y_ref| > rtol * max(|y_ref|, scale)``
  with rtol 1e-5 for 4-byte values and 1e-8 for 8-byte values; ``scale``
  is the |A||B| backward-error bound that accepts any summation order.
- ``spmv_oracle``/``spmv_abs_oracle``: scipy y = A @ x and the |A||x|
  scale for ``ans_check``.
- ``check_spgemm_answer``: exact structure (rpt and col equal) plus
  tolerant values against a scipy CSR.
- ``ans_check_device`` / ``check_spgemm_answer_device``: the same checks
  reduced on the answer's device (the oracle goes up in float64, one
  scalar per comparison comes back).
- ``csr_allclose``: tolerant matrix equality (``CSR.__eq__``).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from nsparse_tpu_torch.formats.csr import CSR


def _rtol_for(dtype) -> float:
    return 1e-5 if np.dtype(dtype).itemsize <= 4 else 1e-8


def spmv_oracle(a: CSR, x) -> np.ndarray:
    """scipy y = A @ x (``x`` a numpy array or a tensor)."""
    return a.to_scipy() @ _host(x)


def spmv_abs_oracle(a: CSR, x) -> np.ndarray:
    """|A| @ |x|: the backward-error scale of each y_i."""
    return abs(a.to_scipy().astype(np.float64)) @ np.abs(
        _host(x).astype(np.float64))


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if hasattr(x, "cpu") else np.asarray(x)


def spgemm_oracle(a: CSR, b: CSR):
    """scipy C = A @ B in canonical CSR."""
    c = (a.to_scipy() @ b.to_scipy()).tocsr()
    c.sum_duplicates()
    c.sort_indices()
    return c


def spgemm_abs_oracle(a: CSR, b: CSR):
    """|A| @ |B| on C's sparsity: the backward-error scale of c_ij."""
    sa = abs(a.to_scipy().astype(np.float64))
    sb = abs(b.to_scipy().astype(np.float64))
    c = (sa @ sb).tocsr()
    c.sum_duplicates()
    c.sort_indices()
    return c


def ans_check(y, y_ref, dtype=None, max_report: int = 10,
              verbose: bool = False, scale=None) -> Tuple[bool, int]:
    """Element-wise relative check; returns (ok, n_fail)."""
    y = _host(y)
    y_ref = _host(y_ref)
    rtol = _rtol_for(dtype or y.dtype)
    denom = np.abs(y_ref)
    if scale is not None:
        denom = np.maximum(denom, np.asarray(scale, dtype=np.float64))
    err = np.abs(y.astype(np.float64) - y_ref.astype(np.float64))
    fail = err > rtol * np.maximum(denom, np.finfo(np.float64).tiny ** 0.5)
    n_fail = int(fail.sum())
    if verbose and n_fail:
        for i in np.nonzero(fail)[0][:max_report]:
            print(f"  mismatch [{i}]: got {y[i]!r} want {y_ref[i]!r}")
    return n_fail == 0, n_fail


def check_spgemm_answer(c: CSR, c_ref, verbose: bool = False,
                        abs_ref=None) -> bool:
    """Exact structure + tolerant values vs a scipy CSR.

    ``abs_ref``: optional |A|@|B| CSR (same sparsity) from
    :func:`spgemm_abs_oracle` for the backward-error-aware tolerance.
    """
    ref = c_ref.tocsr()
    ref.sum_duplicates()
    ref.sort_indices()
    got = c.to_scipy()
    for what, ok in (
        ("shape", got.shape == ref.shape),
        ("nnz", got.nnz == ref.nnz),
        ("rpt", np.array_equal(got.indptr, ref.indptr)),
        ("col", np.array_equal(got.indices, ref.indices)),
    ):
        if not ok:
            if verbose:
                print(f"{what} mismatch")
            return False
    ok, n_fail = ans_check(
        got.data, ref.data, dtype=got.data.dtype, verbose=verbose,
        scale=abs_ref.data if abs_ref is not None else None,
    )
    if verbose and not ok:
        print(f"{n_fail} value mismatches")
    return ok


def ans_check_device(y, y_ref, dtype=None, scale=None) -> Tuple[bool, int]:
    """:func:`ans_check` reduced on ``y``'s device: the oracle (and
    ``scale``) go up in float64, one count of failures comes back."""
    y = torch.as_tensor(y)
    dev = y.device
    rtol = _rtol_for(dtype or _np_dtype(y.dtype))
    ref = torch.as_tensor(np.asarray(_host(y_ref), dtype=np.float64),
                          device=dev)
    denom = ref.abs()
    if scale is not None:
        denom = torch.maximum(denom, torch.as_tensor(
            np.asarray(_host(scale), dtype=np.float64), device=dev))
    floor = float(np.finfo(np.float64).tiny ** 0.5)
    err = (y.double() - ref).abs()
    n_fail = int((err > rtol * denom.clamp(min=floor)).sum())
    return n_fail == 0, n_fail


def check_spgemm_answer_device(c: CSR, c_ref, abs_ref=None) -> bool:
    """:func:`check_spgemm_answer` reduced on C's device: ``rpt`` and
    ``col`` equal to the scipy oracle's exactly, then
    :func:`ans_check_device` on the values."""
    ref = c_ref.tocsr()
    ref.sum_duplicates()
    ref.sort_indices()
    if tuple(c.shape) != tuple(ref.shape) or c.nnz != ref.nnz:
        return False
    dev, nnz = c.val.device, c.nnz

    def same(got, want) -> bool:
        return bool(torch.equal(got.int(), torch.as_tensor(
            want.astype(np.int32), device=dev)))

    if not (same(c.rpt, ref.indptr) and same(c.col[:nnz], ref.indices)):
        return False
    ok, _ = ans_check_device(
        c.val[:nnz], ref.data, dtype=_np_dtype(c.val.dtype),
        scale=abs_ref.data if abs_ref is not None else None)
    return ok


def csr_allclose(a: CSR, b: CSR) -> bool:
    """Tolerant matrix equality (the reference's ``CSR::operator==``):
    scipy-canonical structure equal, values by :func:`ans_check`."""
    sa, sb = a.to_scipy(), b.to_scipy()
    for s in (sa, sb):
        s.sum_duplicates()
        s.sort_indices()
    if sa.shape != sb.shape or sa.nnz != sb.nnz:
        return False
    if not (np.array_equal(sa.indptr, sb.indptr)
            and np.array_equal(sa.indices, sb.indices)):
        return False
    return ans_check(sa.data, sb.data, dtype=sa.data.dtype)[0]


def _np_dtype(dtype: torch.dtype) -> np.dtype:
    return torch.empty(0, dtype=dtype).numpy().dtype

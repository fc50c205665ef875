"""Oracles and tolerance checkers (counterpart of
``nsparse_tpu/utils/checking.py``, same tolerances).

- ``ans_check``: fail where ``|y - y_ref| > rtol * max(|y_ref|, scale)``
  with rtol 1e-5 for 4-byte values and 1e-8 for 8-byte values; ``scale``
  is the |A||B| backward-error bound that accepts any summation order.
- ``spmv_oracle``/``spmv_abs_oracle``: scipy y = A @ x and the |A||x|
  scale for ``ans_check``.
- ``check_spgemm_answer``: exact structure (rpt and col equal) plus
  tolerant values against a scipy CSR.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

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

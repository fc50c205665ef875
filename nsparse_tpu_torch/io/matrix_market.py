"""Matrix Market reader and writer (counterpart of
``nsparse_tpu/io/matrix_market.py``).

Same semantics as the JAX package: symmetrize unless the header says
``general`` (``skew-symmetric`` mirrors with negated values), pattern
entries are 1.0, indices are 1-based, duplicates are summed.  Large files
go through the native parser (``native.read_mtx_native``).
"""

from __future__ import annotations

import io

import numpy as np

from nsparse_tpu_torch.formats.coo import COO
from nsparse_tpu_torch.formats.csr import CSR


def _parse_header(line: str):
    toks = line.strip().lower().split()
    if len(toks) < 3 or not toks[0].startswith("%%matrixmarket"):
        raise ValueError(f"not a MatrixMarket file: {line!r}")
    fmt = toks[2]
    field = toks[3] if len(toks) > 3 else "real"
    symmetry = toks[4] if len(toks) > 4 else "general"
    return fmt, field, symmetry


def read_mtx_arrays(path: str):
    """Parse a .mtx file to (rows, cols, vals, (M, N)), symmetrized: the
    native parser, or :func:`read_mtx_arrays_numpy` without it."""
    from nsparse_tpu_torch.native import read_mtx_native

    got = read_mtx_native(path)
    return got if got is not None else read_mtx_arrays_numpy(path)


def read_mtx_arrays_numpy(path: str):
    """numpy form of :func:`read_mtx_arrays` (the behavioural spec)."""
    with open(path, "rb") as f:
        fmt, field, symmetry = _parse_header(
            f.readline().decode("ascii", errors="replace")
        )
        if fmt != "coordinate":
            raise NotImplementedError("array (dense) .mtx not supported")
        line = f.readline().decode("ascii", errors="replace")
        while line.startswith("%"):
            line = f.readline().decode("ascii", errors="replace")
        m, n, nz = (int(t) for t in line.split()[:3])
        body = np.loadtxt(
            io.BytesIO(f.read()), dtype=np.float64, ndmin=2
        ) if nz else np.zeros((0, 3))

    if body.size and body.shape[0] != nz:
        raise ValueError(f"expected {nz} entries, got {body.shape[0]}")
    rows = body[:, 0].astype(np.int64) - 1 if nz else np.zeros(0, np.int64)
    cols = body[:, 1].astype(np.int64) - 1 if nz else np.zeros(0, np.int64)
    if field == "pattern" or body.shape[1] < 3:
        vals = np.ones(rows.shape[0], dtype=np.float64)
    else:
        vals = body[:, 2].copy()
    if symmetry != "general":
        sgn = -1.0 if symmetry == "skew-symmetric" else 1.0
        off = rows != cols
        rows, cols, vals = (
            np.concatenate([rows, cols[off]]),
            np.concatenate([cols, rows[off]]),
            np.concatenate([vals, sgn * vals[off]]),
        )
    return rows, cols, vals, (m, n)


def read_mtx(path: str, dtype=np.float64) -> CSR:
    """.mtx -> canonical CSR on the host."""
    import scipy.sparse as sp

    rows, cols, vals, shape = read_mtx_arrays(path)
    coo = sp.coo_matrix((vals.astype(dtype), (rows, cols)), shape=shape)
    return CSR.from_scipy(coo)


def read_mtx_coo(path: str, dtype=np.float64, pad_to=None) -> COO:
    """.mtx -> COO in file order (symmetrized, duplicates kept)."""
    rows, cols, vals, shape = read_mtx_arrays(path)
    return COO.from_arrays(rows, cols, vals.astype(dtype), shape,
                           pad_to=pad_to)


def write_mtx(path: str, a: CSR, symmetry: str = "general") -> None:
    """Write ``a`` as a coordinate .mtx, 1-based, values as ``%.17g``
    (the JAX package's text, byte for byte)."""
    s = a.to_scipy().tocoo()
    with open(path, "w") as f:
        f.write(f"%%MatrixMarket matrix coordinate real {symmetry}\n")
        f.write(f"{a.shape[0]} {a.shape[1]} {s.nnz}\n")
        for r, c, v in zip(s.row, s.col, s.data):
            f.write(f"{r + 1} {c + 1} {v:.17g}\n")

"""Matrix generators (counterpart of ``nsparse_tpu/io/generate.py``).

The random draws are the JAX package's, call for call, so equal seeds give
identical arrays in both packages.
"""

from __future__ import annotations

import numpy as np

from nsparse_tpu_torch.formats.csr import CSR


def stencil_csr(nx: int, ny: int, dtype=np.float64) -> CSR:
    """2-D 5-point Laplacian on an nx x ny grid."""
    import scipy.sparse as sp

    d = sp.diags(
        [4.0, -1.0, -1.0, -1.0, -1.0],
        [0, -1, 1, -nx, nx],
        shape=(nx * ny, nx * ny),
        format="csr",
    )
    return CSR.from_scipy(d.astype(dtype))


def rmat_csr(
    scale: int,
    edge_factor: int = 8,
    a: float = 0.57,
    b: float = 0.19,
    c: float = 0.19,
    dtype=np.float64,
    seed: int = 0,
) -> CSR:
    """R-MAT power-law graph (Graph500-style), duplicates merged."""
    import scipy.sparse as sp

    rng = np.random.default_rng(seed)
    n = 1 << scale
    ne = n * edge_factor
    rows = np.zeros(ne, dtype=np.int64)
    cols = np.zeros(ne, dtype=np.int64)
    ab = a + b
    a_norm = a / ab
    c_norm = c / (1.0 - ab)
    for _ in range(scale):
        r1 = rng.random(ne)
        r2 = rng.random(ne)
        down = r1 > ab
        right = np.where(down, r2 > c_norm, r2 > a_norm)
        rows = (rows << 1) | down
        cols = (cols << 1) | right
    vals = rng.standard_normal(ne).astype(dtype)
    return CSR.from_scipy(sp.coo_matrix((vals, (rows, cols)), shape=(n, n)))

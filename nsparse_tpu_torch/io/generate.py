"""Matrix generators (counterpart of ``nsparse_tpu/io/generate.py``).

The random draws are the JAX package's, call for call, so equal seeds give
identical arrays in both packages.
"""

from __future__ import annotations

import numpy as np

from nsparse_tpu_torch.formats.csr import CSR


def random_csr(m: int, n: int, density: float = 0.01, dtype=np.float64,
               seed: int = 0) -> CSR:
    """Uniform random sparse matrix (duplicates merged)."""
    import scipy.sparse as sp

    rng = np.random.default_rng(seed)
    nnz = max(int(m * n * density), 1)
    rows = rng.integers(0, m, size=nnz)
    cols = rng.integers(0, n, size=nnz)
    vals = rng.standard_normal(nnz).astype(dtype)
    return CSR.from_scipy(sp.coo_matrix((vals, (rows, cols)), shape=(m, n)))


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


def fem_block_csr(n_nodes: int, dof: int = 16, neighbors: int = 6,
                  bandwidth: int = 32, dtype=np.float64, seed: int = 0) -> CSR:
    """Multi-DOF FEM-stiffness stand-in: dense (dof, dof) blocks on a
    banded node graph (the block-clustered class BSR is for)."""
    import scipy.sparse as sp

    rng = np.random.default_rng(seed)
    rows, cols = [np.arange(n_nodes)], [np.arange(n_nodes)]
    for _ in range(neighbors):
        off = rng.integers(1, bandwidth, n_nodes)
        j = np.minimum(np.arange(n_nodes) + off, n_nodes - 1)
        rows += [np.arange(n_nodes), j]
        cols += [j, np.arange(n_nodes)]
    r = np.concatenate(rows)
    c = np.concatenate(cols)
    graph = sp.coo_matrix((np.ones(r.size), (r, c)),
                          shape=(n_nodes, n_nodes)).tocsr()
    graph.sum_duplicates()
    data = rng.standard_normal((graph.nnz, dof, dof)).astype(dtype)
    bsr = sp.bsr_matrix((data, graph.indices, graph.indptr),
                        shape=(n_nodes * dof, n_nodes * dof))
    return CSR.from_scipy(bsr.tocsr())


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

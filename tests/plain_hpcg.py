"""A plain float64 model of HPCG's operator and its Galerkin hierarchy,
in dense torch tensors, for the tests of ``rap`` and the DIA SpMV.

HPCG (https://www.hpcg-benchmark.org/, reference code 3.1): the 27-point
stencil on an n×n×n grid in natural order (x fastest), diagonal 26 and
-1 for each neighbour.  Variable coefficients scale each off-diagonal
pair (i, j), (j, i) by one factor uniform in [0.5, 1.5).  P is trilinear
interpolation from the coarse points (2i, 2j, 2k) (1-D weights 1 and ½;
the last odd point of a line takes its one coarse neighbour, at ½), R is
Pᵀ, and the coarse operator is the Galerkin product R·(A·P).

Everything here is dense matrix arithmetic in float64 with TF32 off; it
imports no JAX and no kernel of the port.
"""

from __future__ import annotations

import itertools

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

# the 27 (dz, dy, dx) of the stencil, in ascending column order
OFFSETS = tuple(itertools.product((-1, 0, 1), repeat=3))


def grid(n: int):
    """(x, y, z) of each of the n³ points, x fastest."""
    i = torch.arange(n ** 3)
    return i % n, (i // n) % n, i // (n * n)


def neighbours(n: int):
    """For each offset (dz, dy, dx): the flat offset and, per point,
    whether that neighbour lies on the grid."""
    x, y, z = grid(n)
    out = []
    for dz, dy, dx in OFFSETS:
        inside = ((x + dx >= 0) & (x + dx < n) & (y + dy >= 0)
                  & (y + dy < n) & (z + dz >= 0) & (z + dz < n))
        out.append((dx + n * dy + n * n * dz, inside))
    return out


def operator(n: int, seed: int | None = None) -> torch.Tensor:
    """A as a dense (n³, n³) float64 matrix: HPCG's values, each
    off-diagonal pair scaled by a factor uniform in [0.5, 1.5) drawn from
    ``seed`` (None: every factor 1)."""
    size = n ** 3
    f = torch.ones(size, size, dtype=torch.float64)
    if seed is not None:
        g = torch.Generator().manual_seed(seed)
        u = torch.rand(size, size, generator=g, dtype=torch.float64) + 0.5
        f = torch.triu(u, 1) + torch.triu(u, 1).T
    a = torch.zeros(size, size, dtype=torch.float64)
    rows = torch.arange(size)
    for off, inside in neighbours(n):
        i = rows[inside]
        a[i, i + off] = 26.0 if off == 0 else -f[i, i + off]
    return a


def interpolation_1d(nf: int) -> torch.Tensor:
    """(nf, ceil(nf/2)) linear interpolation: fine point 2c is coarse
    point c (weight 1), fine point 2c+1 takes ½ of c and of c+1 where
    c+1 exists."""
    nc = (nf + 1) // 2
    p = torch.zeros(nf, nc, dtype=torch.float64)
    for i in range(nf):
        if i % 2 == 0:
            p[i, i // 2] = 1.0
        else:
            p[i, i // 2] = 0.5
            if i // 2 + 1 < nc:
                p[i, i // 2 + 1] = 0.5
    return p


def interpolation(nf: int) -> torch.Tensor:
    """Trilinear P from the (nf)³ grid to the coarse grid: the Kronecker
    product of the 1-D interpolation (z outermost, x fastest)."""
    p1 = interpolation_1d(nf)
    return torch.kron(torch.kron(p1, p1), p1)


def galerkin(r: torch.Tensor, a: torch.Tensor, p: torch.Tensor):
    """(R·A·P, |R||A||P|, its pattern): the product in float64, the scale
    a computed entry's rounding is measured against, and the entries a
    sparse product stores (the pattern of |R||A||P|, which nothing
    cancels)."""
    r, a, p = r.double(), a.double(), p.double()
    value = r @ (a @ p)
    scale = r.abs() @ (a.abs() @ p.abs())
    return value, scale, scale > 0


def diagonals(n: int, values: torch.Tensor | None = None):
    """(offsets, vals) of A's 27 diagonals: ``vals[d, i] = A[i, i +
    offsets[d]]``, 0 where that neighbour is off the grid; ``values``:
    A as a dense matrix (default: HPCG's values)."""
    a = operator(n) if values is None else values
    rows = torch.arange(n ** 3)
    offs, vals = [], []
    for off, inside in neighbours(n):
        v = torch.zeros(n ** 3, dtype=a.dtype)
        v[inside] = a[rows[inside], rows[inside] + off]
        offs.append(off)
        vals.append(v)
    return tuple(offs), torch.stack(vals)


def dia_spmv(offsets, vals: torch.Tensor, x: torch.Tensor):
    """(y, |A||x|) of y = A x by shifted sums over the diagonals, in
    float64: term d of row i is vals[d, i] * x[i + offsets[d]], 0 off the
    end of x."""
    m, n = vals.shape[1], x.numel()
    y = torch.zeros(m, dtype=torch.float64)
    scale = torch.zeros(m, dtype=torch.float64)
    xd = x.double()
    for off, v in zip(offsets, vals.double()):
        lo, hi = max(0, -off), min(m, n - off)
        if hi <= lo:
            continue
        t = v[lo:hi] * xd[lo + off: hi + off]
        y[lo:hi] += t
        scale[lo:hi] += t.abs()
    return y, scale

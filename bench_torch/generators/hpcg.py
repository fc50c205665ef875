"""HPCG's operator and its multigrid hierarchy, made on the device.

HPCG 3.1 (https://www.hpcg-benchmark.org/): the 27-point stencil on an
nx × ny × nz grid in natural order (row x + nx (y + ny z), x fastest),
diagonal 26 and -1 for each neighbour, in float64; a multigrid of
``levels`` levels, each coarsened by 2 in every dimension.  The set-up's
transfer operators (the configuration's ``assumed``): P_l is trilinear
interpolation from the coarse points (2i, 2j, 2k), 1-D weights 1 and ½,
the last odd point of a line taking its one coarse neighbour at ½; R_l
is P_lᵀ.

Every matrix here is a Kronecker product of three 1-D factors in its
pattern: the stencil of three tridiagonal patterns, P of three 1-D
interpolations, R of their transposes.  Each is built as w³ slots a row
(w the 1-D factor's slots), whose columns come out in order, and
compressed by a mask: a canonical CSR with no sort.  The values of A are
made per value set: each off-diagonal pair (i, j), (j, i) scaled by one
factor uniform in [0.5, 1.5) from the run's seed, the diagonal 26.
torch's uniform float32 draws are multiples of 2^-24, so every factor is
exact in float64 and every seed gives the same values on every run.
"""

import dataclasses
import itertools

import torch

from reference import Csr

LANES = 128  # the port's DIA pads its rows to a multiple of this
# the stencil's (dz, dy, dx), in the column order of a row; slot 13 is the
# diagonal and slot 26 - s the mirror of slot s
STENCIL = tuple(itertools.product((-1, 0, 1), repeat=3))
CENTRE = STENCIL.index((0, 0, 0))


def device_generator(seed: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (1 << 63))
    return g


@dataclasses.dataclass(frozen=True)
class Factor:
    """A 1-D factor: row i's slot s holds column ``cols[i, s]`` and value
    ``vals[i, s]`` where ``ok[i, s]``; the slots of a row in column order."""

    cols: torch.Tensor
    vals: torch.Tensor
    ok: torch.Tensor
    n_cols: int


def tridiagonal(n: int, device) -> Factor:
    """The stencil's 1-D pattern: columns i - 1, i, i + 1 on the grid."""
    i = torch.arange(n, device=device, dtype=torch.int32)
    cols = torch.stack([i - 1, i, i + 1], 1)
    return Factor(cols, torch.ones(n, 3, dtype=torch.float64, device=device),
                  (cols >= 0) & (cols < n), n)


def interpolation(nf: int, device) -> Factor:
    """1-D linear interpolation, nf fine points from ceil(nf / 2) coarse:
    fine 2c is coarse c (1); fine 2c + 1 takes ½ of c and of c + 1."""
    nc = (nf + 1) // 2
    i = torch.arange(nf, device=device, dtype=torch.int32)
    odd = i % 2 == 1
    cols = torch.stack([i // 2, i // 2 + 1], 1)
    vals = torch.stack([torch.where(odd, 0.5, 1.0).double(),
                        torch.full((nf,), 0.5, dtype=torch.float64,
                                   device=device)], 1)
    ok = torch.stack([torch.ones_like(odd), odd & (i // 2 + 1 < nc)], 1)
    return Factor(cols, vals, ok, nc)


def restriction(nf: int, device) -> Factor:
    """The transpose of ``interpolation(nf)``: coarse c takes fine
    2c - 1, 2c, 2c + 1 at ½, 1, ½, where they exist."""
    nc = (nf + 1) // 2
    c = torch.arange(nc, device=device, dtype=torch.int32)
    cols = torch.stack([2 * c - 1, 2 * c, 2 * c + 1], 1)
    vals = torch.tensor([0.5, 1.0, 0.5], dtype=torch.float64,
                        device=device).expand(nc, 3)
    return Factor(cols, vals, (cols >= 0) & (cols < nf), nf)


def kron3(fz: Factor, fy: Factor, fx: Factor, values: bool = True):
    """(the CSR of fz ⊗ fy ⊗ fx, rows x fastest, and its slot mask
    (rows, w³)): a row's slots (sz, sy, sx) run in column order, so the
    mask compresses them straight into a canonical CSR.  ``values``:
    the products of the factors' values, else None (the pattern)."""
    (nz, wz), (ny, wy), (nx, wx) = fz.cols.shape, fy.cols.shape, \
        fx.cols.shape
    n = nz * ny * nx

    def spread(f, axis):
        shape = [1] * 6
        shape[axis], shape[axis + 3] = f.shape
        return f.reshape(shape)

    cols = (spread(fx.cols, 2) + fx.n_cols * (
        spread(fy.cols, 1) + fy.n_cols * spread(fz.cols, 0)))
    keep = (spread(fz.ok, 0) & spread(fy.ok, 1) & spread(fx.ok, 2)
            ).reshape(n, -1)
    cols = cols.reshape(n, -1)
    rpt = torch.zeros(n + 1, dtype=torch.int32, device=keep.device)
    torch.cumsum(keep.sum(1, dtype=torch.int32), 0, out=rpt[1:])
    col = cols[keep]
    del cols
    val = (spread(fz.vals, 0) * spread(fy.vals, 1)
           * spread(fx.vals, 2)).reshape(n, -1)[keep] if values else None
    shape = (n, fz.n_cols * fy.n_cols * fx.n_cols)
    return Csr(rpt=rpt, col=col, val=val, shape=shape), keep


def dims(cfg: dict) -> tuple:
    return cfg["nx"], cfg["ny"], cfg["nz"]


def stencil_offsets(d: tuple) -> tuple:
    """The flat column offset of each stencil slot on a grid of dims
    ``d`` (nx, ny, nz)."""
    nx, ny, _ = d
    return tuple(dx + nx * dy + nx * ny * dz for dz, dy, dx in STENCIL)


@dataclasses.dataclass
class Hierarchy:
    """The fine operator's pattern (``a``, no values; ``keep``: its slot
    mask, rows × 27) and the transfer operators (R_l, P_l) of each
    level but the coarsest, in float64; ``grids`` each level's dims."""

    a: Csr
    keep: torch.Tensor
    transfers: list
    grids: list


def pattern(d: tuple, device):
    """(A's pattern, no values; its slot mask) on a grid of dims ``d``."""
    nx, ny, nz = d
    return kron3(tridiagonal(nz, device), tridiagonal(ny, device),
                 tridiagonal(nx, device), values=False)


def operator(d: tuple, device) -> Csr:
    """A with HPCG's values on a grid of dims ``d``."""
    a, keep = pattern(d, device)
    val = torch.full((a.nnz,), -1.0, dtype=torch.float64, device=device)
    # each row's diagonal follows its kept slots before the centre
    val[a.rpt[:-1].long() + keep[:, :CENTRE].sum(1)] = 26.0
    return dataclasses.replace(a, val=val)


def hierarchy(cfg: dict, device) -> Hierarchy:
    """The configuration's fine operator and its ``levels`` - 1 pairs
    (R_l, P_l)."""
    d = dims(cfg)
    a, keep = pattern(d, device)
    transfers, grids = [], [d]
    for _ in range(cfg["levels"] - 1):
        nx, ny, nz = d
        p, _ = kron3(interpolation(nz, device), interpolation(ny, device),
                     interpolation(nx, device))
        r, _ = kron3(restriction(nz, device), restriction(ny, device),
                     restriction(nx, device))
        transfers.append((r, p))
        d = tuple((n + 1) // 2 for n in d)
        grids.append(d)
    return Hierarchy(a=a, keep=keep, transfers=transfers, grids=grids)


def coefficients(h: Hierarchy, g: torch.Generator) -> torch.Tensor:
    """One value set of the fine operator (its nnz values, CSR order):
    each off-diagonal pair scaled by one factor uniform in [0.5, 1.5)
    drawn from ``g``, the diagonal 26."""
    n = h.a.shape[0]
    dev = h.keep.device
    half = len(STENCIL) // 2  # the slots past the diagonal
    f = torch.rand((half, n), generator=g, device=dev,
                   dtype=torch.float32).double() + 0.5
    vals = torch.empty(n, len(STENCIL), dtype=torch.float64, device=dev)
    i = torch.arange(n, device=dev)
    for s, off in enumerate(stencil_offsets(h.grids[0])):
        if s == CENTRE:
            vals[:, s] = 26.0
        elif s > CENTRE:  # (i, i + off): the pair's factor lies at row i
            vals[:, s] = -f[s - CENTRE - 1]
        else:  # the mirror slot of row i + off holds the pair's factor
            mirror = len(STENCIL) - 1 - s
            vals[:, s] = -f[mirror - CENTRE - 1][(i + off).clamp_(0, n - 1)]
    del f, i
    return vals[h.keep]


def diagonals(d: tuple, device):
    """(offsets, vals) of HPCG's operator on a grid of dims ``d`` as the
    port's DIA holds it: ``vals[s, i]`` is row i's entry in stencil slot
    s (26 on the diagonal, -1 elsewhere, 0 where the neighbour is off the
    grid), rows padded with zeros to a multiple of 128."""
    nx, ny, nz = d
    n = nx * ny * nz
    mp = -(-n // LANES) * LANES
    fz, fy, fx = (tridiagonal(k, device) for k in (nz, ny, nx))
    ok = (fz.ok.T.reshape(3, 1, 1, nz, 1, 1)
          & fy.ok.T.reshape(1, 3, 1, 1, ny, 1)
          & fx.ok.T.reshape(1, 1, 3, 1, 1, nx)).reshape(len(STENCIL), n)
    vals = torch.zeros(len(STENCIL), mp, dtype=torch.float64, device=device)
    vals[:, :n] = torch.where(ok, -1.0, 0.0)
    vals[CENTRE, :n] = 26.0
    return stencil_offsets(d), vals

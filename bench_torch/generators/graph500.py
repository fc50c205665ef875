"""Graph500's Kronecker (R-MAT) graph, made on the device from a seed.

The edge arithmetic is that of the program's ``io/generate.py:rmat_csr``
(one draw pair per edge and level: down when r1 > A + B, right by r2
against the row's normalised split).  The edges come from the
configuration's ``edge_seed`` (plus the pattern's number); then, as
Graph500 does, the vertex labels are permuted, and each edge gets a
weight uniform in [0, 1), as Graph500's SSSP kernel draws them, both from
the run's seed.  As Graph500's kernel 1 does, the graph is undirected:
each edge (u, v) off the diagonal is stored as (u, v) and (v, u) with its
one weight, so the matrix is symmetric.  So every seed gives the same
graph up to its labels: the same sizes, products and degrees, in another
order.  Duplicate entries are merged with their weights summed, as
``rmat_csr`` does.  torch's uniform float32 draws are multiples of 2^-24,
so the float64 sums are exact and the graph is the same on every run of
a seed, whatever order the atomics take.
"""

from __future__ import annotations

import torch

from reference import Csr

DTYPES = {"float32": torch.float32, "float64": torch.float64}


def device_generator(seed: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (1 << 63))
    return g


def generate(cfg: dict, pattern: int, seed: int, device) -> Csr:
    """Pattern number ``pattern`` of the configuration (``scale``,
    ``edge_factor``, ``A``, ``B``, ``C``, ``edge_seed``, ``dtype``), its
    labels and weights drawn from ``seed``, as a canonical CSR on
    ``device``."""
    g = device_generator(cfg["edge_seed"] + pattern, device)
    scale, n = cfg["scale"], 1 << cfg["scale"]
    ne = n * cfg["edge_factor"]
    a, b, c = cfg["A"], cfg["B"], cfg["C"]
    ab = a + b
    a_norm, c_norm = a / ab, c / (1.0 - ab)
    rows = torch.zeros(ne, dtype=torch.int64, device=device)
    cols = torch.zeros(ne, dtype=torch.int64, device=device)
    for _ in range(scale):
        r = torch.rand((2, ne), generator=g, device=device,
                       dtype=torch.float64)
        down = r[0] > ab
        right = torch.where(down, r[1] > c_norm, r[1] > a_norm)
        rows = (rows << 1) | down
        cols = (cols << 1) | right
        del r, down, right
    g = device_generator(seed, device)
    perm = torch.randperm(n, generator=g, device=device)
    weight = torch.rand(ne, generator=g, device=device, dtype=torch.float32)
    rows, cols = perm[rows], perm[cols]
    off = rows != cols  # kernel 1: each edge both ways, a loop once
    key, order = torch.sort(torch.cat([rows * n + cols,
                                       cols[off] * n + rows[off]]))
    weight = torch.cat([weight, weight[off]])
    del rows, cols, off
    ukey, inv = torch.unique_consecutive(key, return_inverse=True)
    val = torch.zeros(ukey.numel(), dtype=torch.float64,
                      device=device).index_add_(0, inv,
                                                weight[order].double())
    counts = torch.bincount(ukey // n, minlength=n)
    rpt = torch.zeros(n + 1, dtype=torch.int32, device=device)
    rpt[1:] = counts.cumsum(0)
    return Csr(rpt=rpt, col=(ukey % n).int(),
               val=val.to(DTYPES[cfg["dtype"]]), shape=(n, n))


def weights(graph: Csr, count: int, g: torch.Generator) -> torch.Tensor:
    """(count, nnz) new values for the graph's pattern, uniform in [0, 1),
    one for each edge: an entry (j, i) takes the value of (i, j), so each
    row of values keeps the matrix symmetric."""
    n = graph.shape[1]
    rows = torch.repeat_interleave(
        torch.arange(graph.shape[0], device=graph.col.device),
        graph.rpt.long().diff())
    cols = graph.col.long()
    twin = torch.searchsorted(rows * n + cols, cols * n + rows)
    w = torch.rand((count, graph.nnz), generator=g, device=graph.val.device,
                   dtype=torch.float32)
    return torch.where(rows <= cols, w, w[:, twin]).to(graph.val.dtype)

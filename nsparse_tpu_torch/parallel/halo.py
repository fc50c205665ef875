"""Halo-exchange SpMV: banded matrices with x sharded over the mesh
(counterpart of ``nsparse_tpu/parallel/halo.py``).

For a banded matrix each row block reads x only inside its own range and
a halo of the bandwidth on either side, so x is row-sharded like A and
only the halos move: the tail of shard ``d-1`` and the head of shard
``d+1`` are copied to shard ``d``'s device (JAX's two ``ppermute`` s).
Edge shards read zeros beyond the global range.

``partition_banded`` checks the bandwidth on the host, rebases the
columns into the extended local window ``[start - halo, end + halo)``
and records the halo width.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from nsparse_tpu_torch.formats.csr import CSR
from nsparse_tpu_torch.parallel.mesh import Mesh, check_mesh
from nsparse_tpu_torch.parallel.partition import (
    PartitionedCSR,
    local_spmv,
    place,
    split_rows,
)


@dataclasses.dataclass(frozen=True)
class BandedPartitionedCSR(PartitionedCSR):
    """Row-sharded CSR whose columns index ``cat(left_halo, x_local,
    right_halo)``, i.e. ``global_col - shard_start + halo``."""

    halo: int = 0


def partition_banded(a: CSR, n_shards: int, cap_multiple: int = 128,
                     mesh=None) -> BandedPartitionedCSR:
    """Split square banded ``a`` into row blocks with rebased columns
    (shard ``d`` on ``mesh.devices[d]``, or on ``a``'s device).

    Raises ValueError for a non-square matrix, and when the bandwidth
    exceeds one block (the halo would reach past the nearest neighbours;
    use the replicated-x ``spmv_dist`` then).
    """
    m, n = a.shape
    if m != n:
        raise ValueError("halo partitioning expects a square matrix")
    m_loc = (m + n_shards - 1) // n_shards
    rpt, col, val = a.host_arrays()
    rows = np.repeat(np.arange(m, dtype=np.int64), np.diff(rpt))
    dist = col[: a.nnz].astype(np.int64) - rows
    halo = int(max(-dist.min(initial=0), dist.max(initial=0)))
    if halo > m_loc:
        raise ValueError(
            f"bandwidth {halo} exceeds block size {m_loc}; halo exchange "
            "would need non-neighbor communication"
        )
    m_loc, rpts, cols, vals, nnzs = split_rows(
        rpt, col, val, m, n_shards, cap_multiple,
        col_shift=lambda d: d * m_loc - halo)
    dev = a.device
    return BandedPartitionedCSR(
        rpts=place(rpts, mesh, dev), cols=place(cols, mesh, dev),
        vals=place(vals, mesh, dev), shape=(m, n), m_loc=m_loc, nnz=a.nnz,
        shard_nnz=nnzs, halo=halo)


def shard_x(x, n_shards: int, m_loc: int, mesh=None):
    """x padded to ``n_shards * m_loc`` and split into D (m_loc,) shards:
    a tuple, shard ``d`` on ``mesh.devices[d]`` (on x's device without a
    mesh).  ``torch.stack`` of it is the JAX package's (D, m_loc)."""
    x = torch.as_tensor(x)
    pad = n_shards * m_loc - int(x.shape[0])
    xs = torch.nn.functional.pad(x, (0, pad)).view(n_shards, m_loc)
    if mesh is None:
        return tuple(xs.unbind(0))
    return tuple(xs[d].to(dev) for d, dev in enumerate(mesh.devices))


def spmv_halo(a: BandedPartitionedCSR, xs, mesh: Mesh,
              axis: str = "x") -> tuple:
    """y = A @ x with x row-sharded (``xs``: D (m_loc,) shards, see
    :func:`shard_x`; a (D, m_loc) tensor will do).  Returns the
    row-sharded y, a tuple of D (m_loc,) tensors, shard ``d``'s on
    ``mesh.devices[d]``."""
    check_mesh(mesh, a.n_shards, axis)
    m_loc, halo, nd = a.m_loc, a.halo, a.n_shards
    devs = mesh.devices
    xs = [xs[d].to(devs[d]) for d in range(nd)]
    ys = []
    for d, dev in enumerate(devs):
        x_loc = xs[d]
        if halo == 0:
            # a diagonal matrix: nothing to exchange (x_loc[-0:] would be
            # the whole shard and misalign the rebased columns)
            x_ext = x_loc
        else:
            # left neighbour's tail -> my left halo, right neighbour's
            # head -> my right halo; zeros beyond the global range
            zero = x_loc.new_zeros(halo)
            left = xs[d - 1][-halo:].to(dev) if d > 0 else zero
            right = xs[d + 1][:halo].to(dev) if d < nd - 1 else zero
            x_ext = torch.cat([left, x_loc, right])
        ys.append(local_spmv(a.rpts[d].to(dev), a.cols[d].to(dev),
                             a.vals[d].to(dev), x_ext, m_loc,
                             a.shard_nnz[d]))
    return tuple(ys)

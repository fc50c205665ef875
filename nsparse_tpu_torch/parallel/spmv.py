"""Distributed SpMV over a mesh (counterpart of
``nsparse_tpu/parallel/spmv.py``).

y = A @ x with A row-sharded and x replicated: shard ``d`` computes its
row block on ``mesh.devices[d]``.  No communication beyond placing x on
each shard's device; the halo-exchange form for banded matrices with x
sharded is ``halo.py``.
"""

from __future__ import annotations

import torch

from nsparse_tpu_torch.parallel.mesh import Mesh, check_mesh, replicas
from nsparse_tpu_torch.parallel.partition import PartitionedCSR, local_spmv


def spmv_dist(a: PartitionedCSR, x: torch.Tensor, mesh: Mesh,
              axis: str = "x", gather: bool = True):
    """y = A @ x.  ``gather``: the (M,) result on ``mesh.devices[0]``;
    else the row-sharded result, a tuple of D (m_loc,) tensors, shard
    ``d``'s on ``mesh.devices[d]`` (``torch.stack`` of it is the JAX
    package's (D, m_loc))."""
    check_mesh(mesh, a.n_shards, axis)
    xs = replicas(x, mesh)
    ys = tuple(
        local_spmv(a.rpts[d].to(dev), a.cols[d].to(dev), a.vals[d].to(dev),
                   xs[d], a.m_loc, a.shard_nnz[d])
        for d, dev in enumerate(mesh.devices))
    if gather:
        dev0 = mesh.devices[0]
        return torch.cat([y.to(dev0) for y in ys])[: a.shape[0]]
    return ys

"""Distributed window SpGEMM (counterpart of
``nsparse_tpu/parallel/spgemm_window.py``).

A is row-sharded and B replicated, as in ``parallel/spgemm.py``, but each
shard's plan is the row-localized window layout in its v2 (fused-expand)
form: ``spgemm_plan(shard, b, shuffle=True, layout="window")``.  Each
shard's numeric phase is the single-card ``spgemm_numeric`` on its
device, so it launches K11, K1, K3 v2, K2's piece mode, K12 and K4 on a
card; the distributed layer adds no numeric code of its own.

The JAX package must normalize the shard plans to one static geometry
(padded step tables, a shared class ladder, rebuilt merge copies), since
``shard_map`` runs one program on every shard; eager PyTorch runs each
shard's own plan, so none of that exists here.  The contract is kept:
every shard must take the v2 form, or the plan is refused with
NotImplementedError, so both packages refuse the same inputs.
"""

from __future__ import annotations

import dataclasses

from nsparse_tpu_torch.formats.csr import CSR
from nsparse_tpu_torch.ops.spgemm import spgemm_plan
from nsparse_tpu_torch.parallel.mesh import Mesh, check_mesh, replicas
from nsparse_tpu_torch.parallel.partition import PartitionedCSR
from nsparse_tpu_torch.parallel.spgemm import (
    PartitionedSpgemmPlan,
    numeric_on_shards,
    plans_on_shards,
)


@dataclasses.dataclass(frozen=True)
class DistWindowPlan(PartitionedSpgemmPlan):
    """One v2 window plan per shard, shard ``d``'s on its device."""


def spgemm_plan_dist_window(a: PartitionedCSR, b: CSR) -> DistWindowPlan:
    """Per-shard window plans (host); raises NotImplementedError unless
    every shard takes the v2 form (a shard too small for the routed
    layouts, or a B bank too large)."""
    plans = []
    for d in range(a.n_shards):
        p = spgemm_plan(a.shard(d), b, shuffle=True, layout="window")
        if p.win is None or not p.win.fused_expand:
            raise NotImplementedError(
                "spgemm_plan_dist_window requires fused-expand window "
                "plans on every shard (shard too small or bank too "
                "large); use spgemm_plan_dist for the sort layout"
            )
        plans.append(p)
    return DistWindowPlan(
        plans=plans_on_shards(plans, a),
        shape=(a.shape[0], b.shape[1]),
        m_loc=a.m_loc,
        c_nnz=tuple(p.c_nnz for p in plans),
        n_products=sum(p.n_products for p in plans),
    )


def spgemm_numeric_dist_window(
    dp: DistWindowPlan,
    a: PartitionedCSR,
    b: CSR,
    mesh: Mesh,
    axis: str = "x",
) -> PartitionedCSR:
    """Numeric phase: each shard's window numeric on its device; C comes
    out row-sharded."""
    check_mesh(mesh, a.n_shards, axis)
    bs = replicas(b, mesh)
    return numeric_on_shards(dp, mesh,
                             lambda d, dev: (a.shard(d).to(dev), bs[d]))

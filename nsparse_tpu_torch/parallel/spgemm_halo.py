"""Halo-exchange distributed SpGEMM: C = A @ B with both operands
row-sharded (counterpart of ``nsparse_tpu/parallel/spgemm_halo.py``).

For banded A (the AMG and FEM case) shard ``d``'s rows reference B rows
only within one block of their own range, so B is row-sharded like A and
each shard needs its two neighbour B blocks: their padded value arrays
are copied to shard ``d``'s device (JAX's two ``ppermute`` s), and edge
shards get zeros.

The host planner builds, per shard, an ordinary plan against a *local* B
made of the three neighbour blocks in their padded layout (a phantom row
per block absorbs its padding, so the row pointers stay monotone); the
numeric phase lays ``cat(prev, own, next)`` of the padded values into
that local B's value array and runs the port's ``spgemm_numeric``.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from nsparse_tpu_torch.formats.csr import CSR
from nsparse_tpu_torch.ops.spgemm import spgemm_plan
from nsparse_tpu_torch.parallel.mesh import Mesh, check_mesh
from nsparse_tpu_torch.parallel.partition import PartitionedCSR
from nsparse_tpu_torch.parallel.spgemm import (
    PartitionedSpgemmPlan,
    numeric_on_shards,
    plans_on_shards,
)
from nsparse_tpu_torch.utils.device import int32_tensor


@dataclasses.dataclass(frozen=True)
class HaloSpgemmPlan(PartitionedSpgemmPlan):
    """Per-shard plans against the local B of blocks d-1, d, d+1.

    ``b_capacity``: the padded block length of B the plans were built
    for (``bpos`` indexes ``cat(prev, own, next)`` of blocks that long);
    ``b_locs``: each shard's local B, host structure only (the numeric
    phase puts the neighbour blocks' values in it)."""

    b_capacity: int = 0
    b_locs: Tuple[CSR, ...] = ()


def _local_b_csr(b: PartitionedCSR, d: int, n_shards: int) -> CSR:
    """Blocks d-1, d, d+1 of B as one host CSR whose nnz layout matches
    ``cat([prev, own, next])`` of the padded value arrays.

    A phantom row per block spans its pad slots (duplicate column 0),
    keeping the row pointers monotone; A never references phantom rows.
    The CSR is built directly: it is not canonical, and the layout must
    stay exactly the padded concatenation.
    """
    cap = b.capacity
    m_loc = b.m_loc
    n = b.shape[1]
    cols = []
    rpt_local = [0]
    for j, src in enumerate((d - 1, d, d + 1)):
        col = np.zeros(cap, np.int32)
        if 0 <= src < n_shards:
            rpt = b.rpts[src].cpu().numpy()
            c = b.cols[src].cpu().numpy()
            col[: c.size] = c
        else:  # edge: the neighbour block is empty (zeros arrive)
            rpt = np.zeros(m_loc + 1, np.int32)
        base = j * cap
        rpt_local.extend((base + rpt[1 : m_loc + 1]).tolist())
        rpt_local.append((j + 1) * cap)  # phantom row spans the pad slots
        cols.append(col)
    col_all = np.concatenate(cols)
    return CSR(
        rpt=int32_tensor(rpt_local),
        col=torch.from_numpy(col_all),
        val=torch.zeros(col_all.size, dtype=torch.float32),
        shape=(3 * (m_loc + 1), n),
        nnz=int(rpt_local[-1]),
    )


def spgemm_halo_plan(a: PartitionedCSR, b: PartitionedCSR) -> HaloSpgemmPlan:
    """Host symbolic phase.  Every A column of shard d must fall in B row
    blocks {d-1, d, d+1} (banded A); raises ValueError otherwise.  The
    shard plans take ``spgemm_plan``'s default layout rule and go to the
    shards' devices."""
    n_shards = a.n_shards
    m_loc = a.m_loc
    bm = b.m_loc  # B's row-block size == A's column-block size
    if b.n_shards != n_shards:
        raise ValueError("A and B must use the same shard count")
    plans, b_locs = [], []
    for d in range(n_shards):
        rpt = a.rpts[d].cpu().numpy()
        nloc = a.shard_nnz[d]
        cols_d = a.cols[d][:nloc].cpu().numpy()
        lo, hi = (d - 1) * bm, (d + 2) * bm
        if nloc and (cols_d.min() < lo or cols_d.max() >= hi):
            raise ValueError(
                f"shard {d}: A columns escape the halo "
                f"[{lo}, {hi}) — use the replicated-B path"
            )
        # A columns -> local B rows (bm + 1 rows per block, the last one
        # phantom)
        rel = cols_d.astype(np.int64) - lo
        local = (rel // bm) * (bm + 1) + rel % bm
        a_loc = CSR(rpt=torch.from_numpy(rpt), col=int32_tensor(local),
                    val=torch.zeros(nloc, dtype=torch.float32),
                    shape=(m_loc, 3 * (bm + 1)), nnz=nloc)
        b_loc = _local_b_csr(b, d, n_shards)
        plans.append(spgemm_plan(a_loc, b_loc))
        b_locs.append(b_loc)
    return HaloSpgemmPlan(
        plans=plans_on_shards(plans, a),
        shape=(a.shape[0], b.shape[1]),
        m_loc=m_loc,
        c_nnz=tuple(p.c_nnz for p in plans),
        n_products=sum(p.n_products for p in plans),
        b_capacity=b.capacity,
        b_locs=tuple(b_locs),
    )


def spgemm_halo_numeric(
    plan: HaloSpgemmPlan,
    a: PartitionedCSR,
    b: PartitionedCSR,
    mesh: Mesh,
    axis: str = "x",
) -> PartitionedCSR:
    """Numeric phase: the neighbour B blocks' padded values copied to
    each shard's device into ``cat(prev, own, next)`` (zeros at the
    edges), then each shard's ``spgemm_numeric``."""
    check_mesh(mesh, a.n_shards, axis)
    cap, nd = plan.b_capacity, a.n_shards
    if b.capacity != cap:
        raise ValueError(f"plan built for B blocks of {cap} slots, got "
                         f"{b.capacity}")

    def operands(d, dev):
        bloc = torch.zeros(3 * cap, dtype=b.dtype, device=dev)
        for j, src in enumerate((d - 1, d, d + 1)):
            if 0 <= src < nd:
                v = b.vals[src]
                bloc[j * cap : j * cap + v.numel()].copy_(v)
        return (a.shard(d).to(dev),
                dataclasses.replace(plan.b_locs[d], val=bloc))

    return numeric_on_shards(plan, mesh, operands)


def spgemm_halo(
    a: PartitionedCSR, b: PartitionedCSR, mesh: Mesh, axis: str = "x",
    plan: HaloSpgemmPlan | None = None,
) -> PartitionedCSR:
    if plan is None:
        plan = spgemm_halo_plan(a, b)
    return spgemm_halo_numeric(plan, a, b, mesh, axis)


def rap_halo(
    r: PartitionedCSR,
    a: PartitionedCSR,
    p: PartitionedCSR,
    mesh: Mesh,
    axis: str = "x",
) -> PartitionedCSR:
    """Galerkin triple product R @ A @ P with every operand and the
    intermediate A·P row-sharded; all communication is neighbour halo
    copies.  Requires banded locality (raises ValueError otherwise;
    ``rap_dist`` is the general path)."""
    ap = spgemm_halo(a, p, mesh, axis)
    return spgemm_halo(r, ap, mesh, axis)

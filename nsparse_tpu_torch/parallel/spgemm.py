"""Distributed SpGEMM over a mesh (counterpart of
``nsparse_tpu/parallel/spgemm.py``).

C = A @ B with A row-sharded and B replicated: SpGEMM is row-wise
independent, so each shard runs the single-card product on its row block
and C comes out row-sharded.  Planning happens per shard on the host
(``spgemm_plan`` in the sort layout, ``shuffle=False``, as in the JAX
package); each shard keeps its own ordinary plan, on its own device, and
the numeric phase is the port's ``spgemm_numeric`` per shard, so every
shard's product runs through that layout's Hopper kernels.  The JAX
package pads and stacks the plans because ``shard_map`` needs one static
program; the stacked views here (``apos``, ``c_rpt``, ...) rebuild that
layout for comparison only.

``rap_dist`` chains the Galerkin triple product R @ A @ P: the A·P values
stay on the device, concatenated onto every shard's device as the
replicated right operand of the second product (JAX's all-gather).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from nsparse_tpu_torch.formats.csr import CSR
from nsparse_tpu_torch.ops.spgemm import (
    SpgemmPlan,
    spgemm_numeric,
    spgemm_plan,
)
from nsparse_tpu_torch.parallel.mesh import Mesh, check_mesh, replicas
from nsparse_tpu_torch.parallel.partition import (
    PartitionedCSR,
    partition_rows,
    stack_padded,
)
from nsparse_tpu_torch.utils.device import int32_tensor


@dataclasses.dataclass(frozen=True)
class PartitionedSpgemmPlan:
    """One ordinary plan per shard, shard ``d``'s on its device.

    Attributes:
      plans: D ``SpgemmPlan`` s of the (m_loc, N) row blocks.
      shape: global (M, N) of C; m_loc: rows per shard; c_nnz: nnz of
        each shard's C; n_products: intermediate products of all shards.
    """

    plans: Tuple[SpgemmPlan, ...]
    shape: Tuple[int, int]
    m_loc: int
    c_nnz: Tuple[int, ...]
    n_products: int

    @property
    def c_capacity(self) -> int:
        return max(p.c_capacity for p in self.plans)

    @property
    def flops(self) -> int:
        return 2 * self.n_products

    @property
    def c_rpt(self) -> torch.Tensor:
        """(D, m_loc + 1) stacked output row pointers."""
        return stack_padded([p.c_rpt for p in self.plans])

    @property
    def c_col(self) -> torch.Tensor:
        """(D, c_capacity) stacked output columns, zero-padded."""
        return stack_padded([p.c_col for p in self.plans])

    def _products(self, field: str, fill, sentinel=False) -> torch.Tensor:
        if any(p.srt is None for p in self.plans):
            raise ValueError("only sort-layout shard plans carry product "
                             "arrays")
        ts = [getattr(p.srt, field) for p in self.plans]
        if sentinel:  # the JAX package's padded-product sentinel: c_cap
            cap = self.c_capacity
            ts = [torch.where(t == p.c_capacity, cap, t)
                  for t, p in zip(ts, self.plans)]
        return stack_padded(ts, fill)

    @property
    def apos(self) -> torch.Tensor:
        """(D, p_pad) ``a.val`` index of each product (sort layout)."""
        return self._products("apos", 0)

    @property
    def bpos(self) -> torch.Tensor:
        """(D, p_pad) ``b.val`` index of each product (sort layout)."""
        return self._products("bpos", 0)

    @property
    def out_pos(self) -> torch.Tensor:
        """(D, p_pad) C entry of each product; pads: ``c_capacity``."""
        return self._products("out_pos", self.c_capacity, sentinel=True)


def plans_on_shards(plans, a: PartitionedCSR) -> tuple:
    """Host plans moved to their shards' devices."""
    return tuple(p.to(r.device) for p, r in zip(plans, a.rpts))


def spgemm_plan_dist(a: PartitionedCSR, b: CSR) -> PartitionedSpgemmPlan:
    """Per-shard plans (host-side symbolic phase), in the sort layout
    (``shuffle=False``, as the JAX package builds them), each moved to
    its shard's device."""
    plans = [spgemm_plan(a.shard(d), b, shuffle=False)
             for d in range(a.n_shards)]
    return PartitionedSpgemmPlan(
        plans=plans_on_shards(plans, a),
        shape=(a.shape[0], b.shape[1]),
        m_loc=a.m_loc,
        c_nnz=tuple(p.c_nnz for p in plans),
        n_products=sum(p.n_products for p in plans),
    )


def numeric_on_shards(plan, mesh: Mesh, operands) -> PartitionedCSR:
    """Shard ``d``'s ``spgemm_numeric`` on ``mesh.devices[d]``, with
    ``operands(d, device)`` its (A, B); the C shards keep their plans'
    capacities.  A plan not yet on its device is copied there."""
    rpts, cols, vals = [], [], []
    for d, dev in enumerate(mesh.devices):
        p = plan.plans[d]
        if p.c_rpt.device != dev:
            p = p.to(dev)
        c = spgemm_numeric(p, *operands(d, dev))
        rpts.append(c.rpt)
        cols.append(c.col)
        vals.append(c.val)
    return PartitionedCSR(rpts=tuple(rpts), cols=tuple(cols),
                          vals=tuple(vals), shape=plan.shape,
                          m_loc=plan.m_loc, nnz=sum(plan.c_nnz),
                          shard_nnz=tuple(plan.c_nnz))


def spgemm_numeric_dist(
    plan: PartitionedSpgemmPlan,
    a: PartitionedCSR,
    b: CSR,
    mesh: Mesh,
    axis: str = "x",
) -> PartitionedCSR:
    """Numeric phase: each shard's product through ``spgemm_numeric`` on
    its device (the sort layout: K5, K1 and K6 on a card); B is placed on
    each shard's device (no copy where it already lives)."""
    check_mesh(mesh, a.n_shards, axis)
    bs = replicas(b, mesh)
    return numeric_on_shards(plan, mesh,
                             lambda d, dev: (a.shard(d).to(dev), bs[d]))


def spgemm_dist(
    a: PartitionedCSR,
    b: CSR,
    mesh: Mesh,
    axis: str = "x",
    plan: PartitionedSpgemmPlan | None = None,
) -> PartitionedCSR:
    if plan is None:
        plan = spgemm_plan_dist(a, b)
    return spgemm_numeric_dist(plan, a, b, mesh, axis)


def gather_partitioned(c: PartitionedCSR) -> CSR:
    """Host-side gather of a row-sharded CSR back to one canonical CSR."""
    import scipy.sparse as sp

    m, n = c.shape
    rows_all, cols_all, vals_all = [], [], []
    for d in range(c.n_shards):
        rpt = c.rpts[d].cpu().numpy()
        nloc = int(rpt[-1])
        loc_rows = np.searchsorted(rpt, np.arange(nloc), side="right") - 1
        rows_all.append(loc_rows + d * c.m_loc)
        cols_all.append(c.cols[d][:nloc].cpu().numpy())
        vals_all.append(c.vals[d][:nloc].cpu().numpy())
    coo = sp.coo_matrix(
        (np.concatenate(vals_all),
         (np.concatenate(rows_all), np.concatenate(cols_all))),
        shape=(m, n),
    )
    return CSR.from_scipy(coo)


def _sharded_structure(rpt_d, col_d, c_nnz, m: int, n: int, m_loc: int):
    """Global CSR structure (host numpy) of a row-sharded product from
    its shards' symbolic ``rpt``/``col`` (a (D, ...) array or D arrays).
    The symbolic phase knows the structure on the host by design; the
    values never ride along."""
    d_n = len(rpt_d)
    offs = np.zeros(d_n + 1, np.int64)
    np.cumsum([int(c_nnz[d]) for d in range(d_n)], out=offs[1:])
    rpt = np.zeros(d_n * m_loc + 1, np.int64)
    cols = []
    for d in range(d_n):
        rpt[d * m_loc : (d + 1) * m_loc + 1] = (
            np.asarray(rpt_d[d], np.int64) + offs[d]
        )
        cols.append(np.asarray(col_d[d][: int(c_nnz[d])]))
    rpt = rpt[: m + 1]
    col = np.concatenate(cols) if cols else np.zeros(0, np.int64)
    return rpt, col, int(offs[-1])


def _numeric_fns(numeric: str):
    if numeric == "window":
        from nsparse_tpu_torch.parallel.spgemm_window import (
            spgemm_numeric_dist_window,
            spgemm_plan_dist_window,
        )

        return spgemm_plan_dist_window, spgemm_numeric_dist_window
    if numeric == "esc":
        return spgemm_plan_dist, spgemm_numeric_dist
    raise ValueError(f"unknown numeric {numeric!r}")


@dataclasses.dataclass(frozen=True)
class RapDistPlan:
    """The two products of R @ (A @ P): ``ap`` (A's shards against the
    replicated P) and ``rap`` (R's shards against the replicated A·P,
    whose structure ``ap_struct`` the symbolic phase derived; it lives on
    the first shard's device, its values zeros)."""

    ap: PartitionedSpgemmPlan
    rap: PartitionedSpgemmPlan
    ap_struct: CSR
    numeric: str


def rap_dist_plan(r: PartitionedCSR, a: PartitionedCSR, p: CSR,
                  numeric: str = "esc") -> RapDistPlan:
    """Symbolic phase of R @ A @ P (host, once per sparsity): plan A·P
    per shard, derive the global A·P structure from the shard plans'
    rpt/col (no value leaves a device), plan R·(A·P) against it."""
    plan_fn, _ = _numeric_fns(numeric)
    plan1 = plan_fn(a, p)
    rpt_ap, col_ap, nnz_ap = _sharded_structure(
        [q.c_rpt.cpu().numpy() for q in plan1.plans],
        [q.c_col.cpu().numpy() for q in plan1.plans],
        plan1.c_nnz, a.shape[0], p.shape[1], plan1.m_loc,
    )
    ap_struct = CSR(
        rpt=int32_tensor(rpt_ap),
        col=int32_tensor(col_ap),
        val=torch.zeros(nnz_ap, dtype=a.dtype),
        shape=(a.shape[0], p.shape[1]),
        nnz=nnz_ap,
    )
    plan2 = plan_fn(r, ap_struct)
    return RapDistPlan(ap=plan1, rap=plan2,
                       ap_struct=ap_struct.to(a.rpts[0].device),
                       numeric=numeric)


def rap_dist_numeric(plan: RapDistPlan, r: PartitionedCSR,
                     a: PartitionedCSR, p: CSR, mesh: Mesh,
                     axis: str = "x") -> PartitionedCSR:
    """Numeric phase of R @ A @ P with the A·P values on the devices end
    to end: each shard's first ``c_nnz[d]`` A·P values are concatenated
    on the first shard's device and placed on every shard's device (the
    all-gather), then the second product; C stays row-sharded."""
    _, num_fn = _numeric_fns(plan.numeric)
    ap_part = num_fn(plan.ap, a, p, mesh, axis)
    dev0 = mesh.devices[0]
    ap_val = torch.cat([
        v[:n].to(dev0) for v, n in zip(ap_part.vals, plan.ap.c_nnz)])
    ap_dev = dataclasses.replace(plan.ap_struct.to(dev0),
                                 val=ap_val.to(a.dtype))
    return num_fn(plan.rap, r, ap_dev, mesh, axis)


def rap_dist_parts(
    r: CSR,
    a: CSR,
    p: CSR,
    mesh: Mesh,
    axis: str = "x",
    numeric: str = "esc",
) -> PartitionedCSR:
    """R @ A @ P with the intermediate A·P values kept on the devices:
    the shards of R and A on the mesh, :func:`rap_dist_plan`, then
    :func:`rap_dist_numeric`.  ``numeric="window"`` takes both products
    through the dist window plans (``parallel/spgemm_window.py``)."""
    n_shards = mesh.size
    a_part = partition_rows(a, n_shards, mesh=mesh)
    r_part = partition_rows(r, n_shards, mesh=mesh)
    plan = rap_dist_plan(r_part, a_part, p, numeric)
    return rap_dist_numeric(plan, r_part, a_part, p, mesh, axis)


def rap_dist(
    r: CSR,
    a: CSR,
    p: CSR,
    mesh: Mesh,
    axis: str = "x",
    numeric: str = "esc",
) -> CSR:
    """Galerkin triple product R @ A @ P over the mesh; the intermediate
    A·P stays on the devices (:func:`rap_dist_parts`), only the result is
    gathered to the host."""
    return gather_partitioned(
        rap_dist_parts(r, a, p, mesh, axis, numeric=numeric)
    )

"""The distributed layer of the port (counterpart of
``nsparse_tpu/parallel``): row-sharded SpMV and SpGEMM, halo exchange
and the R·A·P Galerkin product over a mesh of devices, one process
driving every shard (``mesh.py``).  Every shard's SpGEMM is the port's
single-card ``spgemm_numeric``, so it runs through the Hopper kernels of
its plan's layout."""

from nsparse_tpu_torch.parallel.mesh import Mesh, make_mesh
from nsparse_tpu_torch.parallel.partition import (
    PartitionedCSR,
    partition_rows,
)
from nsparse_tpu_torch.parallel.spmv import spmv_dist
from nsparse_tpu_torch.parallel.spgemm import (
    PartitionedSpgemmPlan,
    RapDistPlan,
    gather_partitioned,
    rap_dist,
    rap_dist_numeric,
    rap_dist_parts,
    rap_dist_plan,
    spgemm_dist,
    spgemm_numeric_dist,
    spgemm_plan_dist,
)
from nsparse_tpu_torch.parallel.halo import (
    BandedPartitionedCSR,
    partition_banded,
    shard_x,
    spmv_halo,
)
from nsparse_tpu_torch.parallel.spgemm_halo import (
    HaloSpgemmPlan,
    rap_halo,
    spgemm_halo,
    spgemm_halo_plan,
)
from nsparse_tpu_torch.parallel.spgemm_window import (
    DistWindowPlan,
    spgemm_numeric_dist_window,
    spgemm_plan_dist_window,
)

__all__ = [
    "make_mesh",
    "PartitionedCSR",
    "partition_rows",
    "spmv_dist",
    "spgemm_dist",
    "rap_dist",
    "gather_partitioned",
    "BandedPartitionedCSR",
    "partition_banded",
    "shard_x",
    "spmv_halo",
    "HaloSpgemmPlan",
    "rap_halo",
    "spgemm_halo",
    "spgemm_halo_plan",
    "DistWindowPlan",
    "spgemm_plan_dist_window",
    "spgemm_numeric_dist_window",
    # the port's additions
    "Mesh",
    "PartitionedSpgemmPlan",
    "RapDistPlan",
    "rap_dist_numeric",
    "rap_dist_parts",
    "rap_dist_plan",
    "spgemm_numeric_dist",
    "spgemm_plan_dist",
]

from nsparse_tpu_torch.ops.binning import bin_rows, flops_per_row
from nsparse_tpu_torch.ops.spgemm import (
    SpgemmPlan,
    spgemm,
    spgemm_flops,
    spgemm_numeric,
    spgemm_plan,
)
from nsparse_tpu_torch.ops.spmv import spmv, spmv_bsr, spmv_csr, spmv_ell

__all__ = [
    "SpgemmPlan",
    "bin_rows",
    "flops_per_row",
    "spgemm",
    "spgemm_flops",
    "spgemm_numeric",
    "spgemm_plan",
    "spmv",
    "spmv_bsr",
    "spmv_csr",
    "spmv_ell",
]

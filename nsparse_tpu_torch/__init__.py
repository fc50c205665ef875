"""nsparse_tpu_torch — the PyTorch / CUDA port of nsparse_tpu.

The JAX package ``nsparse_tpu`` is the reference; this package imports
``torch`` and never ``jax``.  Ported so far: the SpGEMM main path (the
host symbolic plan, window layout, and the window numeric phase) and the
SpMV path (CSR, COO, ELL, DIA and BSR formats, the semirings, the
``spmv`` dispatch and its tuner).  Their eight kernels are hand-written
CUDA for Hopper (``csrc/``) beside their plain PyTorch versions.
"""

from nsparse_tpu_torch.formats.bsr import BSR
from nsparse_tpu_torch.formats.coo import COO
from nsparse_tpu_torch.formats.csr import CSR
from nsparse_tpu_torch.formats.dia import DIA
from nsparse_tpu_torch.formats.ell import ELL
from nsparse_tpu_torch.io.generate import (
    fem_block_csr,
    random_csr,
    rmat_csr,
    stencil_csr,
)
from nsparse_tpu_torch.io.matrix_market import read_mtx
from nsparse_tpu_torch.ops.spgemm import (
    SpgemmPlan,
    spgemm,
    spgemm_flops,
    spgemm_numeric,
    spgemm_numeric_segsum,
    spgemm_plan,
)
from nsparse_tpu_torch.ops.spmv import spmm, spmv
from nsparse_tpu_torch.tune.autotune import autotune_spmv
from nsparse_tpu_torch.utils.checking import (
    ans_check,
    check_spgemm_answer,
    spgemm_abs_oracle,
    spgemm_oracle,
    spmv_abs_oracle,
    spmv_oracle,
)

__all__ = [
    "BSR",
    "COO",
    "CSR",
    "DIA",
    "ELL",
    "SpgemmPlan",
    "ans_check",
    "autotune_spmv",
    "check_spgemm_answer",
    "fem_block_csr",
    "random_csr",
    "read_mtx",
    "rmat_csr",
    "spgemm",
    "spgemm_abs_oracle",
    "spgemm_flops",
    "spgemm_numeric",
    "spgemm_numeric_segsum",
    "spgemm_oracle",
    "spgemm_plan",
    "spmm",
    "spmv",
    "spmv_abs_oracle",
    "spmv_oracle",
    "stencil_csr",
]

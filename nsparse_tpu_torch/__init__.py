"""nsparse_tpu_torch — the PyTorch / CUDA port of nsparse_tpu.

The JAX package ``nsparse_tpu`` is the reference; this package imports
``torch`` and never ``jax``.  Ported so far: the SpGEMM main path — the
host symbolic plan (window layout) and the window numeric phase, whose
four kernels are hand-written CUDA for Hopper (``csrc/``) beside their
plain PyTorch versions.
"""

from nsparse_tpu_torch.formats.csr import CSR
from nsparse_tpu_torch.io.generate import rmat_csr, stencil_csr
from nsparse_tpu_torch.io.matrix_market import read_mtx
from nsparse_tpu_torch.ops.spgemm import (
    SpgemmPlan,
    spgemm,
    spgemm_flops,
    spgemm_numeric,
    spgemm_numeric_segsum,
    spgemm_plan,
)
from nsparse_tpu_torch.utils.checking import (
    check_spgemm_answer,
    spgemm_abs_oracle,
    spgemm_oracle,
)

__all__ = [
    "CSR",
    "SpgemmPlan",
    "check_spgemm_answer",
    "read_mtx",
    "rmat_csr",
    "spgemm",
    "spgemm_abs_oracle",
    "spgemm_flops",
    "spgemm_numeric",
    "spgemm_numeric_segsum",
    "spgemm_oracle",
    "spgemm_plan",
    "stencil_csr",
]

"""nsparse_tpu_torch — the PyTorch / CUDA port of nsparse_tpu.

The JAX package ``nsparse_tpu`` is the reference; this package imports
``torch`` and never ``jax``.  Ported so far: ESC SpGEMM (the host plan in
its three layouts: row-localized windows, the global slab and the sort
layout; the one-shot device planner; their numeric phases; the plan
cache, ``tune/spgemm_cache.py``; without a plan on a card, the hash
SpGEMM, ``spgemm``'s default there), the
block-sparse SpGEMM path (``spgemm_bsr``, ``spgemm(..., method="bsr" |
"auto")``), the SpMV path (CSR, COO, ELL, DIA and BSR formats, the
semirings, the ``spmv`` dispatch and its tuner), Matrix Market reading
and writing, the SuiteSparse fetcher, row binning, checking, timing and
profiling utilities, the CLI, and the distributed layer
(``nsparse_tpu_torch.parallel``: row-sharded SpMV and SpGEMM, halo
exchange and R·A·P over a mesh of devices; ``rap`` is R·A·P on one
device).  Their kernels are hand-written CUDA
for Hopper, thirteen sources in ``csrc/`` (K1-K12, with K2's piece and
flat modes and K4's K-fold mode, each beside its plain PyTorch version;
and the hash SpGEMM, whose plain counterpart is the device planner's
path).
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
from nsparse_tpu_torch.io.matrix_market import read_mtx, write_mtx
from nsparse_tpu_torch.ops.spgemm import (
    SpgemmPlan,
    rap,
    spgemm,
    spgemm_flops,
    spgemm_numeric,
    spgemm_numeric_segsum,
    spgemm_plan,
    spgemm_plan_device,
    spgemm_symbolic_nnz,
)
from nsparse_tpu_torch.ops.spgemm_bsr import (
    BsrSpgemmPlan,
    block_stats,
    choose_spgemm_path,
    plan_spgemm_bsr,
    spgemm_bsr,
    spgemm_bsr_numeric,
)
from nsparse_tpu_torch.ops.spmv import (
    spmm,
    spmm_bsr,
    spmm_csr,
    spmv,
    spmv_csr,
    spmv_dia,
    spmv_ell,
)
from nsparse_tpu_torch.tune.autotune import autotune_spmv
from nsparse_tpu_torch.tune.plan import Plan
from nsparse_tpu_torch.utils.checking import (
    ans_check,
    check_spgemm_answer,
    spgemm_abs_oracle,
    spgemm_oracle,
    spmv_abs_oracle,
    spmv_oracle,
)
from nsparse_tpu_torch.utils.hostmem import tune_host_memory

tune_host_memory()  # transparent hugepages off: faster plan builds

__all__ = [
    "BSR",
    "BsrSpgemmPlan",
    "COO",
    "CSR",
    "DIA",
    "ELL",
    "Plan",
    "SpgemmPlan",
    "ans_check",
    "autotune_spmv",
    "block_stats",
    "check_spgemm_answer",
    "choose_spgemm_path",
    "fem_block_csr",
    "plan_spgemm_bsr",
    "random_csr",
    "rap",
    "read_mtx",
    "rmat_csr",
    "spgemm",
    "spgemm_abs_oracle",
    "spgemm_bsr",
    "spgemm_bsr_numeric",
    "spgemm_flops",
    "spgemm_numeric",
    "spgemm_numeric_segsum",
    "spgemm_oracle",
    "spgemm_plan",
    "spgemm_plan_device",
    "spgemm_symbolic_nnz",
    "spmm",
    "spmm_bsr",
    "spmm_csr",
    "spmv",
    "spmv_abs_oracle",
    "spmv_csr",
    "spmv_dia",
    "spmv_ell",
    "spmv_oracle",
    "stencil_csr",
    "write_mtx",
]

from nsparse_tpu_torch.utils.checking import (
    ans_check,
    ans_check_device,
    check_spgemm_answer,
    check_spgemm_answer_device,
    csr_allclose,
    spgemm_oracle,
    spmv_oracle,
)
from nsparse_tpu_torch.utils.roofline import chip_specs, spmv_roofline_gflops

__all__ = [
    "ans_check",
    "ans_check_device",
    "check_spgemm_answer",
    "check_spgemm_answer_device",
    "chip_specs",
    "csr_allclose",
    "spgemm_oracle",
    "spmv_oracle",
    "spmv_roofline_gflops",
]

from nsparse_tpu_torch.formats.bsr import BSR
from nsparse_tpu_torch.formats.coo import COO
from nsparse_tpu_torch.formats.csr import CSR
from nsparse_tpu_torch.formats.dia import DIA
from nsparse_tpu_torch.formats.ell import ELL

__all__ = ["BSR", "COO", "CSR", "DIA", "ELL"]

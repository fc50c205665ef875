from nsparse_tpu_torch.io.generate import rmat_csr, stencil_csr
from nsparse_tpu_torch.io.matrix_market import read_mtx

__all__ = ["read_mtx", "rmat_csr", "stencil_csr"]

from nsparse_tpu_torch.io.generate import (
    fem_block_csr,
    random_csr,
    rmat_csr,
    stencil_csr,
)
from nsparse_tpu_torch.io.matrix_market import (
    read_mtx,
    read_mtx_coo,
    write_mtx,
)

__all__ = [
    "fem_block_csr",
    "random_csr",
    "read_mtx",
    "read_mtx_coo",
    "rmat_csr",
    "stencil_csr",
    "write_mtx",
]

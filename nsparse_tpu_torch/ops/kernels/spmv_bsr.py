"""BSR SpMV over (128, 128) tiles, kernel K8 (counterpart of
``nsparse_tpu/ops/kernels/spmv_pallas.py``)."""

from __future__ import annotations

import torch

from nsparse_tpu_torch.formats.bsr import BSR
from nsparse_tpu_torch.ops.kernels import cuda_lib

PB = 128  # the kernel's tile edge


def spmv_bsr_plain(a: BSR, x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K8, any blocksize (the JAX XLA path: per
    tile a dense (br, bc) @ (bc,) product, then a sum per block row).

    The tile products are an elementwise multiply and a sum, not a
    matmul, so they stay in full precision whatever the caller's TF32
    setting (JAX runs them at ``Precision.HIGHEST``)."""
    br, bc = a.blocksize
    n = a.shape[1]
    nbc = (n + bc - 1) // bc
    xp = torch.nn.functional.pad(x.to(a.dtype), (0, nbc * bc - n))
    xg = xp.reshape(nbc, bc)[a.block_col.long()]
    yb = (a.data * xg[:, None, :]).sum(dim=-1)
    y = torch.zeros(a.n_block_rows, br, dtype=a.dtype, device=a.data.device)
    y.index_add_(0, a.block_row.long(), yb)
    return y.reshape(-1)[: a.shape[0]]


def spmv_bsr(a: BSR, x: torch.Tensor) -> torch.Tensor:
    """K8: y = A @ x for a BSR with (128, 128) tiles.

    CPU tensors take :func:`spmv_bsr_plain`; CUDA tensors launch the
    kernel (``csrc/spmv_bsr.cu``) or raise.
    """
    if a.blocksize != (PB, PB):
        raise ValueError(f"spmv_bsr needs (128, 128) tiles, got {a.blocksize}")
    if x.dtype != a.dtype:
        raise TypeError(f"spmv_bsr: x is {x.dtype}, values {a.dtype}")
    if a.data.device.type == "cpu":
        return spmv_bsr_plain(a, x)
    m, n = a.shape
    if a.n_block_rows * PB < m or tuple(a.data.shape[1:]) != (PB, PB) \
            or a.block_col.numel() != a.nblocks:
        raise ValueError("spmv_bsr: tiles, block columns and block rows "
                         "do not match the shape")
    y = torch.empty(m, dtype=a.dtype, device=x.device)
    if m:
        cuda_lib.launch("spmv_bsr", "nsp_spmv_bsr", a.data, a.block_col,
                        a.block_rpt, a.n_block_rows, x, n, y, m)
        spmv_bsr.launches += 1
    else:
        cuda_lib.validate("spmv_bsr", a.data, a.block_col, a.block_rpt, x)
    return y


spmv_bsr.launches = 0

"""Block-sparse SpGEMM tile products, kernel K9 (counterpart of
``nsparse_tpu/ops/spgemm_bsr.py``'s ``spgemm_bsr_blocks``)."""

from __future__ import annotations

import torch

from nsparse_tpu_torch.ops.kernels import cuda_lib
from nsparse_tpu_torch.utils.device import highest_matmul_precision

# the kernel's C sub-tile edges: 128 x 128 where bs allows it, else 64 x
# 64, so bs must be a multiple of SUB
SUB = 64


def spgemm_bsr_blocks_plain(a_blocks: torch.Tensor, b_blocks: torch.Tensor,
                            pair_a: torch.Tensor, pair_b: torch.Tensor,
                            pair_c: torch.Tensor,
                            c_pair_start: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K9 (the JAX XLA formulation): a batched
    product of the gathered tiles, then a sum per C tile.  The product
    runs in full float32 whatever the caller's TF32 setting, as JAX runs
    it at ``Precision.HIGHEST``."""
    n_c = int(c_pair_start.numel()) - 1
    bs = int(a_blocks.shape[-1])
    with highest_matmul_precision():
        prods = torch.bmm(a_blocks[pair_a.long()], b_blocks[pair_b.long()])
    c = torch.zeros(n_c, bs, bs, dtype=a_blocks.dtype,
                    device=a_blocks.device)
    return c.index_add_(0, pair_c.long(), prods)


def spgemm_bsr_blocks(a_blocks: torch.Tensor, b_blocks: torch.Tensor,
                      pair_a: torch.Tensor, pair_b: torch.Tensor,
                      pair_c: torch.Tensor,
                      c_pair_start: torch.Tensor) -> torch.Tensor:
    """K9: the (n_c, bs, bs) C tiles, tile ``t`` the sum over its pairs
    ``p`` in ``[c_pair_start[t], c_pair_start[t+1])`` of
    ``a_blocks[pair_a[p]] @ b_blocks[pair_b[p]]``; ``pair_c`` is
    non-decreasing and ``c_pair_start`` its (n_c + 1,) run starts.

    CPU tensors take :func:`spgemm_bsr_blocks_plain`; CUDA tensors launch
    the kernel (``csrc/spgemm_bsr.cu``) or raise.
    """
    if a_blocks.dtype != b_blocks.dtype:
        raise TypeError("spgemm_bsr_blocks: A and B tiles must share a dtype")
    bs = int(a_blocks.shape[-1])
    if a_blocks.dim() != 3 or tuple(a_blocks.shape[1:]) != (bs, bs) \
            or tuple(b_blocks.shape[1:]) != (bs, bs):
        raise ValueError("spgemm_bsr_blocks: tiles must be (n, bs, bs)")
    n_pairs = int(pair_a.numel())
    if pair_b.numel() != n_pairs or pair_c.numel() != n_pairs:
        raise ValueError("spgemm_bsr_blocks: pair arrays differ in length")
    if a_blocks.device.type == "cpu":
        return spgemm_bsr_blocks_plain(a_blocks, b_blocks, pair_a, pair_b,
                                       pair_c, c_pair_start)
    if bs % SUB:
        raise ValueError(f"spgemm_bsr_blocks: the kernel needs bs a multiple "
                         f"of {SUB}, got {bs}")
    n_c = int(c_pair_start.numel()) - 1
    c = torch.empty(n_c, bs, bs, dtype=a_blocks.dtype,
                    device=a_blocks.device)
    args = (a_blocks, b_blocks, pair_a, pair_b, c_pair_start)
    if not (n_c and n_pairs):
        cuda_lib.validate("spgemm_bsr_blocks", *args, c)
        return c.zero_()
    # the kernel stages tiles with 16-byte copies
    if any(t.data_ptr() % 16 for t in (a_blocks, b_blocks)):
        raise ValueError("spgemm_bsr_blocks: tiles must start 16-byte "
                         "aligned")
    cuda_lib.launch("spgemm_bsr_blocks", "nsp_spgemm_bsr", *args, n_c, bs, c)
    spgemm_bsr_blocks.launches += 1
    return c


spgemm_bsr_blocks.launches = 0

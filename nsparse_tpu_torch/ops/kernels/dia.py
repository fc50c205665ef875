"""DIA SpMV, kernel K7 (counterpart of
``nsparse_tpu/ops/kernels/dia_pallas.py``).

``y[i] = sum_d vals[d, i] * x[i + off_d]`` for ``i < m``; terms reading
outside x contribute 0.  The TPU kernel needs ``max|off| < span`` and f32
because of its sliding-window blocks and its custom call; K7 has neither
limit.
"""

from __future__ import annotations

import torch

from nsparse_tpu_torch.ops.kernels import cuda_lib


def spmv_dia_plain(vals: torch.Tensor, offsets, x: torch.Tensor,
                   m: int) -> torch.Tensor:
    """Plain PyTorch version of K7 (the JAX XLA path: pad x, then one
    shifted slice, multiply and add per diagonal, in order)."""
    mp = vals.shape[1]
    n = x.numel()
    lo = min(0, min(offsets, default=0))
    hi = max(0, max(offsets, default=0))
    xp = torch.nn.functional.pad(
        x.to(vals.dtype), (-lo, hi + max(mp - m, 0) + max(m - n, 0)))
    y = torch.zeros(mp, dtype=vals.dtype, device=vals.device)
    for d, off in enumerate(offsets):
        y = y + vals[d] * xp[off - lo: off - lo + mp]
    return y[:m]


def spmv_dia(vals: torch.Tensor, offsets, x: torch.Tensor, m: int,
             off_t: torch.Tensor | None = None) -> torch.Tensor:
    """K7: y = A @ x for DIA arrays ``vals`` (ndiag, Mp) and ``offsets``.

    ``off_t``: the offsets as an int32 tensor on the card (built here
    when not given).  CPU tensors take :func:`spmv_dia_plain`; CUDA
    tensors launch the kernel (``csrc/spmv_dia.cu``) or raise.
    """
    if x.dtype != vals.dtype:
        raise TypeError(f"spmv_dia: x is {x.dtype}, values {vals.dtype}")
    if vals.dim() != 2 or vals.shape[0] != len(offsets) or vals.shape[1] < m:
        raise ValueError("spmv_dia: vals must be (len(offsets), >= m)")
    if vals.device.type == "cpu":
        return spmv_dia_plain(vals, offsets, x, m)
    if off_t is None:
        off_t = torch.tensor(offsets, dtype=torch.int32, device=vals.device)
    if off_t.numel() != len(offsets) or off_t.dtype != torch.int32:
        raise ValueError("spmv_dia: off_t must hold the offsets as int32")
    y = torch.empty(m, dtype=vals.dtype, device=vals.device)
    if m:
        cuda_lib.launch("spmv_dia", "nsp_spmv_dia", vals, vals.shape[1],
                        off_t, len(offsets), x, x.numel(), y, m)
        spmv_dia.launches += 1
    else:
        cuda_lib.validate("spmv_dia", vals, off_t, x)
    return y


spmv_dia.launches = 0

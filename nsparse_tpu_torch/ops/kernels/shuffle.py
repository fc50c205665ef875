"""Planned permutations in index form, and kernel K1 (gather).

Counterpart of ``nsparse_tpu/ops/kernels/shuffle_pallas.py``.  The JAX
package routes each permutation into Benes/slack-Clos masks because the
TPU has no vector gather; it keeps plain gather indices only off the TPU
(the fallback branch of ``build_shuffle_plan``).  The port keeps only that
index form: one gather moves each element once.  The per-tile permutation
(``tile_benes_apply``) is read by K3 itself, through
``FusedClassPlan.tile_idx``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from nsparse_tpu_torch.ops.kernels import cuda_lib
from nsparse_tpu_torch.utils.device import to_device


@dataclasses.dataclass(frozen=True)
class ShufflePlan:
    """``out[i] = x[idx[i]]`` for a plan-known permutation.

    Attributes:
      idx: (n,) int32 source per output (outside ``x`` = zero fill).
      n: output length.
    """

    idx: torch.Tensor
    n: int

    def to(self, device) -> "ShufflePlan":
        return to_device(self, device)


def build_shuffle_plan(src: np.ndarray, n_src: int | None = None) -> ShufflePlan:
    """Index plan for ``out[i] = x[src[i]]``.

    ``n_src``: the length of the array the plan will read; sources at or
    past it become -1 (zero fill).  The JAX package relies on the routed
    network's zero padding there, and its index form on XLA clamping.
    """
    src = np.asarray(src, dtype=np.int64).reshape(-1)
    if n_src is not None:
        src = np.where(src < n_src, src, -1)
    if src.size and src.max(initial=-1) >= 2**31:
        raise ValueError("shuffle source index exceeds int32")
    return ShufflePlan(idx=torch.from_numpy(src.astype(np.int32)), n=src.size)


def gather_plain(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K1."""
    n_x = x.numel()
    if n_x == 0:
        return torch.zeros(idx.shape, dtype=x.dtype, device=x.device)
    idx = idx.long()
    valid = (idx >= 0) & (idx < n_x)
    return torch.where(valid, x[idx.clamp(0, n_x - 1)], 0)


def gather(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """K1: ``out[i] = x[idx[i]]``, 0 where ``idx[i]`` is outside ``x``.

    CPU tensors take :func:`gather_plain`; CUDA tensors launch the kernel
    (``csrc/gather.cu``) or raise.
    """
    if x.device.type == "cpu":
        return gather_plain(x, idx)
    out = torch.empty(idx.numel(), dtype=x.dtype, device=x.device)
    if out.numel():
        cuda_lib.launch("gather", "nsp_gather", x, x.numel(), idx, out,
                        out.numel())
        gather.launches += 1
    else:
        cuda_lib.validate("gather", x, idx, out)
    return out


gather.launches = 0


def planned_shuffle(plan: ShufflePlan, x: torch.Tensor) -> torch.Tensor:
    """``out[i] = x[src[i]]`` for the planned permutation (K1)."""
    return gather(x, plan.idx)


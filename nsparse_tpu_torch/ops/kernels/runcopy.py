"""Fixed-destination run copy, and kernel K4 (runcopy).

Counterpart of ``nsparse_tpu/ops/kernels/runcopy.py`` in its
fixed-destination mode: copy plan-listed contiguous source runs to their
destinations and zero every other output slot.  The JAX package cuts the
runs into phase-matched (8, 128) pieces for the TPU; the port keeps the
run descriptors themselves.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from nsparse_tpu_torch.ops.kernels import cuda_lib
from nsparse_tpu_torch.utils.device import int32_tensor as t
from nsparse_tpu_torch.utils.device import to_device

TILE = 1024  # output length granule, as in the JAX plan


@dataclasses.dataclass(frozen=True)
class RunCopyPlan:
    """``out[dst[r]:dst[r]+len[r]] = src[src_off[r]:src_off[r]+len[r]]``.

    Attributes:
      src_off, dst, len: (n_runs,) int32 run descriptors, ascending
        disjoint destinations.
      n_src: source length the plan reads; n_out: output length.
    """

    src_off: torch.Tensor
    dst: torch.Tensor
    len: torch.Tensor
    n_src: int
    n_out: int

    @property
    def n_runs(self) -> int:
        return int(self.dst.shape[0])

    def to(self, device) -> "RunCopyPlan":
        return to_device(self, device)


def build_runcopy_plan(src_off, lens, n_src: int, dst,
                       n_out: int | None = None) -> RunCopyPlan:
    """Check and pack fixed-destination runs; ``n_out`` (default: the end
    of the last run) is rounded up to a multiple of TILE.  Destinations
    must ascend without overlap and every run must lie inside both the
    source and the output."""
    src_off = np.asarray(src_off, dtype=np.int64).reshape(-1)
    lens = np.asarray(lens, dtype=np.int64).reshape(-1)
    dst = np.asarray(dst, dtype=np.int64).reshape(-1)
    if n_out is None:
        n_out = int((dst + lens).max()) if dst.size else 0
    n_out = -(-int(n_out) // TILE) * TILE
    if max(n_out, n_src) >= 2**31:
        raise ValueError("run copy exceeds int32")
    if not (lens >= 0).all():
        raise ValueError("negative run length")
    if not (np.diff(dst) >= lens[:-1]).all():
        raise ValueError("fixed dst must be ascending and non-overlapping")
    if dst.size and not (
        (src_off >= 0).all() and (src_off + lens <= n_src).all()
        and (dst >= 0).all() and (dst + lens <= n_out).all()
    ):
        raise ValueError("run outside the source or the output")

    return RunCopyPlan(
        src_off=t(src_off), dst=t(dst), len=t(lens), n_src=int(n_src),
        n_out=int(n_out),
    )


def runcopy_plain(plan: RunCopyPlan, src: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K4."""
    dev = src.device
    out = torch.zeros(plan.n_out, dtype=src.dtype, device=dev)
    lens = plan.len.long()
    total = int(lens.sum())
    if total:
        rid = torch.repeat_interleave(
            torch.arange(plan.n_runs, device=dev), lens, output_size=total
        )
        first = torch.cumsum(lens, 0) - lens
        kin = torch.arange(total, device=dev) - first[rid]
        out[plan.dst.long()[rid] + kin] = src[plan.src_off.long()[rid] + kin]
    return out


def runcopy(plan: RunCopyPlan, src: torch.Tensor) -> torch.Tensor:
    """K4: the (n_out,) destination array from the flat source.

    CPU tensors take :func:`runcopy_plain`; CUDA tensors launch the kernel
    (``csrc/runcopy.cu``) or raise.
    """
    if src.numel() < plan.n_src:
        raise ValueError(f"source of {src.numel()} < plan's {plan.n_src}")
    if src.device.type == "cpu":
        return runcopy_plain(plan, src)
    cuda_lib.require_cuda("runcopy", src, plan.src_off, plan.dst, plan.len)
    out = torch.empty(plan.n_out, dtype=src.dtype, device=src.device)
    if plan.n_out:
        fn = cuda_lib.entry("nsp_runcopy", src.dtype)
        with torch.cuda.device(src.device):
            rc = fn(
                cuda_lib.ptr(src), cuda_lib.ptr(plan.src_off),
                cuda_lib.ptr(plan.dst), cuda_lib.ptr(plan.len), plan.n_runs,
                cuda_lib.ptr(out), plan.n_out, cuda_lib.stream(src),
            )
        cuda_lib.check(rc, "runcopy")
        runcopy.launches += 1
    return out


runcopy.launches = 0

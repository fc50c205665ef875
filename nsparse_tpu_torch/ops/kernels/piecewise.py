"""Product expansion from run descriptors, and kernel K2 (expand).

Counterpart of ``nsparse_tpu/ops/kernels/piecewise.py``.  In the window
arena every slot belongs to one run: an A entry's run holds
``a.val[e] * b.val[b_start:b_start + live_len]`` followed by zero padding
up to its 8-aligned length, and gap runs (window slack, padding windows)
hold zeros.  The JAX package reads B through an 8-aligned copy of
``b.val`` (and, on the TPU, a pre-rolled bank of it); the port reads
``b.val`` directly, so a run is just ``(start, b_start, live_len, aidx)``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from nsparse_tpu_torch.ops.kernels import cuda_lib
from nsparse_tpu_torch.utils.device import int32_tensor as t
from nsparse_tpu_torch.utils.device import to_device


@dataclasses.dataclass(frozen=True)
class ExpandPlan:
    """Runs tiling the product arena ``[0, n)``.

    Attributes:
      run_start: (n_runs + 1,) int32 ascending run starts; the last entry
        is ``n``.
      b_start: (n_runs,) int32 first ``b.val`` index of each run.
      live_len: (n_runs,) int32 products in the run (the rest is zero).
      aidx: (n_runs,) int32 ``a.val`` index (``nnz_a`` for gap runs).
      n, nnz_a, nnz_b: arena length and the value-array sizes the plan
        was built for.
    """

    run_start: torch.Tensor
    b_start: torch.Tensor
    live_len: torch.Tensor
    aidx: torch.Tensor
    n: int
    nnz_a: int
    nnz_b: int

    @property
    def n_runs(self) -> int:
        return int(self.b_start.shape[0])

    def to(self, device) -> "ExpandPlan":
        return to_device(self, device)


def build_expand_plan(run_start, b_start, live_len, aidx, n: int,
                      nnz_a: int, nnz_b: int) -> ExpandPlan:
    """Check the runs and pack them.  The runs must tile ``[0, n)`` in
    ascending order, each live range must fit its run and lie inside
    ``b.val``, and gap runs (``aidx == nnz_a``) must hold no products."""
    run_start = np.asarray(run_start, dtype=np.int64)
    b_start = np.asarray(b_start, dtype=np.int64)
    live_len = np.asarray(live_len, dtype=np.int64)
    aidx = np.asarray(aidx, dtype=np.int64)
    bounds = np.concatenate([run_start, [n]])
    run_len = np.diff(bounds)
    if n >= 2**31:
        raise ValueError("product arena exceeds int32")
    if run_start.size and run_start[0] != 0:
        raise ValueError("expansion runs must start at 0")
    if not (run_len > 0).all():
        raise ValueError("expansion runs must be ascending and non-empty")
    if not ((live_len >= 0) & (live_len <= run_len)).all():
        raise ValueError("expansion run live length exceeds the run")
    if not ((b_start >= 0) & (b_start + live_len <= nnz_b)).all():
        raise ValueError("expansion run reads past b.val")
    if not ((aidx >= 0) & (aidx <= nnz_a)).all():
        raise ValueError("expansion run A index out of range")
    if (live_len[aidx == nnz_a] > 0).any():
        raise ValueError("gap run with live products")

    return ExpandPlan(
        run_start=t(bounds), b_start=t(b_start), live_len=t(live_len),
        aidx=t(aidx), n=int(n), nnz_a=int(nnz_a), nnz_b=int(nnz_b),
    )


def _check_values(plan: ExpandPlan, a_val: torch.Tensor, b_val: torch.Tensor):
    if a_val.numel() < plan.nnz_a or b_val.numel() < plan.nnz_b:
        raise ValueError("value arrays shorter than the plan's nnz")
    if a_val.dtype != b_val.dtype:
        raise TypeError("a.val and b.val must share a dtype")


def expand_plain(plan: ExpandPlan, a_val: torch.Tensor,
                 b_val: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K2."""
    _check_values(plan, a_val, b_val)
    dev = a_val.device
    if plan.n == 0 or plan.nnz_a == 0 or plan.nnz_b == 0:
        return torch.zeros(plan.n, dtype=a_val.dtype, device=dev)
    starts = plan.run_start.long()
    rid = torch.repeat_interleave(
        torch.arange(plan.n_runs, device=dev), starts.diff(),
        output_size=plan.n,
    )
    local = torch.arange(plan.n, device=dev) - starts[rid]
    live = local < plan.live_len.long()[rid]
    bi = (plan.b_start.long()[rid] + local).clamp(0, plan.nnz_b - 1)
    ai = plan.aidx.long()[rid].clamp(0, plan.nnz_a - 1)
    return torch.where(live, a_val[ai] * b_val[bi], 0)


def piecewise_expand(plan: ExpandPlan, a_val: torch.Tensor,
                     b_val: torch.Tensor) -> torch.Tensor:
    """K2: the (n,) product arena for these values (any values, same
    sparsity — the numeric re-run contract).

    CPU tensors take :func:`expand_plain`; CUDA tensors launch the kernel
    (``csrc/expand.cu``) or raise.
    """
    if a_val.device.type == "cpu":
        return expand_plain(plan, a_val, b_val)
    _check_values(plan, a_val, b_val)
    cuda_lib.require_cuda(
        "piecewise_expand", a_val, b_val, plan.run_start, plan.b_start,
        plan.live_len, plan.aidx,
    )
    out = torch.empty(plan.n, dtype=a_val.dtype, device=a_val.device)
    if plan.n_runs:
        fn = cuda_lib.entry("nsp_expand", a_val.dtype)
        with torch.cuda.device(a_val.device):
            rc = fn(
                cuda_lib.ptr(a_val), cuda_lib.ptr(b_val),
                cuda_lib.ptr(plan.run_start), cuda_lib.ptr(plan.b_start),
                cuda_lib.ptr(plan.live_len), cuda_lib.ptr(plan.aidx),
                plan.n_runs, cuda_lib.ptr(out), cuda_lib.stream(a_val),
            )
        cuda_lib.check(rc, "piecewise_expand")
        piecewise_expand.launches += 1
    return out


piecewise_expand.launches = 0

"""Plan-listed run copies, and kernel K4 (runcopy) in its two modes.

Counterpart of ``nsparse_tpu/ops/kernels/runcopy.py``:

- fixed destinations (the window merge): copy plan-listed contiguous
  source runs to their destinations and zero every other output slot;
- K-fold (the JAX package's variable mode, ``build_runcopy_plan(kfac=,
  stride=)`` without ``dst``): run r writes ``out[dst_r + p] = sum_{t <
  K_r} src[S_r + t * stride_r + p]``, K in {1, 2, 4, 8}, at destinations
  chosen as the JAX package chooses them.  No path of either package
  calls it (only the JAX package's tests and ``chip_smoke.py``).

The JAX package cuts the runs into phase-matched (8, 128) pieces for the
TPU; the port keeps the run descriptors themselves.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from nsparse_tpu_torch.ops.kernels import cuda_lib
from nsparse_tpu_torch.utils.device import int32_tensor as t
from nsparse_tpu_torch.utils.device import to_device

TILE = 1024  # output length granule, as in the JAX plan
LANES = 128  # the K = 1 destination phase granule of the JAX plan
K_FACTORS = (1, 2, 4, 8)
J_MAX = {1: 8, 2: 4, 4: 4, 8: 4}  # the JAX plan's runs per subtile


@dataclasses.dataclass(frozen=True)
class RunCopyPlan:
    """``out[dst[r]:dst[r]+len[r]] = src[src_off[r]:src_off[r]+len[r]]``,
    or in the K-fold mode the sum of ``kfac[r]`` such source runs
    ``stride[r]`` apart.

    Attributes:
      src_off, dst, len: (n_runs,) int32 run descriptors, ascending
        disjoint destinations.
      kfac, stride: (n_runs,) int32 fold factors and sub-run strides of
        the K-fold mode; None in the fixed mode.
      n_src: source length the plan reads; n_out: output length.
    """

    src_off: torch.Tensor
    dst: torch.Tensor
    len: torch.Tensor
    n_src: int
    n_out: int
    kfac: torch.Tensor | None = None
    stride: torch.Tensor | None = None

    @property
    def n_runs(self) -> int:
        return int(self.dst.shape[0])

    def to(self, device) -> "RunCopyPlan":
        return to_device(self, device)


def _kfold_destinations(src_off, lens, kfac) -> tuple[np.ndarray, int]:
    """The JAX package's destination assignment: runs packed in order, a
    change of K starting a fresh 8-subtile supertile, K = 1 runs
    phase-matched to their source (``dst = src_off mod 128``), at most
    ``J_MAX[K]`` runs starting per subtile.  Returns (dst, n_out)."""
    dst = np.empty(src_off.size, dtype=np.int64)
    cursor = tile_cnt = tile_id = 0
    prev_k = int(kfac[0]) if kfac.size else 1
    for r in range(src_off.size):
        k = int(kfac[r])
        if k != prev_k:  # fresh supertile: uniform K per grid step
            cursor = -(-cursor // (8 * TILE)) * 8 * TILE
            tile_id, tile_cnt, prev_k = cursor // TILE, 0, k
        d = cursor + (src_off[r] - cursor) % LANES if k == 1 else cursor
        sub = d // TILE
        cnt = tile_cnt if sub == tile_id else 0
        if cnt >= J_MAX[k]:  # subtile full: skip to the next
            d = (sub + 1) * TILE + (src_off[r] % LANES if k == 1 else 0)
            sub, cnt = d // TILE, 0
        dst[r] = d
        cursor = d + lens[r]
        tile_id = cursor // TILE
        tile_cnt = cnt + 1 if tile_id == sub else 1
    return dst, -(-int(cursor) // TILE) * TILE


def build_runcopy_plan(src_off, lens, n_src: int, dst=None,
                       n_out: int | None = None, kfac=None, stride=None):
    """Check and pack runs.

    With ``dst`` (the fixed mode) returns the plan: ``n_out`` (default:
    the end of the last run) is rounded up to a multiple of TILE, and
    destinations must ascend without overlap.  Without it (the K-fold
    mode, ``kfac`` default 1 and ``stride`` default 0 per run; runs
    grouped by ``kfac``) returns ``(plan, dst)``, the destinations
    assigned as the JAX package assigns them.  Every run must lie inside
    the source and the output.
    """
    src_off = np.asarray(src_off, dtype=np.int64).reshape(-1)
    lens = np.asarray(lens, dtype=np.int64).reshape(-1)
    kfold = dst is None
    if kfold:
        kfac = (np.ones(src_off.size, np.int64) if kfac is None
                else np.asarray(kfac, dtype=np.int64).reshape(-1))
        stride = (np.zeros(src_off.size, np.int64) if stride is None
                  else np.asarray(stride, dtype=np.int64).reshape(-1))
        if not np.isin(kfac, K_FACTORS).all():
            raise ValueError(f"fold factors must be in {K_FACTORS}")
        if kfac.size and np.unique(kfac).size != 1 + int(
                (np.diff(kfac) != 0).sum()):
            raise ValueError("K-fold runs must be grouped by fold factor")
        if (stride < 0).any():
            raise ValueError("negative sub-run stride")
        dst, n_out = _kfold_destinations(src_off, lens, kfac)
        reach = src_off + (kfac - 1) * stride
    elif kfac is not None or stride is not None:
        raise ValueError("fixed destinations take no fold factors")
    else:
        dst = np.asarray(dst, dtype=np.int64).reshape(-1)
        if n_out is None:
            n_out = int((dst + lens).max()) if dst.size else 0
        reach = src_off
    n_out = -(-int(n_out) // TILE) * TILE
    if max(n_out, n_src) >= 2**31:
        raise ValueError("run copy exceeds int32")
    if not (lens >= 0).all():
        raise ValueError("negative run length")
    if not (np.diff(dst) >= lens[:-1]).all():
        raise ValueError("fixed dst must be ascending and non-overlapping")
    if dst.size and not (
        (src_off >= 0).all() and (reach + lens <= n_src).all()
        and (dst >= 0).all() and (dst + lens <= n_out).all()
    ):
        raise ValueError("run outside the source or the output")

    plan = RunCopyPlan(
        src_off=t(src_off), dst=t(dst), len=t(lens), n_src=int(n_src),
        n_out=int(n_out),
    )
    if not kfold:
        return plan
    return dataclasses.replace(plan, kfac=t(kfac), stride=t(stride)), dst


def _run_slots(plan: RunCopyPlan, dev):
    """(run id, offset in the run) of every covered output slot."""
    lens = plan.len.long()
    total = int(lens.sum())
    rid = torch.repeat_interleave(
        torch.arange(plan.n_runs, device=dev), lens, output_size=total)
    return rid, torch.arange(total, device=dev) - (lens.cumsum(0) - lens)[rid]


def runcopy_plain(plan: RunCopyPlan, src: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K4's fixed mode."""
    out = torch.zeros(plan.n_out, dtype=src.dtype, device=src.device)
    rid, kin = _run_slots(plan, src.device)
    out[plan.dst.long()[rid] + kin] = src[plan.src_off.long()[rid] + kin]
    return out


def runcopy_kfold_plain(plan: RunCopyPlan, src: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K4's K-fold mode: the K terms added in t
    order, as the kernel adds them."""
    out = torch.zeros(plan.n_out, dtype=src.dtype, device=src.device)
    rid, kin = _run_slots(plan, src.device)
    base = plan.src_off.long()[rid] + kin
    kf, step = plan.kfac.long()[rid], plan.stride.long()[rid]
    acc = torch.zeros(kin.numel(), dtype=src.dtype, device=src.device)
    for k in range(max(K_FACTORS)):
        acc += torch.where(kf > k, src[(base + k * step).clamp(
            max=max(src.numel() - 1, 0))], 0)
    out[plan.dst.long()[rid] + kin] = acc
    return out


def runcopy(plan: RunCopyPlan, src: torch.Tensor) -> torch.Tensor:
    """K4: the (n_out,) destination array from the flat source (a K-fold
    plan takes :func:`runcopy_kfold`).

    CPU tensors take :func:`runcopy_plain`; CUDA tensors launch the kernel
    (``csrc/runcopy.cu``) or raise.
    """
    if plan.kfac is not None:
        return runcopy_kfold(plan, src)
    if src.numel() < plan.n_src:
        raise ValueError(f"source of {src.numel()} < plan's {plan.n_src}")
    if src.device.type == "cpu":
        return runcopy_plain(plan, src)
    out = torch.empty(plan.n_out, dtype=src.dtype, device=src.device)
    if plan.n_out:
        cuda_lib.launch("runcopy", "nsp_runcopy", src, plan.src_off,
                        plan.dst, plan.len, plan.n_runs, out, plan.n_out)
        runcopy.launches += 1
    else:
        cuda_lib.validate("runcopy", src, plan.src_off, plan.dst, plan.len)
    return out


runcopy.launches = 0


def runcopy_kfold(plan: RunCopyPlan, src: torch.Tensor) -> torch.Tensor:
    """K4's K-fold mode: ``out[dst_r + p] = sum_{t < K_r} src[S_r + t *
    stride_r + p]`` for ``p < len_r``, 0 elsewhere; float32 only (the sum
    is arithmetic; the JAX package raises for float64 too).

    CPU tensors take :func:`runcopy_kfold_plain`; CUDA tensors launch the
    kernel (``csrc/runcopy.cu``) or raise.
    """
    if plan.kfac is None:
        raise ValueError("a fixed-destination plan has no fold factors")
    if src.dtype != torch.float32:
        raise NotImplementedError(
            f"the K-fold run copy sums in float32 only, got {src.dtype}")
    if src.numel() < plan.n_src:
        raise ValueError(f"source of {src.numel()} < plan's {plan.n_src}")
    if src.device.type == "cpu":
        return runcopy_kfold_plain(plan, src)
    out = torch.empty(plan.n_out, dtype=src.dtype, device=src.device)
    if plan.n_out:
        cuda_lib.launch("runcopy_kfold", "nsp_runcopy_kfold", src,
                        plan.src_off, plan.dst, plan.len, plan.kfac,
                        plan.stride, plan.n_runs, out, plan.n_out)
        runcopy_kfold.launches += 1
    return out


runcopy_kfold.launches = 0

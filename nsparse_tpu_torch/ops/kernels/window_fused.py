"""Fused window reduction of one width class, and kernel K3.

Counterpart of ``nsparse_tpu/ops/kernels/window_fused.py`` in its v1 form,
together with the per-class tile permutation that feeds it there
(``shuffle_pallas.tile_benes_apply``).  Per window of W slots: read the
products into fold slots through the tile permutation, fold ``lv``
levels, run the radix-8 tiers (gather the arena ``[F_prev | zeros]``,
fold 3 levels), then write each slot's entry total,
``out[i] = P[ext[entry[i]]]``, where P is the window's levels laid end to
end.  The semantics are the JAX package's ``_fused_reference``; the port
stores every index window-local (the JAX plan's are global), which lets
one CUDA block own one window.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Tuple

import numpy as np
import torch

from nsparse_tpu_torch.ops.kernels import cuda_lib
from nsparse_tpu_torch.utils.device import int32_tensor as t
from nsparse_tpu_torch.utils.device import to_device

MAX_TIERS = 8  # the kernel's tier table (csrc/fused_class.cu)


def level_widths(w: int, lv: int, tier_vs) -> Tuple[int, ...]:
    """Widths of a window's levels: F0, F1..F_lv, then 3 per tier."""
    out = [w] + [w >> k for k in range(1, lv + 1)]
    for v in tier_vs:
        out += [v >> 1, v >> 2, v >> 3]
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class FusedClassPlan:
    """One width class of the fused window reduction.

    Attributes:
      tile_idx: (slots,) int32 window-local product feeding each fold slot.
      tier_idx: (sum_t n_win * V_t,) int32; per tier, per window, the
        window-local source in ``[F_prev | zeros]`` of each arena slot.
      ext_idx: (slots,) int32 window-local level-pyramid index of each E
        slot's total (-1 = zero).
      entry_idx: (slots,) int32 window-local E slot of each output slot.
      w: window width; slots: class slots (``n_win * w``); lv: fold levels
        before the tiers; tier_vs: tier arena widths.
    """

    tile_idx: torch.Tensor
    tier_idx: torch.Tensor
    ext_idx: torch.Tensor
    entry_idx: torch.Tensor
    w: int
    slots: int
    lv: int
    tier_vs: Tuple[int, ...]

    @property
    def n_win(self) -> int:
        return self.slots // self.w

    @property
    def pyr_len(self) -> int:
        return sum(level_widths(self.w, self.lv, self.tier_vs))

    def to(self, device) -> "FusedClassPlan":
        return to_device(self, device)


def build_fused_plan(w: int, slots: int, lv: int, tier_vs, tile_idx, tier_idx,
                     ext_idx, entry_idx) -> FusedClassPlan:
    """Check the window-local tables and pack them.

    ``tier_idx`` is a list of per-tier (n_win * V,) arrays.  Every index
    must stay inside its window: tile and entry slots in ``[0, w)``, tier
    sources in ``[0, V)``, pyramid indices in ``[0, pyr_len)`` (or -1).
    """
    tier_vs = tuple(int(v) for v in tier_vs)
    n_win = slots // w
    if slots % w:
        raise ValueError(f"{slots} class slots not a multiple of {w}")
    if len(tier_vs) > MAX_TIERS:
        raise ValueError(f"{len(tier_vs)} tiers exceed {MAX_TIERS}")
    width = w >> lv
    for v, idx in zip(tier_vs, tier_idx):
        if v != 2 * width:
            raise ValueError(f"tier arena {v} does not double width {width}")
        if np.asarray(idx).shape != (n_win * v,):
            raise ValueError("tier index table has the wrong length")
        width = v >> 3
    pyr_len = sum(level_widths(w, lv, tier_vs))
    checks = [(np.asarray(i), 0, v) for i, v in zip(tier_idx, tier_vs)]
    per_slot = [(np.asarray(tile_idx), 0, w),
                (np.asarray(ext_idx), -1, pyr_len),
                (np.asarray(entry_idx), 0, w)]
    if any(arr.shape != (slots,) for arr, _, _ in per_slot):
        raise ValueError("tile/ext/entry tables must have one index per slot")
    for arr, lo, hi in checks + per_slot:
        if arr.size and not ((arr >= lo) & (arr < hi)).all():
            raise ValueError("fused-class index is not window-local")

    cat = np.concatenate(tier_idx) if tier_idx else np.zeros(0, np.int32)
    return FusedClassPlan(
        tile_idx=t(tile_idx), tier_idx=t(cat), ext_idx=t(ext_idx),
        entry_idx=t(entry_idx), w=int(w), slots=int(slots), lv=int(lv),
        tier_vs=tier_vs,
    )


def fused_class_plain(plan: FusedClassPlan, x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K3 (the JAX tile permutation and
    ``_fused_reference``, with window-local indices)."""
    n_win, w = plan.n_win, plan.w
    tile = plan.tile_idx.reshape(n_win, w).long()
    cur = torch.gather(x[: plan.slots].reshape(n_win, w), 1, tile)
    levels = [cur]
    for k in range(1, plan.lv + 1):
        half = w >> k
        cur = cur[:, :half] + cur[:, half:]
        levels.append(cur)
    off = 0
    for v in plan.tier_vs:
        idx = plan.tier_idx[off : off + n_win * v].reshape(n_win, v).long()
        off += n_win * v
        cur = torch.gather(torch.cat([cur, torch.zeros_like(cur)], 1), 1, idx)
        for k in (1, 2, 3):
            half = v >> k
            cur = cur[:, :half] + cur[:, half:]
            levels.append(cur)
    pyr = torch.cat(levels, 1)
    ext = plan.ext_idx.reshape(n_win, w).long()
    src = torch.gather(ext, 1, plan.entry_idx.reshape(n_win, w).long())
    out = torch.where(src >= 0, torch.gather(pyr, 1, src.clamp(min=0)), 0)
    return out.reshape(-1)


def fused_class_apply(plan: FusedClassPlan, x: torch.Tensor) -> torch.Tensor:
    """K3: the (slots,) entry-ordered class arena from the class's
    products ``x``, in arena order.

    CPU tensors take :func:`fused_class_plain`; CUDA tensors launch the
    kernel (``csrc/fused_class.cu``) or raise.
    """
    if x.numel() < plan.slots:
        raise ValueError(f"{x.numel()} products for {plan.slots} slots")
    if x.device.type == "cpu":
        return fused_class_plain(plan, x)
    x = x[: plan.slots]
    cuda_lib.require_cuda(
        "fused_class_apply", x, plan.tile_idx, plan.tier_idx, plan.ext_idx,
        plan.entry_idx,
    )
    out = torch.empty(plan.slots, dtype=x.dtype, device=x.device)
    if not plan.slots:
        return out
    with torch.cuda.device(x.device):
        smem = plan.pyr_len * x.element_size()
        scratch = None
        if smem > cuda_lib.max_smem_optin(x.device.index):
            scratch = torch.empty(
                plan.n_win * plan.pyr_len, dtype=x.dtype, device=x.device
            )
        vs = (ctypes.c_int * max(len(plan.tier_vs), 1))(*plan.tier_vs)
        rc = cuda_lib.entry("nsp_fused_class", x.dtype)(
            cuda_lib.ptr(x), cuda_lib.ptr(out), cuda_lib.ptr(plan.tile_idx),
            cuda_lib.ptr(plan.ext_idx), cuda_lib.ptr(plan.entry_idx),
            cuda_lib.ptr(plan.tier_idx),
            plan.n_win, plan.w, plan.lv, len(plan.tier_vs), vs,
            None if scratch is None else cuda_lib.ptr(scratch),
            plan.pyr_len, cuda_lib.stream(x),
        )
    cuda_lib.check(rc, "fused_class_apply")
    fused_class_apply.launches += 1
    return out


fused_class_apply.launches = 0

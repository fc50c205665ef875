"""Planned flat gather: class subsets through one K5 launch, fallback
tiles via K1 and K6.

Counterpart of ``nsparse_tpu/ops/kernels/flat_gather.py``.  The host
planner routes each (8, 128) tile of a fixed index array exactly as the
JAX planner does (same ``idx2d``, ``ids``, ``bases``, ``fb_ids`` and
``classes``):

- ``("band", D)``: a (128, 128) supertile whose ``idx - position`` spans
  < D;
- ``("win", W)``: a supertile of WIN_SUB (8, 128) subtiles whose indices
  each span < W;
- fallback: the remaining tiles, gathered outside any class kernel (K1)
  and patched in with K6.

On the TPU the classes pick the roll-scan kernel's cost; on Hopper every
class is the same gather, so ``flat_gather`` launches K5 once over the
units of all classes (``FlatGatherPlan.units``, WIN_UNIT slots each, in
class order), where the JAX package launches one kernel per class.  The
class ladder and the fallback route are kept for parity with the JAX
plans.  f64 moves natively (the JAX two-plane route exists because a TPU
custom call cannot carry f64).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from nsparse_tpu_torch.ops.kernels.gather_tiles import (
    gather_subset,
    scatter_tiles,
)
from nsparse_tpu_torch.ops.kernels.shuffle import gather
from nsparse_tpu_torch.tune.kernelgen import (
    BAND_TILE_ROWS,
    GATHER_CLASSES,
    WIN_SUB,
    WIN_TILE_ROWS,
)
from nsparse_tpu_torch.utils.device import int32_tensor, to_device

LANES = 128
TILE = WIN_TILE_ROWS * LANES       # (8, 128) tile: 1024 slots
SUPER = BAND_TILE_ROWS * LANES     # band supertile: 16384 slots
WIN_UNIT = WIN_SUB * TILE          # window supertile: 8192 slots


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


@dataclasses.dataclass(frozen=True)
class FlatGatherPlan:
    """Precomputed routing for :func:`flat_gather` over a fixed index array.

    Attributes:
      idx2d: (T, 128) int32 indices, padded with -1 to whole supertiles.
      ids: per-class unit ids (band: supertiles of SUPER slots; window:
        supertiles of WIN_UNIT slots), parallel to ``classes``.
      bases: per-class bases (one per band supertile, one per (8, 128)
        subtile of a window supertile) — the window each unit reads.  No
        kernel reads them yet, so they stay on the host through ``to()``.
      fb_ids: (8, 128) tiles that no class covers.
      fb_idx: (len(fb_ids) * 1024,) int32 indices of those tiles, in
        order, and fb_pos their flat slot positions (both derived).
      units: int32 ids of every class unit in WIN_UNIT-slot units, classes
        in order (band supertile i is units 2i and 2i + 1): the list
        that one K5 launch gathers (derived).
      classes: (kind, param) per subset.
      n: true index count.
    """

    idx2d: torch.Tensor
    ids: Tuple[torch.Tensor, ...]
    bases: Tuple[torch.Tensor, ...] = dataclasses.field(
        metadata={"host": True})
    fb_ids: torch.Tensor
    fb_idx: torch.Tensor
    fb_pos: torch.Tensor
    units: torch.Tensor
    classes: Tuple[Tuple[str, int], ...]
    n: int

    @classmethod
    def from_numpy(cls, idx2d, ids, bases, fb_ids, classes, n
                   ) -> "FlatGatherPlan":
        """From host arrays (a JAX plan's fields, or the planner's); every
        unit must lie inside ``idx2d``, which the kernels rely on."""
        idx2d = np.ascontiguousarray(idx2d, dtype=np.int32)
        fb_ids = np.asarray(fb_ids, dtype=np.int32)
        n_slots = idx2d.size
        if n_slots % SUPER or n > n_slots:
            raise ValueError("idx2d must be whole supertiles covering n")
        units = [np.zeros(0, np.int64)]  # in WIN_UNIT units, class order
        for (kind, _), i in zip(classes, ids):
            per = SUPER // WIN_UNIT if kind == "band" else 1
            i = np.asarray(i, np.int64).reshape(-1)
            if i.size and not 0 <= i.min() <= i.max() < \
                    n_slots // (per * WIN_UNIT):
                raise ValueError(f"{kind} unit id outside the index array")
            units.append((i[:, None] * per + np.arange(per)).reshape(-1))
        if fb_ids.size and not 0 <= fb_ids.min() <= fb_ids.max() < \
                n_slots // TILE:
            raise ValueError("fallback tile id outside the index array")
        pos = (fb_ids[:, None].astype(np.int64) * TILE
               + np.arange(TILE)).reshape(-1)
        return cls(
            idx2d=int32_tensor(idx2d),
            ids=tuple(int32_tensor(i) for i in ids),
            bases=tuple(int32_tensor(b) for b in bases),
            fb_ids=int32_tensor(fb_ids),
            fb_idx=int32_tensor(idx2d.reshape(-1)[pos]),
            fb_pos=int32_tensor(pos),
            units=int32_tensor(np.concatenate(units)),
            classes=tuple((str(k), int(p)) for k, p in classes),
            n=int(n),
        )

    @property
    def n_tiles(self) -> int:
        return int(self.idx2d.shape[0]) // WIN_TILE_ROWS

    @property
    def class_fracs(self):
        t = max(self.n_tiles, 1)
        out = {}
        for (k, p), i in zip(self.classes, self.ids):
            mult = SUPER // TILE if k == "band" else WIN_SUB
            out[f"{k}{p}"] = int(i.shape[0]) * mult / t
        out["fallback"] = int(self.fb_ids.shape[0]) / t
        return out

    def to(self, device) -> "FlatGatherPlan":
        return to_device(self, device)


def build_flat_gather_plan(idx: np.ndarray, classes=None) -> FlatGatherPlan:
    """Host-side: route each (8, 128) tile of ``idx`` to its cheapest
    class (``classes`` defaults to ``kernelgen.GATHER_CLASSES``).  Index
    -1 is a sentinel slot that gathers 0."""
    if classes is None:
        classes = GATHER_CLASSES
    for kind, param in classes:
        if kind != "band" and (param < LANES or param % LANES):
            raise ValueError(
                f"window class {param} must be a multiple of {LANES}")
    idx = np.asarray(idx, dtype=np.int32).reshape(-1)
    n = idx.size
    np_pad = _round_up(max(n, 1), SUPER)
    idxp = np.full(np_pad, -1, dtype=np.int32)
    idxp[:n] = idx
    # sentinel slots are excluded from every span
    valid = (np.arange(np_pad, dtype=np.int64) < n) & (idxp >= 0)

    def masked_span(arr2d, mask2d):
        big = np.int64(1) << 60
        lo = np.where(mask2d, arr2d, big).min(axis=1)
        hi = np.where(mask2d, arr2d, -big).max(axis=1)
        return lo, hi

    # band classes at supertile granularity: d = idx - flat position
    s2 = idxp.reshape(-1, SUPER).astype(np.int64)
    v2 = valid.reshape(-1, SUPER)
    dlo, dhi = masked_span(s2 - np.arange(SUPER, dtype=np.int64)[None, :], v2)
    any_valid_super = v2.any(axis=1)

    super_assigned = ~any_valid_super  # all-sentinel supertiles: skipped
    ids, bases = [], []
    band_classes = [(k, p) for k, p in classes if k == "band"]
    win_classes = [(k, p) for k, p in classes if k != "band"]
    for _, param in band_classes:
        ok = (~super_assigned) & any_valid_super & (dhi - dlo < param) \
            & (dlo >= 0)
        super_assigned |= ok
        ids.append(np.nonzero(ok)[0].astype(np.int32))
        bases.append(dlo[ok].astype(np.int32))

    # window classes at WIN_SUB-tile granularity, one base per subtile; a
    # supertile takes the smallest class covering all its valid subtiles
    t3 = idxp.reshape(-1, TILE).astype(np.int64)
    v3 = valid.reshape(-1, TILE)
    tile_open = np.repeat(~super_assigned & any_valid_super, SUPER // TILE)
    tile_has = v3.any(axis=1)
    lo, hi = masked_span(t3, v3)
    span = np.where(tile_has, hi - lo, 0)
    base_tile = np.where(tile_has, lo, 0).astype(np.int64)

    ws2 = span.reshape(-1, WIN_SUB)
    wopen2 = tile_open.reshape(-1, WIN_SUB)
    whas2 = tile_has.reshape(-1, WIN_SUB)
    w_open = wopen2.any(axis=1) & whas2.any(axis=1)
    w_span = np.where(whas2, ws2, 0).max(axis=1)
    w_assigned = ~w_open
    for _, param in win_classes:
        ok = (~w_assigned) & (w_span < param)
        w_assigned |= ok
        ids.append(np.nonzero(ok)[0].astype(np.int32))
        bases.append(
            base_tile.reshape(-1, WIN_SUB)[ok].reshape(-1).astype(np.int32))
    covered = np.repeat(w_assigned & w_open, WIN_SUB) | ~tile_open
    fb_ids = np.nonzero(~covered & tile_has)[0].astype(np.int32)

    return FlatGatherPlan.from_numpy(
        idxp.reshape(-1, LANES), ids, bases, fb_ids,
        tuple(band_classes) + tuple(win_classes), n)


def flat_gather(plan: FlatGatherPlan, src: torch.Tensor,
                other: torch.Tensor | None = None) -> torch.Tensor:
    """``out[i] = src[idx[i]]`` (0 for sentinel indices), times
    ``other[i]`` when given; returns flat (n,).

    The units of every class subset are one K5 launch; the fallback
    tiles are gathered with K1 (and multiplied by ``other`` there) and
    patched in by K6.
    """
    t = int(plan.idx2d.shape[0])
    out = torch.zeros(t * LANES, dtype=src.dtype, device=src.device)
    if plan.units.numel():
        gather_subset(src, plan.idx2d.reshape(-1), plan.units, WIN_UNIT, out,
                      other)
    if plan.fb_ids.numel():
        vals = gather(src, plan.fb_idx)
        if other is not None:
            vals = vals * gather(other, plan.fb_pos)
        scatter_tiles(out, plan.fb_ids, vals, TILE)
    return out[: plan.n]

"""Fused window reduction of one width class, and kernel K3.

Counterpart of ``nsparse_tpu/ops/kernels/window_fused.py``, together with
the per-class tile permutation that feeds it there
(``shuffle_pallas.tile_benes_apply``).  Per window of W slots: place the
products into fold slots through the tile permutation, fold ``lv``
levels, run the radix-8 tiers (gather the arena ``[F_prev | zeros]``,
fold 3 levels), then write each slot's entry total,
``out[i] = P[ext[entry[i]]]``, where P is the window's levels laid end to
end.  The semantics are the JAX package's ``_fused_reference``; the port
stores every index window-local (the JAX plan's are global), which lets
one CUDA block own one window.

Two modes, as in the JAX package:
- v1: the products arrive in arena order (``x``) and F0 reads them
  through the tile permutation, ``F0[i] = x[tile[i]]``;
- v2 (``plan.expand``): the kernel forms the products itself from the
  pre-rolled B bank (``piecewise.build_bank``) and per-piece A values:
  slot p of arena subtile s takes ``bank[eboff * 128 + p] * apv`` from
  the piece of s with ``cut <= p < end``.  The kernel writes each product
  straight to its fold slot through the inverse permutation
  (``tile_inv``, a table derived on the host), so the window's products
  never reach device memory.

The kernel reads the extraction as one table composed on the host,
``pyr_dst``: for each pyramid value, the output slot that reads it (-1:
none); the plan keeps ``ext_idx`` and ``entry_idx`` as the JAX plan
holds them.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import NamedTuple, Tuple

import numpy as np
import torch

from nsparse_tpu_torch.ops.kernels import cuda_lib
from nsparse_tpu_torch.ops.kernels.piecewise import BANK_K, LANES, TILE
from nsparse_tpu_torch.utils.device import int32_tensor as t
from nsparse_tpu_torch.utils.device import to_device

MAX_WIDTH = 32768   # the kernel's int16 output slots (csrc/fused_class.cu)


def level_widths(w: int, lv: int, tier_vs) -> Tuple[int, ...]:
    """Widths of a window's levels: F0, F1..F_lv, then 3 per tier."""
    out = [w] + [w >> k for k in range(1, lv + 1)]
    for v in tier_vs:
        out += [v >> 1, v >> 2, v >> 3]
    return tuple(out)


class ClassPieces(NamedTuple):
    """The v2 expansion tables of one class, as the JAX planner builds them
    (its SMEM reshape undone).

    etrips: (n_sub, 2) each arena subtile's pieces ``[lo, hi)``, counted
      within its step's region: a step is ``blk`` slots (``blk / 1024``
      subtiles), and step i's region is entries ``[i * j2_cap, (i + 1) *
      j2_cap)`` of the piece tables;
    ecuts / eboffs / eends: (n_steps * j2_cap,) each piece's slots
      ``[cut, end)`` within its subtile and its bank-row code;
    apv_lo / apv_hi: the class's slice of the per-piece A values;
    bank_rows: the bank the codes index.
    """

    etrips: np.ndarray
    ecuts: np.ndarray
    eboffs: np.ndarray
    eends: np.ndarray
    j2_cap: int
    blk: int
    apv_lo: int
    apv_hi: int
    bank_rows: int


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
      pyr_dst: (n_win * pyr_len,) int16, per window and pyramid value, the
        window-local output slot whose ``ext_idx[entry_idx[i]]`` names it
        (-1: no slot reads it) — the extraction the kernel runs, derived.
      w: window width; slots: class slots (``n_win * w``); lv: fold levels
        before the tiers; tier_vs: tier arena widths.
      v2 only (None / 0 in v1): ``tile_inv`` (slots,) int32, the fold slot
        of each window-local product (the inverse of ``tile_idx``,
        derived), and the :class:`ClassPieces` tables ``etrips`` (n_sub,
        2), ``ecuts``,
        ``eboffs``, ``eends``, with ``j2_cap``, ``blk``, ``apv_lo``,
        ``apv_hi`` and ``bank_rows``; ``esub`` (n_steps * j2_cap,) int32,
        each piece's window-local subtile (derived; 0 for table pads).

    The kernel stores no pyramid, so no class takes global scratch: a
    window whose F0 does not fit a cluster of 8 blocks' shared memory is
    refused at launch.
    """

    tile_idx: torch.Tensor
    tier_idx: torch.Tensor
    ext_idx: torch.Tensor
    entry_idx: torch.Tensor
    pyr_dst: torch.Tensor
    w: int
    slots: int
    lv: int
    tier_vs: Tuple[int, ...]
    tile_inv: torch.Tensor | None = None
    etrips: torch.Tensor | None = None
    ecuts: torch.Tensor | None = None
    eboffs: torch.Tensor | None = None
    eends: torch.Tensor | None = None
    esub: torch.Tensor | None = None
    j2_cap: int = 0
    blk: int = 0
    apv_lo: int = 0
    apv_hi: int = 0
    bank_rows: int = 0

    @property
    def n_win(self) -> int:
        return self.slots // self.w

    @property
    def pyr_len(self) -> int:
        return sum(level_widths(self.w, self.lv, self.tier_vs))

    @property
    def expand(self) -> bool:
        """v2: the kernel expands the products itself."""
        return self.etrips is not None

    def to(self, device) -> "FusedClassPlan":
        return to_device(self, device)


def _check_pieces(pc: ClassPieces, w: int, slots: int) -> np.ndarray:
    """The v2 tables of a class: each subtile's pieces lie inside its
    step's region, ascend and do not overlap, ``0 <= cut <= end <= 1024``,
    every piece with slots reads rows inside the bank, and a window's
    subtiles hold consecutive pieces (the kernel walks a window's pieces
    as one range).  Returns each table entry's window-local subtile
    (``esub``; 0 for entries no subtile holds)."""
    n_sub = slots // TILE
    if w % TILE or pc.blk % w or slots % pc.blk:
        raise ValueError(f"steps of {pc.blk} slots do not tile windows of "
                         f"{w} in {slots} slots")
    n_steps = slots // pc.blk
    size = n_steps * pc.j2_cap
    if np.asarray(pc.etrips).shape != (n_sub, 2) or any(
            np.asarray(a).shape != (size,)
            for a in (pc.ecuts, pc.eboffs, pc.eends)):
        raise ValueError("v2 piece tables have the wrong shape")
    if pc.apv_hi - pc.apv_lo != size:
        raise ValueError("the A-value slice does not match the piece tables")
    lo = np.asarray(pc.etrips[:, 0], np.int64)
    hi = np.asarray(pc.etrips[:, 1], np.int64)
    if not ((lo >= 0) & (lo <= hi) & (hi <= pc.j2_cap)).all():
        raise ValueError("v2 pieces leave their step's region")
    cnt = hi - lo
    s = np.repeat(np.arange(n_sub, dtype=np.int64), cnt)
    k = np.arange(int(cnt.sum()), dtype=np.int64) - np.repeat(
        np.cumsum(cnt) - cnt, cnt)
    pj = (s // (pc.blk // TILE)) * pc.j2_cap + lo[s] + k
    cut = np.asarray(pc.ecuts, np.int64)[pj]
    end = np.asarray(pc.eends, np.int64)[pj]
    code = np.asarray(pc.eboffs, np.int64)[pj]
    if not ((cut >= 0) & (cut <= end) & (end <= TILE)).all():
        raise ValueError("v2 piece range outside its subtile")
    nxt = np.flatnonzero(s[1:] == s[:-1])
    if (cut[nxt + 1] < end[nxt]).any():
        raise ValueError("v2 pieces of a subtile overlap or descend")
    used = cut < end
    if not ((code[used] >= 0) & (code[used] * LANES + end[used]
                                 <= BANK_K * pc.bank_rows * LANES)).all():
        raise ValueError("v2 piece reads a bank row outside the bank")
    n_sub_w = w // TILE
    inner = np.flatnonzero(np.arange(1, n_sub) % n_sub_w != 0)
    if (lo[inner + 1] != hi[inner]).any():
        raise ValueError("v2 pieces of a window's subtiles are not "
                         "consecutive")
    esub = np.zeros(size, np.int64)
    esub[pj] = s % n_sub_w
    return esub


def build_fused_plan(w: int, slots: int, lv: int, tier_vs, tile_idx, tier_idx,
                     ext_idx, entry_idx,
                     pieces: ClassPieces | None = None) -> FusedClassPlan:
    """Check the window-local tables and pack them.

    ``tier_idx`` is a list of per-tier (n_win * V,) arrays.  Every index
    must stay inside its window: tile and entry slots in ``[0, w)``, tier
    sources in ``[0, V)``, pyramid indices in ``[0, pyr_len)`` (or -1).
    ``pieces`` makes a v2 plan: its tables are checked, and the tile
    permutation must be one in every window (its inverse is derived).
    No two output slots may read one pyramid value (``pyr_dst``, the
    composed extraction, is derived), and ``w`` is at most MAX_WIDTH.
    """
    tier_vs = tuple(int(v) for v in tier_vs)
    n_win = slots // w
    if slots % w:
        raise ValueError(f"{slots} class slots not a multiple of {w}")
    if w > MAX_WIDTH:
        raise ValueError(f"windows of {w} slots exceed {MAX_WIDTH}")
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

    v2 = {}
    if pieces is not None:
        esub = _check_pieces(pieces, w, slots)
        tile = np.asarray(tile_idx, np.int64)
        win0 = np.arange(slots, dtype=np.int64) // w * w
        inv = np.full(slots, -1, np.int64)
        inv[win0 + tile] = np.arange(slots, dtype=np.int64) - win0
        if (inv < 0).any():
            raise ValueError("v2 tile table is not a permutation per window")
        v2 = dict(
            tile_inv=t(inv), etrips=t(pieces.etrips), ecuts=t(pieces.ecuts),
            eboffs=t(pieces.eboffs), eends=t(pieces.eends), esub=t(esub),
            j2_cap=int(pieces.j2_cap), blk=int(pieces.blk),
            apv_lo=int(pieces.apv_lo), apv_hi=int(pieces.apv_hi),
            bank_rows=int(pieces.bank_rows),
        )
    cat = np.concatenate(tier_idx) if tier_idx else np.zeros(0, np.int32)
    return FusedClassPlan(
        tile_idx=t(tile_idx), tier_idx=t(cat), ext_idx=t(ext_idx),
        entry_idx=t(entry_idx),
        pyr_dst=_pyr_dst(np.asarray(ext_idx, np.int64),
                         np.asarray(entry_idx, np.int64), w, slots, pyr_len),
        w=int(w), slots=int(slots), lv=int(lv), tier_vs=tier_vs, **v2,
    )


def _pyr_dst(ext: np.ndarray, entry: np.ndarray, w: int, slots: int,
             pyr_len: int) -> torch.Tensor:
    """The composed extraction, inverted: per window and pyramid value,
    the output slot i with ``ext[entry[i]]`` equal to it, else -1."""
    win = np.arange(slots, dtype=np.int64) // w
    src = ext[win * w + entry]
    read = src >= 0
    key = win[read] * pyr_len + src[read]
    dst = np.full(slots // w * pyr_len, -1, np.int16)
    dst[key] = (np.arange(slots, dtype=np.int64) - win * w)[read]
    if np.count_nonzero(dst >= 0) != key.size:
        raise ValueError("two output slots read one pyramid value")
    return torch.from_numpy(dst)


def _reduce_plain(plan: FusedClassPlan, cur: torch.Tensor) -> torch.Tensor:
    """Folds, tiers and extraction from the (n_win, w) fold slots F0."""
    n_win, w = plan.n_win, plan.w
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
    dst = plan.pyr_dst.reshape(n_win, -1).long()
    read = dst >= 0
    slot = (torch.arange(n_win, device=dst.device)[:, None] * w + dst)[read]
    out = torch.zeros(n_win * w, dtype=pyr.dtype, device=pyr.device)
    out[slot] = pyr[read]
    return out


def class_product_sources(plan: FusedClassPlan):
    """Every product of a v2 class: its arena slot, its flat bank index and
    its piece (an index into the class's piece tables and A values)."""
    dev = plan.etrips.device
    n_sub = plan.slots // TILE
    lo = plan.etrips[:, 0].long()
    cnt = plan.etrips[:, 1].long() - lo
    s = torch.repeat_interleave(torch.arange(n_sub, device=dev), cnt)
    k = torch.arange(s.numel(), device=dev) - torch.repeat_interleave(
        torch.cumsum(cnt, 0) - cnt, cnt)
    pj = (s // (plan.blk // TILE)) * plan.j2_cap + lo[s] + k
    cut = plan.ecuts.long()[pj]
    span = (plan.eends.long()[pj] - cut).clamp(min=0)
    pi = torch.repeat_interleave(torch.arange(pj.numel(), device=dev), span)
    p = cut[pi] + torch.arange(pi.numel(), device=dev) \
        - torch.repeat_interleave(torch.cumsum(span, 0) - span, span)
    return s[pi] * TILE + p, plan.eboffs.long()[pj][pi] * LANES + p, pj[pi]


def expand_class_plain(plan: FusedClassPlan, bank: torch.Tensor,
                       apv: torch.Tensor) -> torch.Tensor:
    """The (slots,) products of a v2 class in arena order, from its piece
    tables (0 in slots no piece covers)."""
    slot, bidx, piece = class_product_sources(plan)
    e = torch.zeros(plan.slots, dtype=bank.dtype, device=bank.device)
    e[slot] = bank.reshape(-1)[bidx] * apv[piece]
    return e


def _check_v2_args(plan: FusedClassPlan, bank, apv) -> None:
    if bank is None or apv is None:
        raise ValueError("a v2 class expands from bank= and apv=")
    if bank.shape != (BANK_K * plan.bank_rows, LANES):
        raise ValueError(f"bank of shape {tuple(bank.shape)} for "
                         f"{plan.bank_rows} bank rows")
    if apv.numel() != plan.apv_hi - plan.apv_lo:
        raise ValueError(f"{apv.numel()} A values for "
                         f"{plan.apv_hi - plan.apv_lo} pieces")
    if apv.dtype != bank.dtype:
        raise TypeError("bank and apv must share a dtype")


def fused_class_plain(plan: FusedClassPlan, x: torch.Tensor | None = None,
                      bank: torch.Tensor | None = None,
                      apv: torch.Tensor | None = None,
                      out: torch.Tensor | None = None) -> torch.Tensor:
    """Plain PyTorch version of K3, in both modes (the JAX tile
    permutation and ``_fused_reference``, with window-local indices, the
    extraction through ``pyr_dst``); into ``out`` when given."""
    if plan.expand:
        _check_v2_args(plan, bank, apv)
        x = expand_class_plain(plan, bank, apv)
    tile = plan.tile_idx.reshape(plan.n_win, plan.w).long()
    res = _reduce_plain(
        plan, torch.gather(x[: plan.slots].reshape(plan.n_win, plan.w), 1,
                           tile))
    if out is None:
        return res
    _check_out(plan, res.dtype, res.device, out)
    return out.copy_(res)


def fused_class_expand_plain(plan: FusedClassPlan, bank: torch.Tensor,
                             apv: torch.Tensor,
                             out: torch.Tensor | None = None) -> torch.Tensor:
    """Plain PyTorch version of K3 v2 (:func:`fused_class_expand`)."""
    return fused_class_plain(plan, None, bank, apv, out)


def _check_out(plan: FusedClassPlan, dtype, device, out) -> None:
    if out.shape != (plan.slots,) or out.dtype != dtype \
            or out.device != device:
        raise ValueError(f"out must be ({plan.slots},) {dtype} on {device}, "
                         f"got {tuple(out.shape)} {out.dtype} on "
                         f"{out.device}")


def _class_out(plan: FusedClassPlan, like: torch.Tensor, out):
    if out is None:
        return torch.empty(plan.slots, dtype=like.dtype, device=like.device)
    _check_out(plan, like.dtype, like.device, out)
    return out


def fused_class_expand(plan: FusedClassPlan, bank: torch.Tensor,
                       apv: torch.Tensor,
                       out: torch.Tensor | None = None) -> torch.Tensor:
    """K3 v2: the (slots,) entry-ordered class arena of a v2 class, its
    products formed in the kernel from ``bank`` and ``apv`` (the class's
    slice of the per-piece A values); written into ``out`` (the class's
    slice of a merge buffer) when given.

    CPU tensors take :func:`fused_class_expand_plain`; CUDA tensors launch
    the kernel (``csrc/fused_class.cu``) or raise.
    """
    if not plan.expand:
        raise ValueError("fused_class_expand needs a v2 plan")
    _check_v2_args(plan, bank, apv)
    if bank.device.type == "cpu":
        return fused_class_expand_plain(plan, bank, apv, out)
    out = _class_out(plan, bank, out)
    if plan.slots:
        cuda_lib.launch(
            "fused_class_expand", "nsp_fused_class_v2", bank, apv,
            plan.etrips, plan.ecuts, plan.eboffs, plan.eends, plan.esub,
            plan.tile_inv, plan.pyr_dst, plan.tier_idx, out, plan.n_win,
            plan.w, plan.lv, len(plan.tier_vs), plan.blk // TILE,
            plan.j2_cap)
        fused_class_expand.launches += 1
    return out


fused_class_expand.launches = 0


def fused_class_apply(plan: FusedClassPlan, x: torch.Tensor | None = None,
                      bank: torch.Tensor | None = None,
                      apv: torch.Tensor | None = None,
                      out: torch.Tensor | None = None) -> torch.Tensor:
    """K3: the (slots,) entry-ordered class arena, into ``out`` when
    given.  v1 (``plan.expand`` false): from the class's products ``x``,
    in arena order.  v2: from ``bank`` and ``apv``
    (:func:`fused_class_expand`).

    CPU tensors take :func:`fused_class_plain`; CUDA tensors launch the
    kernel (``csrc/fused_class.cu``) or raise.
    """
    if plan.expand:
        return fused_class_expand(plan, bank, apv, out)
    if x is None or x.numel() < plan.slots:
        raise ValueError(f"{0 if x is None else x.numel()} products for "
                         f"{plan.slots} slots")
    if x.device.type == "cpu":
        return fused_class_plain(plan, x, out=out)
    out = _class_out(plan, x, out)
    if plan.slots:
        cuda_lib.launch("fused_class_apply", "nsp_fused_class",
                        x[: plan.slots], plan.tile_idx, plan.pyr_dst,
                        plan.tier_idx, out, plan.n_win, plan.w, plan.lv,
                        len(plan.tier_vs))
        fused_class_apply.launches += 1
    return out


fused_class_apply.launches = 0


def launch_geometry(plan: FusedClassPlan, dtype: torch.dtype) -> dict:
    """How the kernel runs this class on the current card (built library
    needed): ``cluster`` blocks per window, ``threads`` per block,
    ``smem`` bytes of dynamic shared memory per block, and
    ``blocks_per_sm``, the blocks of that shape an SM holds at once."""
    got = (ctypes.c_int * 4)()
    el = torch.empty(0, dtype=dtype).element_size()
    rc = cuda_lib.KERNELS.get().nsp_fused_class_geom(
        int(plan.expand), el, plan.n_win, plan.w, plan.lv,
        len(plan.tier_vs), got)
    cuda_lib.check(rc, "fused_class geometry")
    return dict(cluster=got[0], threads=got[1], smem=got[2],
                blocks_per_sm=got[3])

"""Sigma-sorted, width-binned ELL slabs of the PyTorch port (counterpart
of ``nsparse_tpu/formats/ell.py``).

Rows are sorted by length inside windows of ``sigma`` rows, binned into
geometric width classes and packed into width-major ``(W, R)`` slabs
(R a multiple of 128); the output permutation is a gather by ``pos``.
Rows wider than ``split_width`` are cut into chunks whose partial sums
recombine through ``split_rows``/``split_slots``.  Padding slots carry
value 0 and replicate the row's last column, so padded tiles stay
quasi-diagonal for the banded gather class.

Every x gather is planned (``cols_gp``, ``pos_gp``); when many tiles fall
off the gather classes, the x expansion is planned instead as a gather of
the used columns, a fill in column-sorted order and a permutation to slab
order (``uniq_cols_gp``, ``xfill_gp``, ``xsh``).
"""

from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING, Tuple

import numpy as np
import torch

from nsparse_tpu_torch.formats.csr import CSR
from nsparse_tpu_torch.utils.device import int32_tensor, to_device

if TYPE_CHECKING:  # the plan constructors are imported where they run:
    # the ops package imports this module
    from nsparse_tpu_torch.ops.kernels.flat_gather import FlatGatherPlan
    from nsparse_tpu_torch.ops.kernels.shuffle import ShufflePlan

LANES = 128
SUBLANES = 8
# x-shuffle gates: plan the x expansion as a shuffle when more than this
# fraction of slots would take the fallback gather, on at least this many
# slots
XSH_BAD_FRAC = 0.25
XSH_MIN_SLOTS = 1 << 16


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclasses.dataclass(frozen=True)
class ELL:
    """Width-binned ELL slabs.

    Attributes:
      vals, cols: per-slab (W_i, R_i) values and int32 columns.
      pos: (M,) int32 original row -> slot in the concatenated slab
        outputs (the first chunk's slot for a split row).
      cols_gp, pos_gp: flat-gather plans of each slab's columns and of
        ``pos``.
      shape, widths, nnz: (M, N), slab widths, true nnz.
      lens: per-slab (R_i,) int32 true row lengths (0 on padding rows).
      uniq_cols_gp, xfill_gp, xsh: the x-shuffle plans (or None).
      split_rows: (k,) int32 rows that were split (or None);
      split_slots: (k, C) int32 slots of their extra chunks (-1 pad).
    """

    vals: Tuple[torch.Tensor, ...]
    cols: Tuple[torch.Tensor, ...]
    pos: torch.Tensor
    cols_gp: Tuple[FlatGatherPlan, ...]
    pos_gp: FlatGatherPlan
    shape: Tuple[int, int]
    widths: Tuple[int, ...]
    nnz: int
    lens: Tuple[torch.Tensor, ...]
    uniq_cols_gp: FlatGatherPlan | None = None
    xfill_gp: FlatGatherPlan | None = None
    xsh: ShufflePlan | None = None
    split_rows: torch.Tensor | None = None
    split_slots: torch.Tensor | None = None

    @property
    def dtype(self) -> torch.dtype:
        return self.vals[0].dtype

    @property
    def padded_nnz(self) -> int:
        """Stored slots, explicit zeros included."""
        return int(sum(v.numel() for v in self.vals))

    def to(self, device) -> "ELL":
        return to_device(self, device)

    def to_dense(self) -> torch.Tensor:
        """(M, N) dense tensor: each slab row's slots summed into place,
        rows gathered by ``pos``, split rows' extra chunks added."""
        n = self.shape[1]
        parts = []
        for v, c in zip(self.vals, self.cols):
            w, r = v.shape
            slab = torch.zeros(r, n, dtype=v.dtype, device=v.device)
            rows = torch.arange(r, device=v.device).expand(w, r)
            parts.append(slab.index_put_((rows.reshape(-1),
                                          c.reshape(-1).long()),
                                         v.reshape(-1), accumulate=True))
        slots = torch.cat(parts)
        out = slots[self.pos.long()]
        if self.split_rows is not None:
            extra = self.split_slots.long()
            chunks = torch.where((extra >= 0)[..., None],
                                 slots[extra.clamp(min=0)], 0)
            out.index_add_(0, self.split_rows.long(), chunks.sum(dim=1))
        return out

    @classmethod
    def from_numpy(cls, vals, cols, pos, shape, widths, nnz, lens,
                   split_rows=None, split_slots=None, xshuffle_src=None
                   ) -> "ELL":
        """From host slabs (a JAX ELL's arrays); the gather plans are
        built here.  ``xshuffle_src``: the x-shuffle permutation (slab
        slot -> column-sorted slot), or None for no x-shuffle path."""
        from nsparse_tpu_torch.ops.kernels.flat_gather import (
            build_flat_gather_plan,
        )

        vals = tuple(torch.from_numpy(np.array(v)) for v in vals)
        cols_np = [np.array(c, dtype=np.int32) for c in cols]
        pos = np.asarray(pos, dtype=np.int32)
        xsh = ({} if xshuffle_src is None
               else _xshuffle_plans(cols_np, xshuffle_src))
        return cls(
            vals=vals,
            cols=tuple(torch.from_numpy(c) for c in cols_np),
            pos=int32_tensor(pos),
            cols_gp=tuple(build_flat_gather_plan(c.reshape(-1))
                          for c in cols_np),
            pos_gp=build_flat_gather_plan(pos),
            shape=(int(shape[0]), int(shape[1])),
            widths=tuple(int(w) for w in widths),
            nnz=int(nnz),
            lens=tuple(int32_tensor(ln) for ln in lens),
            **xsh,
            split_rows=(None if split_rows is None
                        else int32_tensor(split_rows)),
            split_slots=(None if split_slots is None
                         else int32_tensor(split_slots)),
        )

    @classmethod
    def from_csr(cls, a: CSR, min_width: int = SUBLANES, max_slabs: int = 8,
                 sigma: int | None = 1024, xshuffle: bool | None = None,
                 split_width: int | None = 512) -> "ELL":
        """Host-side conversion (the JAX ``ELL.from_csr``, slab for slab).

        Args:
          min_width: smallest width class.
          max_slabs: cap on the number of width classes (the smallest
            merge upward).
          sigma: sort window in rows; None sorts globally, 0 keeps the
            row order (banded matrices stay quasi-diagonal).
          xshuffle: force the x-shuffle plans on or off; None decides by
            the fallback fraction (``XSH_BAD_FRAC``).
          split_width: rows wider than this split into chunks; None
            disables splitting.
        """
        m, n = a.shape
        rpt, col, val = a.host_arrays()
        col = col[: a.nnz]
        val = val[: a.nnz]
        deg = np.diff(rpt)

        # row splitting: virtual rows = chunks of split_width
        v_rpt = rpt[:-1].astype(np.int64)
        v_deg = deg.astype(np.int64)
        v_parent = np.arange(m, dtype=np.int64)
        first_chunk = np.ones(m, dtype=bool)
        if split_width is not None and m and deg.max(initial=0) > split_width:
            heavy = np.flatnonzero(deg > split_width)
            nch = -(-deg[heavy] // split_width)
            rep = np.repeat(heavy, nch)
            cum = np.concatenate([[0], np.cumsum(nch)[:-1]])
            kin = np.arange(rep.size, dtype=np.int64) - np.repeat(cum, nch)
            ch_rpt = rpt[rep] + kin * split_width
            ch_deg = np.minimum(deg[rep] - kin * split_width, split_width)
            keepm = deg <= split_width
            v_rpt = np.concatenate([rpt[:-1][keepm], ch_rpt])
            v_deg = np.concatenate([deg[keepm], ch_deg])
            v_parent = np.concatenate(
                [np.flatnonzero(keepm).astype(np.int64), rep])
            first_chunk = np.concatenate(
                [np.ones(int(keepm.sum()), bool), kin == 0])
        mv = v_deg.size

        # sigma-windowed descending sort by (virtual) row length
        if sigma == 0:
            order = np.arange(mv, dtype=np.int64)
        elif sigma is None or sigma >= mv:
            order = np.argsort(-v_deg, kind="stable")
        else:
            order = np.empty(mv, dtype=np.int64)
            for s in range(0, mv, sigma):
                e = min(s + sigma, mv)
                order[s:e] = s + np.argsort(-v_deg[s:e], kind="stable")

        # geometric width classes
        max_deg = int(v_deg.max()) if mv else 0
        levels = []
        w = max(int(min_width), 1)
        while True:
            levels.append(w)
            if w >= max(max_deg, 1):
                break
            w *= 2
        levels = sorted(levels[-max_slabs:])
        level = np.minimum(
            np.searchsorted(np.asarray(levels, dtype=np.int64), v_deg,
                            side="left"),
            len(levels) - 1)
        if val.size == 0:  # fully empty matrix: keep gathers in bounds
            val = np.zeros(1, dtype=val.dtype)
            col = np.zeros(1, dtype=col.dtype)

        vals, cols, widths, lens = [], [], [], []
        vpos = np.zeros(mv, dtype=np.int32)
        offset = 0
        lev_of_order = level[order]
        for li, w in enumerate(levels):
            rows = order[lev_of_order == li]
            if rows.size == 0:
                continue
            rpad = _round_up(rows.size, LANES)
            d = np.minimum(v_deg[rows], w)
            idx = v_rpt[rows][None, :] + np.arange(w)[:, None]
            mask = np.arange(w)[:, None] < d[None, :]
            idx = np.where(mask, idx, 0)
            # padding slots replicate the row's last valid column (value 0)
            last_idx = np.minimum(v_rpt[rows] + np.maximum(d - 1, 0),
                                  col.size - 1)
            lastcol = np.where(d > 0, col[last_idx], 0).astype(np.int32)
            sval = np.zeros((w, rpad), dtype=val.dtype)
            scol = np.zeros((w, rpad), dtype=np.int32)
            sval[:, : rows.size] = np.where(mask, val[idx], 0)
            scol[:, : rows.size] = np.where(mask, col[idx], lastcol[None, :])
            vpos[rows] = offset + np.arange(rows.size, dtype=np.int32)
            ln = np.zeros(rpad, dtype=np.int32)
            ln[: rows.size] = d
            vals.append(sval)
            cols.append(scol)
            lens.append(ln)
            widths.append(w)
            offset += rpad

        # original-row pos = first chunk's slot; extra chunks recombine
        pos = np.zeros(m, dtype=np.int32)
        pos[v_parent[first_chunk]] = vpos[first_chunk]
        split_rows = split_slots = None
        extra = ~first_chunk
        if extra.any():
            er = v_parent[extra]
            es = vpos[extra]
            o2 = np.argsort(er, kind="stable")
            er, es = er[o2], es[o2]
            f2 = np.flatnonzero(np.diff(np.concatenate([[-1], er])) != 0)
            cnt2 = np.diff(np.concatenate([f2, [er.size]]))
            split_rows = er[f2].astype(np.int32)
            split_slots = np.full((f2.size, int(cnt2.max())), -1, np.int32)
            kk = np.arange(er.size, dtype=np.int64) - np.repeat(f2, cnt2)
            split_slots[np.repeat(np.arange(f2.size), cnt2), kk] = es

        if not vals:  # empty matrix
            vals = [np.zeros((1, LANES), dtype=val.dtype)]
            cols = [np.zeros((1, LANES), dtype=np.int32)]
            widths = [1]
            lens = [np.zeros(LANES, dtype=np.int32)]

        ell = cls.from_numpy(vals, cols, pos, (m, n), widths, a.nnz, lens,
                             split_rows, split_slots)
        # irregular columns: when a meaningful fraction of slots falls off
        # the gather classes, plan the x expansion as a shuffle
        slots = [c.size for c in cols]
        bad = sum(g.class_fracs["fallback"] * s
                  for g, s in zip(ell.cols_gp, slots)) / max(sum(slots), 1)
        want_xsh = bad > XSH_BAD_FRAC if xshuffle is None else xshuffle
        if not (want_xsh and sum(slots) >= XSH_MIN_SLOTS):
            return ell
        return dataclasses.replace(ell, **_xshuffle_plans(cols))


def _xshuffle_plans(cols, src=None) -> dict:
    """The x-shuffle plans of slabs ``cols``: gather the sorted unique
    columns, fill them out in column-sorted slot order, then permute to
    slab order (``src``: slab slot -> column-sorted slot; derived from a
    stable sort when None)."""
    from nsparse_tpu_torch.ops.kernels.flat_gather import (
        build_flat_gather_plan,
    )
    from nsparse_tpu_torch.ops.kernels.shuffle import build_shuffle_plan

    cols_flat = np.concatenate([c.reshape(-1) for c in cols]).astype(np.int64)
    order = np.argsort(cols_flat, kind="stable")
    if src is None:
        src = np.empty(cols_flat.size, dtype=np.int32)
        src[order] = np.arange(cols_flat.size, dtype=np.int32)
    sorted_cols = cols_flat[order]
    newgrp = np.empty(sorted_cols.size, dtype=bool)
    if sorted_cols.size:
        newgrp[0] = True
        np.not_equal(sorted_cols[1:], sorted_cols[:-1], out=newgrp[1:])
    return dict(
        uniq_cols_gp=build_flat_gather_plan(
            sorted_cols[newgrp].astype(np.int32)),
        xfill_gp=build_flat_gather_plan(
            (np.cumsum(newgrp) - 1).astype(np.int32)),
        xsh=build_shuffle_plan(src),
    )

"""SpGEMM C = A @ B with a reusable plan (counterpart of
``nsparse_tpu/ops/spgemm.py``; the block path is ``ops/spgemm_bsr.py``,
reached through ``spgemm(..., method=)``).

- symbolic: ``spgemm_plan`` runs the host planner (``native/``) and lays
  the products out in one of three layouts, by the JAX package's rule:
  row-localized windows (``ops/spgemm_window.py``), the global slab
  layout, or the sort layout; ``spgemm_plan_device`` is the one-shot
  planner on the values' device (one sort, the sort layout without
  gather plans).  A plan is one-time work per sparsity pattern.  Without
  a plan, ``spgemm`` on CUDA values forms C through per-row hash tables
  instead (``ops/kernels/spgemm_hash.py``), with no plan at all.
- numeric: ``spgemm_numeric`` runs the plan's layout on the device the
  plan and the values live on; new values with the same sparsity re-run
  it on the same plan.
- ``rap`` chains two one-shot products into the Galerkin product
  R·(A·P) on one device.

The sort layout's scan, compaction and rank sort are XLA code in the JAX
package; here they are plain torch: a scatter through the rank
permutation, the segmented scan in shifted adds (elementwise, so the same
sums on every run) and one gather at the segment ends.  ``cmp_masks``
and ``_masked_compaction`` (the TPU's substitute for that gather) are
deliberately not ported.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from nsparse_tpu_torch.formats.csr import CSR
from nsparse_tpu_torch.ops.kernels.fallback import CHUNK  # slab chunk width
from nsparse_tpu_torch.utils.device import int32_tensor, to_device
from nsparse_tpu_torch.utils.profiling import count, host_read, span, synced

LANES = 128
LAYOUTS = (None, "window", "global")
PLANNERS = ("auto", "device", "host")


def _round_up(x: int, m: int) -> int:
    return ((max(x, 1)) + m - 1) // m * m


def _pad(x: np.ndarray, length: int, fill: int) -> np.ndarray:
    out = np.full(length, fill, dtype=np.int32)
    out[: x.size] = x
    return out


def spgemm_flops(a: CSR, b: CSR) -> int:
    """Total FLOPs = 2 * total intermediate products."""
    col_a = a.col[: a.nnz].long().cpu()
    deg_b = torch.diff(b.rpt.long().cpu())
    return 2 * int(deg_b[col_a].sum())


@dataclasses.dataclass(frozen=True)
class SortStructure:
    """The sort layout: every product in (row, column) order.

    Attributes:
      apos, bpos: (P_pad,) int32 ``a.val`` / ``b.val`` index of each
        product; out_pos: (P_pad,) its C entry (pads: ``c_cap``).
      ends: (c_cap,) int32 last product of each C entry.
      max_len: the most products of any C entry (the scan's reach).
      av_gp: flat-gather plan of ``a.val[apos]`` (K5, with K1 and K6 on
        fallback tiles), or None for a device plan.
      bv_gp: flat-gather plan of the B values in ``bpos``-sorted order (a
        forward fill of ``b.val[uniq_bpos]``), or None.
      uniq_bpos: (u_cap,) int32 sorted distinct ``bpos``, or None.
      bp_rank: (P_pad,) int32 plan position of each ``bpos``-sorted
        product (the JAX package sorts by it; the port scatters), or None.
    """

    apos: torch.Tensor
    bpos: torch.Tensor
    out_pos: torch.Tensor
    ends: torch.Tensor
    max_len: int
    av_gp: object = None
    bv_gp: object = None
    uniq_bpos: torch.Tensor | None = None
    bp_rank: torch.Tensor | None = None

    def to(self, device) -> "SortStructure":
        return to_device(self, device)


@dataclasses.dataclass(frozen=True)
class GlobalStructure:
    """The global slab layout: products expanded A-entry-major from the
    8-aligned B table (K11, K1, K2, K12), shuffled into bin-padded slab
    classes (K1), reduced per class, and assembled into C (K1).

    Attributes:
      pw: the piece tables of the expansion (aligned or unaligned mode).
      b8_idx: (b8_len,) int32 ``b.val`` index of each 8-aligned table slot.
      slab_shuffle / asm_shuffle: products -> slab, class sums -> C.
      lvl_idx / slab_levels: the slab levels (``slab_class_reduce``).
    """

    pw: object
    b8_idx: torch.Tensor
    slab_shuffle: object
    asm_shuffle: object
    lvl_idx: Tuple[torch.Tensor, ...]
    slab_levels: Tuple

    def to(self, device) -> "GlobalStructure":
        return to_device(self, device)


@dataclasses.dataclass(frozen=True)
class SpgemmPlan:
    """Captured sparsity computation of C = A @ B.

    Attributes:
      c_rpt: (M+1,) int32 output row pointers.
      c_col: (c_cap,) int32 output columns (sorted within rows; the tail
        past ``c_nnz`` is 0).
      shape: (M, N) of C; c_nnz: output nnz; n_products: intermediate
        products P (flops = 2 P).
      layout: "window", "global" or "sort"; the structure of that layout
        is ``win``, ``glob`` or ``srt`` (the others are None).
      planner: who built it: ``"native"`` (the C++ host planner),
        ``"numpy"`` (its fallback), ``"device"`` (``spgemm_plan_device``),
        or ``"jax"`` for a plan converted by :func:`plan_from_numpy`.
      nnz_a / nnz_b: the value-array sizes the plan was built for.
    """

    c_rpt: torch.Tensor
    c_col: torch.Tensor
    shape: Tuple[int, int]
    c_nnz: int
    n_products: int
    layout: str
    planner: str
    nnz_a: int
    nnz_b: int
    win: object = None
    glob: GlobalStructure | None = None
    srt: SortStructure | None = None

    @property
    def c_capacity(self) -> int:
        return int(self.c_col.shape[0])

    @property
    def flops(self) -> int:
        return 2 * self.n_products

    def to(self, device) -> "SpgemmPlan":
        with span("prep.to_device"):
            return to_device(self, device)


def _ceil_pow2(x: np.ndarray) -> np.ndarray:
    """Elementwise next power of two (>= 1) via the float exponent."""
    x = np.maximum(x, 1)
    e = np.frexp((x - 1).astype(np.float64))[1]
    return np.where(x <= 1, 1, np.int64(1) << e).astype(x.dtype)


def _build_slab_structure(
    ends: np.ndarray,
    p_total: int,
    src_pos: np.ndarray,
    zero_pool: np.ndarray,
    src_len: int,
    c_cap: int,
    targets: np.ndarray | None = None,
):
    """Bin-padded slab layout of an accumulation: the global slab
    layout's (``targets`` None), or the window fallback pool's.

    Entries (and, recursively, their 512-product chunks) are binned by
    power-of-two product-count classes; each class-(L) member occupies L
    slab slots.  Returns the shuffle source (``src_pos[plan-order
    product]`` = its position in the source product array, pads -> zero
    sources), per-level class tables, level >= 2 gather indices, and the
    assembly (``asm_entry``, ``asm_pos``, ``res_off``).  ``targets``: the
    output-entry id of each item; without it (every entry of C, in order)
    the result also holds ``asm_src``, the assembly permutation
    ``c_val[e] = res_concat[asm_src[e]]``.
    """
    c_nnz = ends.size
    starts = np.empty(c_nnz, dtype=np.int64)
    if c_nnz:
        starts[0] = 0
        starts[1:] = ends[:-1] + 1
    lens = ends.astype(np.int64) - starts + 1

    levels = []
    lvl_idx = []
    asm_entry = []
    asm_pos = []
    res_off = 0
    slab_idx1 = None

    item_target = (
        np.asarray(targets, dtype=np.int64)
        if targets is not None
        else np.arange(c_nnz, dtype=np.int64)
    )
    item_start, item_len = starts, lens
    level_i = 0
    while item_start.size:
        nch = -(-item_len // CHUNK)
        big = nch > 1
        rep = np.where(big, nch, 1)
        n_rows = int(rep.sum())
        row_item = np.repeat(np.arange(item_len.size, dtype=np.int64), rep)
        cum = np.zeros(item_len.size + 1, dtype=np.int64)
        np.cumsum(rep, out=cum[1:])
        j_in = np.arange(n_rows, dtype=np.int64) - cum[row_item]
        row_start = (item_start[row_item] + j_in * CHUNK).astype(np.int32)
        row_len = np.minimum(
            item_len[row_item] - j_in * CHUNK, CHUNK
        ).astype(np.int32)
        row_is_chunk = big[row_item]
        row_cls = np.where(row_is_chunk, CHUNK, _ceil_pow2(row_len))

        class_sizes = sorted(set(np.unique(row_cls).tolist()))
        cls_code = np.searchsorted(class_sizes, row_cls)
        order = np.argsort(cls_code, kind="stable")
        rank_of_row = np.empty(n_rows, dtype=np.int64)
        rank_of_row[order] = np.arange(n_rows)
        cls_bounds = np.searchsorted(
            cls_code[order], np.arange(len(class_sizes) + 1)
        )

        classes = []
        idx_parts = []
        chunk_rank0 = None
        rank_base = 0
        for ci, L in enumerate(class_sizes):
            rows_l = order[cls_bounds[ci] : cls_bounds[ci + 1]]
            cnt = rows_l.size
            cnt_pad = _round_up(cnt, LANES)
            classes.append((int(L), int(cnt_pad)))
            # member-minor (L, cnt_pad): reduction by halving adds
            mat = np.full((L, cnt_pad), -1, dtype=np.int32)
            larange = np.arange(L, dtype=np.int32)[:, None]
            np.add(row_start[rows_l][None, :], larange, out=mat[:, :cnt])
            np.copyto(
                mat[:, :cnt], -1, where=larange >= row_len[rows_l][None, :]
            )
            idx_parts.append(mat.reshape(-1))
            if L == CHUNK:
                chunk_rank0 = rank_base
            fin = ~row_is_chunk[rows_l]
            if fin.any():
                asm_entry.append(item_target[row_item[rows_l[fin]]])
                asm_pos.append(res_off + np.flatnonzero(fin))
            res_off += cnt_pad
            rank_base += cnt
        levels.append(tuple(classes))
        this_idx = (
            np.concatenate(idx_parts) if idx_parts else np.zeros(0, np.int32)
        )
        if level_i == 0:
            slab_idx1 = this_idx
        else:
            lvl_idx.append(this_idx)

        if big.any():
            bi = np.flatnonzero(big)
            item_start = rank_of_row[cum[bi]] - chunk_rank0
            item_len = nch[bi]
            item_target = item_target[bi]
        else:
            item_start = np.zeros(0, np.int64)
            item_len = np.zeros(0, np.int64)
            item_target = np.zeros(0, np.int64)
        level_i += 1

    # level-1 shuffle source: pads draw zeros from the pool of unreferenced
    # source positions; the pool's leftovers fill the tail so the source
    # stays a permutation
    p_slab = slab_idx1.size
    valid = slab_idx1 >= 0
    n_pads = int((~valid).sum())
    n_total = max(p_slab, src_len)
    pool = np.concatenate([
        zero_pool.astype(np.int64),
        np.arange(src_len, n_total, dtype=np.int64),
    ])
    if pool.size < n_pads:
        raise AssertionError("zero-source pool too small")
    src = np.empty(n_total, dtype=np.int32)
    src[:p_slab][valid] = src_pos[slab_idx1[valid]]
    src[:p_slab][~valid] = pool[:n_pads]
    src[p_slab:] = pool[n_pads:]

    e_all = np.concatenate(asm_entry) if asm_entry else np.zeros(0, np.int64)
    p_all = np.concatenate(asm_pos) if asm_pos else np.zeros(0, np.int64)
    out = dict(
        src=src,
        levels=tuple(levels),
        lvl_idx=tuple(lvl_idx),
        asm_entry=e_all,
        asm_pos=p_all,
        res_off=res_off,
        p_slab=p_slab,
    )
    if targets is not None:  # the caller composes the assembly
        return out
    # assembly permutation: c_val[e] = res_concat[asm_src[e]]; the pad
    # targets take the leftover class sums, so the map is a permutation
    n_asm = max(res_off, c_cap)
    asm_src = np.empty(n_asm, dtype=np.int32)
    used = np.zeros(n_asm, dtype=bool)
    asm_src[e_all] = p_all
    used[p_all] = True
    asm_src[c_nnz:] = np.flatnonzero(~used)[: n_asm - c_nnz]
    out["asm_src"] = asm_src
    return out


def slab_class_reduce(lvl_in: torch.Tensor, slab_levels, lvl_idx):
    """Reduce bin-padded slab data to per-entry totals.

    ``slab_levels``: ((L, cnt), ...) per level; ``lvl_idx``: per level
    >= 2, gather indices (-1 = zero) from the previous level's CHUNK-class
    sums.  Each member-minor (L, cnt) class reduces by halving adds.
    Returns the concatenated per-class results.
    """
    res_parts = []
    for li, classes in enumerate(slab_levels):
        res_chunk = None
        off = 0
        for L, cnt in classes:
            seg = lvl_in[off : off + cnt * L]
            ll = L
            while ll > 1:
                half = (ll // 2) * cnt
                seg = seg[:half] + seg[half : 2 * half]
                ll //= 2
            off += cnt * L
            res_parts.append(seg)
            if L == CHUNK:
                res_chunk = seg
        if li + 1 < len(slab_levels):
            idx = lvl_idx[li].long()
            lvl_in = torch.where(idx >= 0, res_chunk[idx.clamp(min=0)], 0)
    return torch.cat(res_parts) if len(res_parts) > 1 else res_parts[0]


def _host_symbolic(a: CSR, b: CSR):
    """The host planner's outputs and the arrays the layouts share."""
    from nsparse_tpu_torch.native import (
        spgemm_plan_host_native,
        spgemm_plan_host_numpy,
    )

    if a.shape[1] != b.shape[0]:
        raise ValueError(f"shape mismatch {a.shape} @ {b.shape}")
    with span("prep.symbolic"):
        m, n = a.shape[0], b.shape[1]
        rpt_a, col_a, _ = a.host_arrays()
        rpt_b, col_b, _ = b.host_arrays()
        col_a = col_a[: a.nnz].astype(np.int64)
        deg_a = np.diff(rpt_a).astype(np.int64)
        deg_b = np.diff(rpt_b).astype(np.int64)
        args = (rpt_a, col_a, deg_a, rpt_b, col_b[: b.nnz], deg_b, m, n,
                a.nnz)
        host, planner = spgemm_plan_host_native(*args), "native"
        if host is None:
            host, planner = spgemm_plan_host_numpy(*args), "numpy"
        return host, planner, (rpt_a, col_a, deg_a, rpt_b, deg_b)


def spgemm_symbolic_nnz(a: CSR, b: CSR) -> int:
    """Output nnz only (the ``set_row_nnz`` + scan readback analog)."""
    return _host_symbolic(a, b)[0][6]


def _global_structure(col_a, rpt_b, deg_b, apos, bpos, ends, p_total,
                      c_cap, nnz_a) -> GlobalStructure:
    """The JAX package's global slab layout (``spgemm.py:528-574``): runs
    of the A-entry-major expansion, one per A entry (its B row is a slice
    of the 8-aligned B table), and the slab shuffles."""
    from nsparse_tpu_torch.ops.kernels.piecewise import (
        aligned_b_table,
        build_piecewise_plan,
    )
    from nsparse_tpu_torch.ops.kernels.shuffle import build_shuffle_plan

    deg8, rpt8, b8_idx = aligned_b_table(rpt_b, deg_b)
    seg_len = deg_b[col_a]
    seg8 = deg8[col_a]
    run_start = np.zeros(nnz_a, dtype=np.int64)
    np.cumsum(seg8[:-1], out=run_start[1:])
    p_total8 = int(seg8.sum())
    pw = build_piecewise_plan(run_start, rpt8[col_a],
                              np.arange(nnz_a, dtype=np.int64), p_total8,
                              nnz_a, int(rpt8[-1]))
    # each product's position in A-entry-major order, from a per-A-entry
    # delta (int32 temporaries of P entries)
    delta = (run_start - np.asarray(rpt_b, np.int64)[col_a]).astype(np.int32)
    aem_pos = delta[apos] + np.asarray(bpos, np.int32)
    # the interior run pads (zeros of the 8-aligned table) are the zero pool
    pad_cnt = seg8 - seg_len
    pr = np.repeat(np.arange(nnz_a, dtype=np.int64), pad_cnt)
    k_in = np.arange(pr.size, dtype=np.int64) - (np.cumsum(pad_cnt)
                                                 - pad_cnt)[pr]
    interior = run_start[pr] + seg_len[pr] + k_in
    slab = _build_slab_structure(ends, p_total, aem_pos, interior, p_total8,
                                 c_cap)
    return GlobalStructure(
        pw=pw,
        b8_idx=int32_tensor(b8_idx),
        slab_shuffle=build_shuffle_plan(slab["src"], n_src=p_total8),
        asm_shuffle=build_shuffle_plan(slab["asm_src"],
                                       n_src=slab["res_off"]),
        lvl_idx=tuple(int32_tensor(i) for i in slab["lvl_idx"]),
        slab_levels=slab["levels"],
    )


def _sort_structure(apos, bpos, out_pos, ends, p_total, c_cap
                    ) -> SortStructure:
    """The JAX package's sort layout (``spgemm.py:576-659``): in
    ``bpos``-sorted product order the B values are a forward fill of the
    distinct B entries (window-class fill indices), and ``bp_rank`` leads
    back to plan order."""
    from nsparse_tpu_torch.ops.kernels.flat_gather import (
        build_flat_gather_plan,
    )

    p_pad = _round_up(p_total, LANES)
    order_bp = np.argsort(bpos, kind="stable")
    sorted_bpos = bpos[order_bp]
    first = np.empty(p_total, dtype=bool)
    first[:1] = True
    np.not_equal(sorted_bpos[1:], sorted_bpos[:-1], out=first[1:])
    fill_idx = (np.cumsum(first) - 1).astype(np.int32)
    uniq = sorted_bpos[first].astype(np.int32)
    apos_p = _pad(apos, p_pad, int(apos[-1]) if apos.size else 0)
    lens = np.diff(ends, prepend=-1)
    return SortStructure(
        apos=int32_tensor(apos_p),
        bpos=int32_tensor(_pad(bpos, p_pad, 0)),
        out_pos=int32_tensor(_pad(out_pos, p_pad, c_cap)),
        ends=int32_tensor(_pad(ends, c_cap, p_pad - 1)),
        max_len=int(lens.max(initial=0)),
        av_gp=build_flat_gather_plan(apos_p),
        # -1 fills: the pad products gather zeros
        bv_gp=build_flat_gather_plan(_pad(fill_idx, p_pad, -1)),
        uniq_bpos=int32_tensor(_pad(uniq, _round_up(uniq.size, LANES), 0)),
        bp_rank=int32_tensor(_pad(order_bp.astype(np.int32), p_pad,
                                  p_pad - 1)),
    )


def spgemm_plan(a: CSR, b: CSR, shuffle: bool | None = None,
                layout: str | None = None) -> SpgemmPlan:
    """Symbolic phase on the host: the plan of C = A @ B.

    The layout follows the JAX package's rule off the TPU
    (``nsparse_tpu/ops/spgemm.py:509-527``): ``shuffle`` (default: from
    2^20 products on) admits the routed layouts; then ``layout`` None or
    "window" tries the row-localized windows ("window" raises when no row
    fits one), and "global", or windows that do not apply, take the
    global slab layout; everything else, empty products included, the
    sort layout.  The JAX package also sends f64 plans on a TPU to the
    global layout, because its window kernels there are f32-only; the
    port's window kernels carry f64, so it has no such rule.

    The plan's tensors are on the CPU; move it with ``plan.to(device)``.
    """
    from nsparse_tpu_torch.ops.spgemm_window import build_window_structure

    if layout not in LAYOUTS:
        raise ValueError(f"unknown layout {layout!r}")
    host, planner, (rpt_a, col_a, deg_a, rpt_b, deg_b) = _host_symbolic(a, b)
    with span("prep.layout"):
        apos, bpos, out_pos, c_rpt, c_col, p_total, c_nnz = host
        m = a.shape[0]
        c_cap = _round_up(c_nnz, LANES)
        if c_nnz:
            # last product of each output entry: starts are where out_pos
            # changes
            neq = np.empty(out_pos.size, bool)
            neq[0] = True
            np.not_equal(out_pos[1:], out_pos[:-1], out=neq[1:])
            first = np.flatnonzero(neq)
            ends = np.concatenate([first[1:] - 1,
                                   [p_total - 1]]).astype(np.int32)
        else:
            ends = np.zeros(0, dtype=np.int32)

        if shuffle is None:
            shuffle = p_total >= (1 << 20)
        routed = bool(shuffle and p_total and c_nnz)
        win = glob = srt = None
        if routed and layout in (None, "window"):
            win = build_window_structure(
                rpt_a, col_a, deg_a, rpt_b, deg_b, apos, bpos, out_pos, ends,
                c_rpt, p_total, c_nnz, c_cap, m, a.nnz, b.nnz,
            )
            if win is None and layout == "window":
                raise ValueError(
                    "layout='window' requested but no row fits a window arena")
        if routed and win is None:
            glob = _global_structure(col_a, rpt_b, deg_b, apos, bpos, ends,
                                     p_total, c_cap, a.nnz)
        if not routed:
            srt = _sort_structure(apos, bpos, out_pos, ends, p_total, c_cap)
        return SpgemmPlan(
            c_rpt=int32_tensor(c_rpt),
            c_col=int32_tensor(_pad(c_col, c_cap, 0)),
            shape=(m, b.shape[1]),
            c_nnz=int(c_nnz),
            n_products=int(p_total),
            layout="window" if win is not None else
            "global" if glob is not None else "sort",
            planner=planner,
            nnz_a=a.nnz,
            nnz_b=b.nnz,
            win=win,
            glob=glob,
            srt=srt,
        )


def spgemm_plan_device(a: CSR, b: CSR) -> SpgemmPlan:
    """Symbolic phase on the values' device (the JAX package's
    ``spgemm_plan_device``): expand every product, one stable
    ``torch.sort`` by the packed (row, column) key, segment boundaries.
    Device-to-host reads size it (P, nnz(C) and the longest entry); the
    plan takes the sort layout without gather plans, so its numeric phase
    is plain gathers and the segmented scan.  The plan lives on the device
    of ``a``.
    """
    if a.shape[1] != b.shape[0]:
        raise ValueError(f"shape mismatch {a.shape} @ {b.shape}")
    m, n = a.shape[0], b.shape[1]
    if m * n >= 2**31:
        raise ValueError(
            "device planner requires M * N < 2^31 (packed sort key); "
            "use spgemm_plan for larger shapes"
        )
    dev = a.col.device
    with span("plan_device.expand"):
        col_a = a.col[: a.nnz].long()
        rpt_b = b.rpt.to(dev).long()
        cnt = rpt_b.diff()[col_a]
        p_total = host_read(cnt.sum(), "p_total")  # sizes the expansion
        p_pad = _round_up(p_total, LANES)
        k = torch.repeat_interleave(torch.arange(a.nnz, device=dev), cnt,
                                    output_size=p_total)
        t_in = torch.arange(p_total, device=dev) - (cnt.cumsum(0) - cnt)[k]
        bpos = rpt_b[col_a[k]] + t_in
        row = torch.repeat_interleave(
            torch.arange(m, device=dev), a.rpt.long().diff(),
            output_size=a.nnz)[k]
    with span("plan_device.sort"):
        # M * N < 2^31: the packed key sorts as int32, in half the passes
        key, order = torch.sort(
            (row * n + b.col.to(dev).long()[bpos]).int(), stable=True)
    with span("plan_device.boundaries"):
        new = torch.ones(p_total, dtype=torch.bool, device=dev)
        new[1:] = key[1:] != key[:-1]
        c_nnz = host_read(new.sum(), "c_nnz")  # sizes C
        c_cap = _round_up(c_nnz, LANES)
        with synced("nonzero"):
            starts = torch.nonzero(new).squeeze(1)
        ends = torch.full((c_cap,), max(p_total - 1, 0), dtype=torch.long,
                          device=dev)
        ends[: max(c_nnz - 1, 0)] = starts[1:] - 1
        lens = ends[:c_nnz] - torch.cat([starts.new_full((1,), -1),
                                         ends[: max(c_nnz - 1, 0)]])
        # the scan's reach
        max_len = host_read(lens.max(), "max_len") if c_nnz else 0
        entry_key = key[starts]
        c_col = torch.zeros(c_cap, dtype=torch.int32, device=dev)
        c_col[:c_nnz] = entry_key % n
        # entries sorted by row: row i starts at the first key of row i
        c_rpt = torch.searchsorted(
            entry_key, torch.arange(m + 1, device=dev, dtype=torch.int32) * n
        ).int()

        def padded(x, fill):
            out = torch.full((p_pad,), fill, dtype=torch.int32, device=dev)
            out[:p_total] = x
            return out

        return SpgemmPlan(
            c_rpt=c_rpt,
            c_col=c_col,
            shape=(m, n),
            c_nnz=c_nnz,
            n_products=p_total,
            layout="sort",
            planner="device",
            nnz_a=a.nnz,
            nnz_b=b.nnz,
            srt=SortStructure(
                apos=padded(k[order], 0),
                bpos=padded(bpos[order], 0),
                out_pos=padded(new.cumsum(0) - 1, c_cap),
                ends=ends.clamp(0, p_pad - 1).int(),
                max_len=max_len,
            ),
        )


def plan_from_numpy(arrays: dict, extras: dict, expand) -> SpgemmPlan:
    """The port's plan from the JAX package's index-form window plan.

    ``arrays`` holds the JAX plan's arrays as numpy: ``shape``, ``c_rpt``,
    ``c_col``, ``c_nnz``, ``n_products``, ``class_geom``, and per class
    ``tier_vs``, ``tile_idx`` (``TileBenesPlan.idx``), ``tier_idx``
    (``ref_tier_idx``), ``ext_idx`` (``ref_ext_idx``) and ``entry_idx``
    (``ref_entry_idx``); then ``fb_shuffle``/``fb_perm`` (``ShufflePlan.idx``
    or None), ``fb_levels``, ``fb_lvl_idx``, ``fb_off``, ``fb_len`` and
    ``n_compact``.  ``extras`` is the dict the JAX ``spgemm_plan`` fills
    through ``extras_out`` (the merge runs, ``arena_len``, ``fb_seg``,
    ``c_cap``).  The JAX plan keeps its expansion as TPU piece tables, so
    ``expand`` — the run descriptors — comes from the port's own planner;
    its live slots tell the fallback pool's products from its pads, and
    the merge runs each fallback entry's segment slot, for K13's table.
    The JAX indices are class-global; they are converted to window-local
    ones here, with the same checks ``build_window_structure`` applies.
    The index form is the JAX package's v1 plan (its v2 plans carry routed
    masks instead of indices), so the converted plan is v1.
    """
    from nsparse_tpu_torch.ops.kernels.fallback import fallback_from_slab
    from nsparse_tpu_torch.ops.kernels.runcopy import build_runcopy_plan
    from nsparse_tpu_torch.ops.kernels.shuffle import build_shuffle_plan
    from nsparse_tpu_torch.ops.kernels.window_fused import (
        build_fused_plan,
        level_widths,
    )
    from nsparse_tpu_torch.ops.spgemm_window import WindowStructure, _local

    fused = []
    for ci, (_, slots, w, lv) in enumerate(arrays["class_geom"]):
        n_win = slots // w
        tier_vs = arrays["tier_vs"][ci]
        # level-major class-global pyramid index -> window-local
        lw = np.asarray(level_widths(w, lv, tier_vs), np.int64)
        vbase = np.concatenate([[0], np.cumsum(lw * n_win)])
        lbase = np.concatenate([[0], np.cumsum(lw)[:-1]])
        g = np.asarray(arrays["ext_idx"][ci], np.int64)
        live = g >= 0
        lvl = np.searchsorted(vbase, g[live], side="right") - 1
        r = g[live] - vbase[lvl]
        if not (r // lw[lvl] == np.flatnonzero(live) // w).all():
            raise AssertionError("ext index leaves its window")
        ext = np.full(g.size, -1, np.int64)
        ext[live] = lbase[lvl] + r % lw[lvl]
        fused.append(build_fused_plan(
            w, slots, lv, tier_vs,
            _local(np.asarray(arrays["tile_idx"][ci], np.int64), w, "tile"),
            [_local(np.asarray(t, np.int64), v, "tier")
             for t, v in zip(arrays["tier_idx"][ci], tier_vs)],
            ext,
            _local(np.asarray(arrays["entry_idx"][ci], np.int64), w, "entry"),
        ))
    n_src = extras["arena_len"] + extras["fb_seg"]
    fb = fb_shuffle = fb_perm = None
    if arrays["fb_shuffle"] is not None:
        fb_shuffle = build_shuffle_plan(arrays["fb_shuffle"], arrays["fb_len"])
        fb_perm = build_shuffle_plan(arrays["fb_perm"], extras["fb_seg"])
        rs = expand.run_start.numpy().astype(np.int64)
        pos = np.arange(int(arrays["fb_len"]), dtype=np.int64) \
            + int(arrays["fb_off"])
        run = np.searchsorted(rs, pos, side="right") - 1
        real = pos - rs[run] < expand.live_len.numpy()[run]
        m_src = np.asarray(extras["mrg_src"], np.int64)
        m_len = np.asarray(extras["mrg_len"], np.int64)
        tail = m_src >= extras["arena_len"]
        n = m_len[tail]
        seg = np.repeat(m_src[tail] - extras["arena_len"] - (np.cumsum(n) - n),
                        n) + np.arange(int(n.sum()))
        fb = fallback_from_slab(
            fb_shuffle.idx.numpy(), tuple(arrays["fb_levels"]),
            [np.asarray(i) for i in arrays["fb_lvl_idx"]],
            fb_perm.idx.numpy()[seg], seg, real, extras["fb_seg"])
    win = WindowStructure(
        expand=expand,
        fused=tuple(fused),
        merge=build_runcopy_plan(
            extras["mrg_src"], extras["mrg_len"], n_src,
            dst=extras["mrg_dst"], n_out=-(-extras["c_cap"] // 1024) * 1024,
        ),
        fb=fb,
        fb_shuffle=fb_shuffle,
        fb_lvl_idx=tuple(
            int32_tensor(i)
            for i in arrays["fb_lvl_idx"]
        ),
        fb_perm=fb_perm,
        class_geom=tuple(tuple(int(v) for v in g) for g in arrays["class_geom"]),
        fb_levels=tuple(arrays["fb_levels"]),
        fb_off=int(arrays["fb_off"]),
        fb_len=int(arrays["fb_len"]),
        n_compact=int(arrays["n_compact"]),
        pw=None,
        b8_idx=int32_tensor(np.zeros(0)),
        apv_idx=int32_tensor(np.zeros(0)),
        fused_expand=False,
        bank_rows=0,
    )
    return SpgemmPlan(
        c_rpt=int32_tensor(arrays["c_rpt"]),
        c_col=int32_tensor(arrays["c_col"]),
        shape=tuple(arrays["shape"]),
        c_nnz=int(arrays["c_nnz"]),
        n_products=int(arrays["n_products"]),
        layout="window",
        planner="jax",
        nnz_a=expand.nnz_a,
        nnz_b=expand.nnz_b,
        win=win,
    )


def _check_numeric_inputs(plan: SpgemmPlan, a: CSR, b: CSR) -> None:
    if a.val.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"values must be float32 or float64, got {a.val.dtype}")
    if a.val.dtype != b.val.dtype:
        raise TypeError("A and B values must share a dtype")
    if (a.nnz, b.nnz) != (plan.nnz_a, plan.nnz_b):
        raise ValueError(
            f"plan built for nnz ({plan.nnz_a}, {plan.nnz_b}), "
            f"got ({a.nnz}, {b.nnz})"
        )
    devs = {a.val.device, b.val.device, plan.c_rpt.device}
    if len(devs) != 1:
        raise ValueError(f"plan and values on different devices: {devs}")


def _csr(plan: SpgemmPlan, c_val: torch.Tensor) -> CSR:
    return CSR(rpt=plan.c_rpt, col=plan.c_col, val=c_val, shape=plan.shape,
               nnz=plan.c_nnz)


def _segment_sums(plan: SpgemmPlan, prod: torch.Tensor) -> torch.Tensor:
    """C's values from the products in plan order (``prod`` is summed in
    place): a segmented inclusive scan, as the JAX package's
    ``_segmented_inclusive_scan`` (Hillis-Steele shifted adds, stopped
    once the shift reaches the longest entry), then one gather at the
    entry ends; the capacity tail is 0.  Every step is elementwise, so the
    sums are the same on every run (a float ``index_add_`` reorders them
    with its atomics; ``segment_reduce``, as deterministic, took 10.8 ms
    on R-MAT-14 against about 1 ms for the scan on an H100)."""
    s, nnz = plan.srt, plan.c_nnz
    c_val = torch.zeros(plan.c_capacity, dtype=prod.dtype, device=prod.device)
    if nnz:
        ends = s.ends[:nnz].long()
        v = prod[: plan.n_products]
        first = torch.zeros(v.numel(), dtype=torch.bool, device=v.device)
        # each assignment copies its host scalar to the card and waits
        with synced("scan_head"):
            first[0] = True
        with synced("scan_starts"):
            first[ends[:-1] + 1] = True  # a segment start lies at or before i
        d = 1
        while d < s.max_len:
            add = torch.where(first[d:], 0, v[:-d])
            reach = first.clone()
            reach[d:] |= first[:-d]
            v[d:] += add
            first, d = reach, 2 * d
        c_val[:nnz] = v[ends]
    return c_val


def spgemm_numeric_sort(plan: SpgemmPlan, a: CSR, b: CSR) -> CSR:
    """The sort layout's numeric phase.  A host plan gathers the B values
    as a forward fill in ``bpos`` order (a plain gather of the distinct
    entries, then ``flat_gather``), scatters them to plan order through
    ``bp_rank``, and multiplies them into the A values inside the
    ``flat_gather`` of ``a.val[apos]``; a device plan takes plain gathers
    (as the JAX package does).  Then the segmented sum."""
    from nsparse_tpu_torch.ops.kernels.flat_gather import flat_gather

    s, p = plan.srt, plan.n_products
    if not (p and plan.c_nnz):
        return _csr(plan, torch.zeros(plan.c_capacity, dtype=a.val.dtype,
                                      device=a.val.device))
    with span("numeric.sort.products"):
        if s.av_gp is None:
            prod = a.val[s.apos[:p].long()] * b.val[s.bpos[:p].long()]
        else:
            bv_bp = flat_gather(s.bv_gp, b.val[s.uniq_bpos.long()])
            bv = torch.zeros_like(bv_bp)
            bv[s.bp_rank[:p].long()] = bv_bp[:p]
            prod = flat_gather(s.av_gp, a.val, other=bv)
    with span("numeric.sort.segsum"):
        return _csr(plan, _segment_sums(plan, prod))


def spgemm_numeric_slab(plan: SpgemmPlan, a: CSR, b: CSR, ops=None) -> CSR:
    """The global slab layout's numeric phase (the JAX package's
    ``_spgemm_numeric_slab``): the products A-entry-major (K11 builds the
    bank or the flat table, then K1, K2 piece or flat mode per class,
    K12), the slab shuffle (K1), the class reductions, the assembly
    shuffle (K1), the tail past nnz(C) zeroed.  ``ops``: the kernels by
    role (``spgemm_window.KERNEL_OPS``, the default, or ``PLAIN_OPS``)."""
    from nsparse_tpu_torch.ops.kernels import piecewise
    from nsparse_tpu_torch.ops.spgemm_window import KERNEL_OPS

    ops = ops or KERNEL_OPS
    g = plan.glob
    with span("numeric.slab"):
        table = piecewise.build_table(g.pw, g.b8_idx, b.val, ops.bank)
        prod = piecewise.expand_from_bank(g.pw, a.val, table, ops.gather,
                                          ops.pieces, ops.tiles8,
                                          ops.pieces_flat, ops.scatter)
        res = slab_class_reduce(ops.gather(prod, g.slab_shuffle.idx),
                                g.slab_levels, g.lvl_idx)
        c_val = ops.gather(res, g.asm_shuffle.idx)[: plan.c_capacity]
        c_val[plan.c_nnz :] = 0
        return _csr(plan, c_val)


def spgemm_numeric(plan: SpgemmPlan, a: CSR, b: CSR) -> CSR:
    """Numeric phase: C's values for these A and B values (any values with
    the sparsity the plan was built for), in the plan's layout.  Runs on
    the device the plan and the values are on; CUDA tensors go through the
    Hopper kernels.
    """
    from nsparse_tpu_torch.ops.spgemm_window import spgemm_numeric_window

    with span("spgemm_numeric"):
        _check_numeric_inputs(plan, a, b)
        if plan.layout == "window":
            return spgemm_numeric_window(plan, a, b)
        if plan.layout == "global":
            return spgemm_numeric_slab(plan, a, b)
        return spgemm_numeric_sort(plan, a, b)


def spgemm_numeric_segsum(plan: SpgemmPlan, a: CSR, b: CSR) -> CSR:
    """Oracle numeric phase (the JAX package's): plain gathers of every
    product and a segmented sum into C's entries.  Only sort-layout plans
    (host or device) carry the product arrays it reads."""
    if plan.srt is None:
        raise ValueError(
            f"a {plan.layout}-layout plan carries no product arrays; build "
            "one with spgemm_plan(a, b, shuffle=False) or spgemm_plan_device")
    _check_numeric_inputs(plan, a, b)
    s, p = plan.srt, plan.n_products
    prod = a.val[s.apos[:p].long()] * b.val[s.bpos[:p].long()]
    return _csr(plan, _segment_sums(plan, prod))


def spgemm(a: CSR, b: CSR, plan: SpgemmPlan | None = None,
           method: str = "esc", planner: str = "auto") -> CSR:
    """C = A @ B.

    ``method``: "esc" (expand, sort, compress through a plan), "bsr"
    (dense tile products for block-clustered matrices, ``spgemm_bsr``), or
    "auto" (``choose_spgemm_path`` without a plan, else "esc").

    ``planner`` (ESC calls without a plan): "auto" on CUDA values forms C
    in one shot through per-row hash tables in shared memory
    (``ops/kernels/spgemm_hash.py``: rows binned by their work, a
    symbolic count, then a numeric accumulate; two host reads, no
    plan); its sums follow the order of the card's atomics, so C's values
    are not bitwise repeatable from run to run (its structure is).
    "device" builds the deterministic one-shot plan on the values' device
    (``spgemm_plan_device``: one sort; a plan that can be reused),
    "host" the reusable host plan (``spgemm_plan``, moved to the values'
    device: seconds of host time, the fastest re-run).  On the CPU "auto"
    picks "device", as the JAX package does.  Callers who re-multiply the
    same structure should build ``spgemm_plan`` once and pass it.
    """
    with span("spgemm"):
        if method not in ("esc", "bsr", "auto"):
            raise ValueError(f"unknown method {method!r}")
        if planner not in PLANNERS:
            raise ValueError(f"unknown planner {planner!r}")
        if method == "auto":
            from nsparse_tpu_torch.ops.spgemm_bsr import choose_spgemm_path

            method = choose_spgemm_path(a, b) if plan is None else "esc"
        if method == "bsr":
            if plan is not None:
                raise ValueError(
                    "a precomputed ESC plan was supplied with method='bsr'; "
                    "use method='esc' (or 'auto') to reuse it"
                )
            from nsparse_tpu_torch.ops.spgemm_bsr import spgemm_bsr

            return spgemm_bsr(a, b)
        if plan is None and planner == "auto" and a.val.is_cuda:
            from nsparse_tpu_torch.ops.kernels.spgemm_hash import spgemm_hash

            return spgemm_hash(a, b)
        if plan is None:
            plan = (spgemm_plan(a, b).to(a.val.device) if planner == "host"
                    else spgemm_plan_device(a, b))
        return spgemm_numeric(plan, a, b)


def rap(r: CSR, a: CSR, p: CSR) -> CSR:
    """The Galerkin product R·A·P = R @ (A @ P) on one device, as an
    algebraic multigrid set-up forms each coarse operator.

    R is k×m, A m×n, P n×l, on one device, with values of one dtype,
    float32 or float64.  Both products are ``spgemm`` without a plan: on
    CUDA values the hash path (four host reads in all, its own), on the
    CPU the device planner.  The intermediate A·P stays on the device
    and is dropped once the second product is enqueued.  As with
    ``spgemm`` on a card, the sums follow the order of the card's
    atomics, so the values are not bitwise repeatable from run to run
    (the structure is).  Records the spans ``rap``, ``rap.ap`` and
    ``rap.rap`` and the counter ``rap.ap_nnz`` (nnz(A·P), which the
    first product has already read)."""
    with span("rap"):
        if r.shape[1] != a.shape[0] or a.shape[1] != p.shape[0]:
            raise ValueError(f"shape mismatch {r.shape} @ {a.shape} @ "
                             f"{p.shape}")
        dtypes = {r.val.dtype, a.val.dtype, p.val.dtype}
        if len(dtypes) != 1 or not dtypes <= {torch.float32, torch.float64}:
            raise TypeError(f"values must share one dtype, float32 or "
                            f"float64; got {sorted(map(str, dtypes))}")
        devs = {t.device for m in (r, a, p) for t in (m.rpt, m.col, m.val)}
        if len(devs) != 1:
            raise ValueError(f"operands on different devices: {devs}")
        with span("rap.ap"):
            ap = spgemm(a, p)
        count("rap.ap_nnz", ap.nnz)
        with span("rap.rap"):
            c = spgemm(r, ap)
        del ap
        return c

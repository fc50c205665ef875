"""SpGEMM C = A @ B with a reusable plan (counterpart of
``nsparse_tpu/ops/spgemm.py``, window layout only; the block path is
``ops/spgemm_bsr.py``, reached through ``spgemm(..., method=)``).

- symbolic: ``spgemm_plan`` runs the host planner (``native/``) and builds
  the window structure (``ops/spgemm_window.py``); it is one-time work per
  sparsity pattern.
- numeric: ``spgemm_numeric`` runs the window numeric phase on the device
  the plan and the values live on; new values with the same sparsity
  re-run it on the same plan.

The JAX package also has a scan/sort path, a global slab path and a
device planner; they are not ported yet (ROADMAP).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from nsparse_tpu_torch.formats.csr import CSR
from nsparse_tpu_torch.utils.device import int32_tensor, to_device

LANES = 128
CHUNK = 512  # slab chunk width: entries with more products are split


def _round_up(x: int, m: int) -> int:
    return ((max(x, 1)) + m - 1) // m * m


def spgemm_flops(a: CSR, b: CSR) -> int:
    """Total FLOPs = 2 * total intermediate products."""
    col_a = a.col[: a.nnz].long().cpu()
    deg_b = torch.diff(b.rpt.long().cpu())
    return 2 * int(deg_b[col_a].sum())


@dataclasses.dataclass(frozen=True)
class SpgemmPlan:
    """Captured sparsity computation of C = A @ B.

    Attributes:
      c_rpt: (M+1,) int32 output row pointers.
      c_col: (c_cap,) int32 output columns (sorted within rows; the tail
        past ``c_nnz`` is 0).
      shape: (M, N) of C; c_nnz: output nnz; n_products: intermediate
        products P (flops = 2 P).
      win: the window structure of the numeric phase.
      planner: the host planner that built it: ``"native"`` (C++),
        ``"numpy"`` (its fallback), or ``"jax"`` for a plan converted by
        :func:`plan_from_numpy`.
    """

    c_rpt: torch.Tensor
    c_col: torch.Tensor
    shape: Tuple[int, int]
    c_nnz: int
    n_products: int
    win: object
    planner: str

    @property
    def c_capacity(self) -> int:
        return int(self.c_col.shape[0])

    @property
    def flops(self) -> int:
        return 2 * self.n_products

    def to(self, device) -> "SpgemmPlan":
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
    """Bin-padded slab layout for the fallback pool's accumulation.

    Entries (and, recursively, their 512-product chunks) are binned by
    power-of-two product-count classes; each class-(L) member occupies L
    slab slots.  Returns the shuffle source (``src_pos[plan-order
    product]`` = its position in the source product array, pads -> zero
    sources), per-level class tables, level >= 2 gather indices, and the
    assembly (``asm_entry``, ``asm_pos``, ``res_off``).  ``targets``: the
    output-entry id of each item (default ``arange(len(ends))``).
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

    out = dict(
        src=src,
        levels=tuple(levels),
        lvl_idx=tuple(lvl_idx),
        asm_entry=(
            np.concatenate(asm_entry) if asm_entry else np.zeros(0, np.int64)
        ),
        asm_pos=np.concatenate(asm_pos) if asm_pos else np.zeros(0, np.int64),
        res_off=res_off,
        p_slab=p_slab,
    )
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


def spgemm_plan(a: CSR, b: CSR) -> SpgemmPlan:
    """Symbolic phase on the host: the window-layout plan of C = A @ B.

    The plan's tensors are on the CPU; move it with ``plan.to(device)``.
    """
    from nsparse_tpu_torch.native import (
        spgemm_plan_host_native,
        spgemm_plan_host_numpy,
    )
    from nsparse_tpu_torch.ops.spgemm_window import build_window_structure

    if a.shape[1] != b.shape[0]:
        raise ValueError(f"shape mismatch {a.shape} @ {b.shape}")
    m, n = a.shape[0], b.shape[1]
    rpt_a, col_a, _ = a.host_arrays()
    rpt_b, col_b, _ = b.host_arrays()
    nnz_a = a.nnz
    col_a = col_a[:nnz_a].astype(np.int64)
    deg_a = np.diff(rpt_a).astype(np.int64)
    deg_b = np.diff(rpt_b).astype(np.int64)

    args = (rpt_a, col_a, deg_a, rpt_b, col_b[: b.nnz], deg_b, m, n, nnz_a)
    host, planner = spgemm_plan_host_native(*args), "native"
    if host is None:
        host, planner = spgemm_plan_host_numpy(*args), "numpy"
    apos, bpos, out_pos, c_rpt, c_col, p_total, c_nnz = host
    c_cap = _round_up(c_nnz, LANES)
    if c_nnz:
        # last product of each output entry: starts are where out_pos changes
        neq = np.empty(out_pos.size, bool)
        neq[0] = True
        np.not_equal(out_pos[1:], out_pos[:-1], out=neq[1:])
        first = np.flatnonzero(neq)
        ends = np.concatenate([first[1:] - 1, [p_total - 1]]).astype(np.int32)
    else:
        ends = np.zeros(0, dtype=np.int32)

    win = build_window_structure(
        rpt_a, col_a, deg_a, rpt_b, deg_b, apos, bpos, out_pos, ends, c_rpt,
        p_total, c_nnz, c_cap, m, nnz_a, b.nnz,
    )
    if win is None:
        raise ValueError(
            "no row of C fits a window arena (empty product?); the port has "
            "only the window layout so far"
        )
    c_col_p = np.zeros(c_cap, dtype=np.int32)
    c_col_p[:c_nnz] = c_col
    return SpgemmPlan(
        c_rpt=int32_tensor(c_rpt),
        c_col=torch.from_numpy(c_col_p),
        shape=(m, n),
        c_nnz=int(c_nnz),
        n_products=int(p_total),
        win=win,
        planner=planner,
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
    ``expand`` — the run descriptors — comes from the port's own planner.
    The JAX indices are class-global; they are converted to window-local
    ones here, with the same checks ``build_window_structure`` applies.
    The index form is the JAX package's v1 plan (its v2 plans carry routed
    masks instead of indices), so the converted plan is v1.
    """
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
    fb_shuffle = fb_perm = None
    if arrays["fb_shuffle"] is not None:
        fb_shuffle = build_shuffle_plan(arrays["fb_shuffle"], arrays["fb_len"])
        fb_perm = build_shuffle_plan(arrays["fb_perm"], extras["fb_seg"])
    win = WindowStructure(
        expand=expand,
        fused=tuple(fused),
        merge=build_runcopy_plan(
            extras["mrg_src"], extras["mrg_len"], n_src,
            dst=extras["mrg_dst"], n_out=-(-extras["c_cap"] // 1024) * 1024,
        ),
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
        nnz_a=expand.nnz_a,
        nnz_b=expand.nnz_b,
    )
    return SpgemmPlan(
        c_rpt=int32_tensor(arrays["c_rpt"]),
        c_col=int32_tensor(arrays["c_col"]),
        shape=tuple(arrays["shape"]),
        c_nnz=int(arrays["c_nnz"]),
        n_products=int(arrays["n_products"]),
        win=win,
        planner="jax",
    )


def _check_numeric_inputs(plan: SpgemmPlan, a: CSR, b: CSR) -> None:
    if a.val.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"values must be float32 or float64, got {a.val.dtype}")
    if a.val.dtype != b.val.dtype:
        raise TypeError("A and B values must share a dtype")
    w = plan.win
    if (a.nnz, b.nnz) != (w.nnz_a, w.nnz_b):
        raise ValueError(
            f"plan built for nnz ({w.nnz_a}, {w.nnz_b}), "
            f"got ({a.nnz}, {b.nnz})"
        )
    devs = {a.val.device, b.val.device, plan.c_rpt.device,
            w.merge.src_off.device}
    if len(devs) != 1:
        raise ValueError(f"plan and values on different devices: {devs}")


def spgemm_numeric(plan: SpgemmPlan, a: CSR, b: CSR) -> CSR:
    """Numeric phase: C's values for these A and B values (any values with
    the sparsity the plan was built for).  Runs on the device the plan and
    the values are on; CUDA tensors go through the Hopper kernels.
    """
    from nsparse_tpu_torch.ops.spgemm_window import spgemm_numeric_window

    _check_numeric_inputs(plan, a, b)
    return spgemm_numeric_window(plan, a, b)


def spgemm_numeric_segsum(a: CSR, b: CSR) -> CSR:
    """Oracle numeric phase: plain gathers of every product and a segment
    sum into C's entries, on the values' device."""
    from nsparse_tpu_torch.native import spgemm_plan_host

    rpt_a, col_a, _ = a.host_arrays()
    rpt_b, col_b, _ = b.host_arrays()
    apos, bpos, out_pos, c_rpt, c_col, _, c_nnz = spgemm_plan_host(
        rpt_a, col_a[: a.nnz], np.diff(rpt_a).astype(np.int64), rpt_b,
        col_b[: b.nnz], np.diff(rpt_b).astype(np.int64), a.shape[0],
        b.shape[1], a.nnz,
    )
    dev = a.val.device

    def t(x):
        return int32_tensor(x).to(dev)

    prod = a.val[t(apos).long()] * b.val[t(bpos).long()]
    c_val = torch.zeros(c_nnz, dtype=a.val.dtype, device=dev)
    c_val.index_add_(0, t(out_pos).long(), prod)
    return CSR(
        rpt=t(c_rpt), col=t(c_col), val=c_val,
        shape=(a.shape[0], b.shape[1]), nnz=int(c_nnz),
    )


def spgemm(a: CSR, b: CSR, plan: SpgemmPlan | None = None,
           method: str = "esc") -> CSR:
    """C = A @ B.

    ``method``: "esc" (the window path; without a plan, builds one on the
    host and moves it to the values' device; callers who re-multiply the
    same structure should build ``spgemm_plan`` once and pass it), "bsr"
    (dense tile products for block-clustered matrices, ``spgemm_bsr``), or
    "auto" (``choose_spgemm_path`` without a plan, else "esc").
    """
    if method not in ("esc", "bsr", "auto"):
        raise ValueError(f"unknown method {method!r}")
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
    if plan is None:
        plan = spgemm_plan(a, b).to(a.val.device)
    return spgemm_numeric(plan, a, b)

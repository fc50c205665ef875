"""Row-localized window arenas for the SpGEMM numeric phase.

Counterpart of ``nsparse_tpu/ops/spgemm_window.py``, index form only.
Windows hold consecutive C rows; within a window, entries are classed by
product count into fold levels 0..3 (an entry at level k owns the strided
footprint ``{sigma + t * (W >> k)}``, and its total lands at
``F_k[sigma]`` after k halving folds), and entries with more than 8
products recurse through radix-8 fold tiers.  Rows beyond every window's
capability go to the fallback pool (slab classes, ``_build_slab_structure``,
whose sums K13 computes in one launch from the slab's own slots).

The host planner below is the JAX package's arithmetic, kept array for
array so both packages build the same plan.  What it drops is what only a
TPU needs: Benes/Clos mask routing (the port reads every permutation as
an index table) and the fused kernel's extraction piece tables.  It
builds the JAX package's two numeric forms, by the JAX rule: v2 when the
pre-rolled B bank fits ``FUSED_BANK_BUDGET`` (the port's plans are always
built for the card), else v1 (and always v1 at a budget of 0):

- v1: K2 expansion of the whole arena -> per class K3 fused reduction
  (reading through the tile permutation) -> fallback pool (K13 into the
  merge buffer) -> K4 merge run copy;
- v2: K11 builds the bank and one K1 gathers the per-piece A values
  (delivery) -> per class K3 expands its products in the kernel (classes)
  -> the fallback pool's products through the piece route (K1, K2 piece
  mode, K12), then K13 (fallback) -> K4 (merge).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Tuple

import numpy as np
import torch

from nsparse_tpu_torch.formats.csr import CSR
from nsparse_tpu_torch.ops.kernels import (
    fallback,
    gather_tiles,
    piecewise,
    runcopy,
    shuffle,
    window_fused,
)
from nsparse_tpu_torch.ops.kernels.fallback import (
    FallbackPlan,
    fallback_from_slab,
)
from nsparse_tpu_torch.ops.kernels.piecewise import (
    BIAS,
    ExpandPlan,
    PiecewisePlan,
    aligned_b_table,
    bank_rows_for,
    build_expand_plan,
    build_piecewise_plan,
)
from nsparse_tpu_torch.ops.kernels.runcopy import RunCopyPlan, build_runcopy_plan
from nsparse_tpu_torch.ops.kernels.shuffle import ShufflePlan, build_shuffle_plan
from nsparse_tpu_torch.ops.kernels.window_fused import (
    ClassPieces,
    FusedClassPlan,
    build_fused_plan,
    level_widths,
)
from nsparse_tpu_torch.tune import kernelgen
from nsparse_tpu_torch.utils.device import int32_tensor, to_device
from nsparse_tpu_torch.utils.profiling import count, span

LANES = 128           # E-arena phase granule of the JAX plan (kept for parity)
GAP_CHUNK = 1024      # zero runs are cut into chunks of at most this length
CLS_K = (1, 2, 4, 8)  # entry classes: fold level 0..3, then DEEP (len >= 9)
DEEP = 4
MAX_TIERS = 8
BLK_MIN = 65536       # class slots are padded to a multiple of this
# the v2 form needs the pre-rolled B bank (16 copies of 128 f32 lanes per
# row) within this budget; above it the plan takes the v1 form
FUSED_BANK_BUDGET = 11 * 2**20
TILE = piecewise.TILE
# entry lengths coverable per width (tier arenas V = W/4^(t-1) >= 256)
LEN_CAPS = ((64, 1024), (512, 4096), (4096, 16384))
LEN_MAX = 4096


def _round_up(x: int, m: int) -> int:
    return -(-max(int(x), 0) // m) * m


def _cls_of(lens: np.ndarray) -> np.ndarray:
    """Entry class code: fold level 0..3 for len <= 8, DEEP for len >= 9."""
    return np.searchsorted(
        np.asarray([1, 2, 4, 8], dtype=lens.dtype), lens, side="left"
    ).astype(np.int8)


def _w_need_len(maxlen: np.ndarray) -> np.ndarray:
    """Minimum window width whose tier ladder covers ``maxlen``-product
    entries (0 = any width; beyond LEN_MAX the row falls back)."""
    need = np.full(maxlen.shape, np.int64(1) << 62)
    for cap, w in reversed(LEN_CAPS):
        need = np.where(maxlen <= cap, w, need)
    return np.where(maxlen <= 8, 0, need)


def _take(starts_, lens_, need):
    """Fill the per-window intervals left to right with ``need`` slots."""
    n = starts_.shape[0]
    cum = np.cumsum(lens_, axis=1)
    prev = np.concatenate([np.zeros((n, 1), np.int64), cum[:, :-1]], axis=1)
    al = np.clip(need[:, None] - prev, 0, lens_)
    return al, prev, starts_ + al, lens_ - al


def _by_capacity(starts_, lens_):
    """Sort each window's intervals descending by length (fewest runs)."""
    o = np.argsort(-lens_, axis=1, kind="stable")
    return np.take_along_axis(starts_, o, 1), np.take_along_axis(lens_, o, 1)


def _alloc_levels(width, c0, c1, c2, c3, uw):
    """Top-down fold-slot (sigma) allocation over pow2 windows: deep units
    end-pack at the top of F3, level-3 singles below them, and the
    interval chain serves levels 2/1/0.  Returns ``(cls_ivs {level:
    (starts, alloc, prefix)}, g3, dstart)``."""
    n = width.size
    w8 = width >> 3
    w4 = width >> 2
    w2 = width >> 1
    dstart = w8 - uw
    g3 = dstart - c3
    if n and not (g3 >= 0).all():
        raise AssertionError("level-3 overcommit")
    z = np.zeros((n, 1), np.int64)
    s2 = np.concatenate([z, w8[:, None]], axis=1)
    l2 = np.concatenate([g3[:, None], g3[:, None]], axis=1)
    a2, p2, rs2, rl2 = _take(s2, l2, c2)
    s1, l1 = _by_capacity(
        np.concatenate([rs2, rs2 + w4[:, None]], axis=1),
        np.concatenate([rl2, rl2], axis=1),
    )
    a1, p1, rs1, rl1 = _take(s1, l1, c1)
    s0, l0 = _by_capacity(
        np.concatenate([rs1, rs1 + w2[:, None]], axis=1),
        np.concatenate([rl1, rl1], axis=1),
    )
    a0, p0, _, _ = _take(s0, l0, c0)

    def c32(*xs):
        return tuple(x.astype(np.int32) for x in xs)

    return (
        {0: c32(s0, a0, p0), 1: c32(s1, a1, p1), 2: c32(s2, a2, p2)},
        g3.astype(np.int32), dstart.astype(np.int32),
    )


def _group_rank(keys_win, keys_cls, sizes):
    """Rank (size-weighted prefix) of each item within its (window,
    class) group; ``keys_win`` non-decreasing at every call site."""
    n = keys_win.size
    rank = np.empty(n, np.int32)
    for c in range(int(keys_cls.max(initial=0)) + 1):
        ids = np.flatnonzero(keys_cls == c)
        if not ids.size:
            continue
        kw = keys_win[ids]
        sz = sizes[ids].astype(np.int64)
        cs = np.cumsum(sz)
        f = np.flatnonzero(np.concatenate([[True], kw[1:] != kw[:-1]]))
        cnt = np.diff(np.concatenate([f, [kw.size]]))
        base = np.repeat(cs[f] - sz[f], cnt)
        rank[ids] = cs - sz - base
    return rank


def _inverse_fill(tgt, src, n):
    """Permutation ``p`` of length n with ``p[tgt] = src``; the unset
    slots take the unused sources in ascending order."""
    p = np.full(n, -1, np.int64)
    p[tgt] = src
    used = np.zeros(n, bool)
    used[src] = True
    p[p == -1] = np.flatnonzero(~used)
    return p


def _local(glob, span: int, what: str):
    """Window-local form of a class-global index table whose slot i
    belongs to window ``i // span``; raises if an index leaves it."""
    pos_win = np.arange(glob.size, dtype=np.int64) // span
    if not (glob // span == pos_win).all():
        raise AssertionError(f"{what} index leaves its window")
    return glob - pos_win * span


@dataclasses.dataclass(frozen=True)
class WindowStructure:
    """Device tables of the window numeric phase.

    Attributes:
      expand: v1: run descriptors of the product arena (K2); None in v2.
      fused: per active class, the fused reduction (K3), tile permutation
        into fold slots included; in v2 with the class's piece tables.
      merge: the fixed-destination run copy assembling ``c_val`` from the
        class arenas and the fallback segment (K4).
      fb: the fallback pool's segment (K13): the slab's level-0 slots
        (pads -1), each member's slot in the merge buffer's fallback
        segment, the long entries' chunks and the warp table (None when
        no row falls back).
      fb_shuffle / fb_lvl_idx / fb_perm / fb_levels: the fallback pool's
        slab layout, which ``fb`` is derived from (None / () when no row
        falls back): products -> slab classes, class reduction, slab
        totals -> entry-ordered segment.  Host tables (the JAX package's
        arrays); no kernel reads them.
      pw: v2: the piece tables of the fallback pool's products (None in
        v1, or when no row falls back).
      b8_idx: v2: (b8_len,) int32 ``b.val`` index of each 8-aligned B
        table slot (-1 = zero), the bank's source (empty in v1).
      apv_idx: v2: (sum of the classes' pieces,) int32 ``a.val`` index of
        each piece of the class tables, classes concatenated (-1 = zero;
        each class reads ``[apv_lo, apv_hi)``; empty in v1).
      class_geom: ((base, slots, width, levels), ...) per active class.
      fb_off / fb_len: the fallback region of the product arena (v2: of
        the piecewise arena, which holds only the fallback pool).
      n_compact: total class-arena length (merge source prefix).
      fused_expand: the v2 form; bank_rows: the bank's rows (both forms,
        as in the JAX plan).
    """

    expand: ExpandPlan | None
    fused: Tuple[FusedClassPlan, ...]
    merge: RunCopyPlan
    fb: FallbackPlan | None
    fb_shuffle: ShufflePlan | None = dataclasses.field(
        metadata={"host": True})
    fb_lvl_idx: Tuple[torch.Tensor, ...] = dataclasses.field(
        metadata={"host": True})
    fb_perm: ShufflePlan | None = dataclasses.field(metadata={"host": True})
    pw: PiecewisePlan | None
    b8_idx: torch.Tensor
    apv_idx: torch.Tensor
    class_geom: Tuple
    fb_levels: Tuple
    fb_off: int
    fb_len: int
    n_compact: int
    fused_expand: bool
    bank_rows: int

    def to(self, device) -> "WindowStructure":
        return to_device(self, device)


def _class_pieces(ers, erb, era, slots: int, blk: int, bank_rows: int,
                  nnz_a: int):
    """The v2 piece tables of one class (the JAX planner's, flat): the
    expansion runs ``ers`` (class-local starts, ascending), ``erb`` (table
    offsets) and ``era`` (``a.val`` indices) cut at every 1024-slot
    subtile.  Returns ``(etrips, ecuts, eboffs, eends, eaidx, j2_cap)``."""
    n_steps = slots // blk
    subs = blk // TILE
    n_sub = n_steps * subs
    sub_b = np.arange(n_sub, dtype=np.int64) * TILE
    efirst = np.searchsorted(ers, sub_b, side="right") - 1
    starts_in = np.bincount(np.minimum(ers // TILE, n_sub - 1),
                            minlength=n_sub)
    at_base = np.zeros(n_sub, dtype=bool)
    at_base[ers[ers % TILE == 0] // TILE] = True
    ecount = starts_in + (~at_base).astype(np.int64)
    cnt_step = ecount.reshape(n_steps, subs)
    j2_cap = max(128, 1 << (max(int(cnt_step.sum(axis=1).max(initial=0)), 1)
                            - 1).bit_length())
    ecuts = np.zeros((n_steps, j2_cap), np.int64)
    eboffs = np.zeros((n_steps, j2_cap), np.int64)
    eaidx = np.full((n_steps, j2_cap), nnz_a, np.int64)
    eends = np.full((n_steps, j2_cap), TILE, np.int64)
    off_in_step = np.concatenate([
        np.zeros((n_steps, 1), np.int64), np.cumsum(cnt_step, axis=1)[:, :-1],
    ], axis=1).reshape(-1)
    etrips = np.stack([off_in_step, off_in_step + ecount], axis=1)
    # piece k of subtile s is run efirst[s] + k
    tsub = np.repeat(np.arange(n_sub, dtype=np.int64), ecount)
    kk = np.arange(int(ecount.sum()), dtype=np.int64) - np.repeat(
        np.cumsum(ecount) - ecount, ecount)
    rr = np.minimum(efirst[tsub] + kk, ers.size - 1)
    cut = np.clip(ers[rr] - sub_b[tsub], 0, TILE)
    eff = erb[rr] - ers[rr] + sub_b[tsub] + BIAS
    stp = tsub // subs
    pj = off_in_step[tsub] + kk
    ecuts[stp, pj] = cut
    eboffs[stp, pj] = (eff % LANES) // 8 * bank_rows + eff // LANES
    eaidx[stp, pj] = era[rr]
    # a piece ends where the next piece of its subtile starts
    eend = np.full(cut.shape, TILE, np.int64)
    same = tsub[1:] == tsub[:-1]
    eend[:-1][same] = cut[1:][same]
    eends[stp, pj] = eend
    return (etrips, ecuts.reshape(-1), eboffs.reshape(-1), eends.reshape(-1),
            eaidx.reshape(-1), j2_cap)


def build_window_structure(
    rpt_a: np.ndarray,
    col_a: np.ndarray,
    deg_a: np.ndarray,
    rpt_b: np.ndarray,
    deg_b: np.ndarray,
    apos: np.ndarray,
    bpos: np.ndarray,
    out_pos: np.ndarray,
    ends: np.ndarray,
    c_rpt: np.ndarray,
    p_total: int,
    c_nnz: int,
    c_cap: int,
    m: int,
    nnz_a: int,
    nnz_b: int,
) -> WindowStructure | None:
    """Host: the window structure of C = A @ B, or None when no row fits
    a window arena.  The window widths are ``kernelgen.WIN_MIN << j`` for
    ``j < kernelgen.N_WIN_CLASSES``."""
    from nsparse_tpu_torch.ops.spgemm import _build_slab_structure

    win_min = kernelgen.WIN_MIN
    n_win_classes = kernelgen.N_WIN_CLASSES

    if not (p_total and c_nnz):
        return None
    if p_total >= (1 << 31) - 1:
        raise ValueError("p_total exceeds int32 plan-build range")
    apos = np.asarray(apos, dtype=np.int32)
    bpos = np.asarray(bpos, dtype=np.int32)
    ends = np.asarray(ends[:c_nnz], dtype=np.int32)

    # --- per-entry / per-row stats ------------------------------------
    starts = np.concatenate([np.zeros(1, np.int32), ends[:-1] + 1])
    lens = ends - starts + 1
    ecls = _cls_of(lens)
    units = np.where(ecls == DEEP, -(-lens // 8), 1)
    kfac_e = np.where(
        ecls == DEEP, 8, np.array(CLS_K, np.int32)[np.minimum(ecls, 3)]
    )
    slot_cost = kfac_e * units
    row_of_entry = np.repeat(
        np.arange(m, dtype=np.int32), np.diff(c_rpt).astype(np.int64)
    )
    seg_len = deg_b[col_a]
    seg8 = -(-seg_len // 8) * 8
    cs8 = np.concatenate([[0], np.cumsum(seg8, dtype=np.int64)])
    p8_row = cs8[rpt_a[1:]] - cs8[rpt_a[:-1]]
    csc = np.concatenate([[0], np.cumsum(slot_cost, dtype=np.int64)])
    slab_row = csc[c_rpt[1:]] - csc[c_rpt[:-1]]
    weight = np.maximum(p8_row, slab_row)
    maxlen_row = np.zeros(m, np.int64)
    nz_rows = np.flatnonzero(np.diff(c_rpt) > 0)
    if nz_rows.size:
        maxlen_row[nz_rows] = np.maximum.reduceat(
            lens.astype(np.int64), c_rpt[nz_rows].astype(np.int64)
        )
    w_need = _w_need_len(maxlen_row).copy()

    for _attempt in range(8):
        # --- consecutive-row packing --------------------------------------
        W_MAX = win_min << (n_win_classes - 1)
        W_TARGET = min(2048, W_MAX)
        live = weight > 0
        fb_mask = (weight > W_MAX) | (maxlen_row > LEN_MAX) | (w_need > W_MAX)
        fb_rows = np.flatnonzero(fb_mask)
        if not np.any(live & ~fb_mask):
            return None

        nf = np.flatnonzero(~fb_mask)
        cls_windows = [[] for _ in range(n_win_classes)]
        if nf.size:
            p8s = p8_row[nf]
            sls = slab_row[nf]
            wns = w_need[nf]
            nes = np.diff(c_rpt).astype(np.int64)[nf]
            gapb = np.flatnonzero(np.diff(np.concatenate([[-2], nf])) != 1)
            seg_of = np.zeros(nf.size, np.int64)
            seg_of[gapb] = 1
            seg_of = np.cumsum(seg_of) - 1
            nsm = nf.size
            cp8 = np.concatenate([[0], np.cumsum(p8s)])
            csl = np.concatenate([[0], np.cumsum(sls)])
            # E-capacity pre-margin: the extraction cursor holds n_ent
            # totals plus <= 127 phase-gap slots per run
            E_MARGIN = 512
            cne = np.concatenate([[0], np.cumsum(nes)])
            run_end = np.concatenate([gapb[1:], [nsm]])
            run_end_of = run_end[seg_of]
            i = 0
            while i < nsm:
                hi = int(run_end_of[i])
                first_need = max(
                    int(p8s[i]), int(sls[i]), win_min, int(wns[i]),
                    int(nes[i]) + E_MARGIN,
                )
                w_allow = max(W_TARGET, 1 << (first_need - 1).bit_length())
                j_p8 = np.searchsorted(cp8, cp8[i] + w_allow, side="right") - 1
                j_sl = np.searchsorted(csl, csl[i] + w_allow, side="right") - 1
                j_ne = np.searchsorted(
                    cne, cne[i] + w_allow - E_MARGIN, side="right"
                ) - 1
                j = max(i + 1, min(j_p8, j_sl, j_ne, hi))
                # rows needing a wider tier ladder start their own window
                over = np.flatnonzero(wns[i + 1 : j] > w_allow)
                if over.size:
                    j = i + 1 + int(over[0])
                need = max(int(cp8[j] - cp8[i]), int(csl[j] - csl[i]))
                if need > 0:
                    wseg = int(wns[i:j].max(initial=0))
                    W = 1 << (max(need, win_min, wseg) - 1).bit_length()
                    jcls = (W // win_min).bit_length() - 1
                    cls_windows[jcls].append(nf[i:j])
                i = j
        for j in range(n_win_classes):
            cls_windows[j].sort(key=lambda a: int(a[0]))

        # --- class geometry (padded with identity windows) ----------------
        active = [j for j in range(n_win_classes) if cls_windows[j]]
        class_base, class_slots, class_nw_real, class_nw = {}, {}, {}, {}
        off = 0
        for j in active:
            W = win_min << j
            n_real = len(cls_windows[j])
            slots = _round_up(n_real * W, max(BLK_MIN, W))
            class_base[j] = off
            class_slots[j] = slots
            class_nw_real[j] = n_real
            class_nw[j] = slots // W
            off += slots
        fb_base = off
        if fb_base + int(p8_row[fb_rows].sum()) >= (1 << 31) - 1:
            raise ValueError("expansion exceeds int32 plan-build range")

        win_base, win_width, win_class, win_loc = [], [], [], []
        win_frow, win_lrow = [], []
        class_wid0 = {}
        win_of_row = np.full(m, -1, np.int32)
        wid = 0
        for j in active:
            W = win_min << j
            class_wid0[j] = wid
            for wl, rows in enumerate(cls_windows[j]):
                win_base.append(class_base[j] + wl * W)
                win_width.append(W)
                win_class.append(j)
                win_loc.append(wl)
                win_frow.append(rows[0])
                win_lrow.append(rows[-1])
                win_of_row[rows] = wid
                wid += 1
        n_wins = wid
        win_base = np.asarray(win_base, np.int32)
        win_width = np.asarray(win_width, np.int32)
        win_class = np.asarray(win_class, np.int32)
        win_loc = np.asarray(win_loc, np.int32)
        win_frow = np.asarray(win_frow, np.int64)
        win_lrow = np.asarray(win_lrow, np.int64)

        # --- tier-1 fold-slot (sigma) allocation per (window, class) -------
        win_of_entry = win_of_row[row_of_entry]
        went = np.flatnonzero(win_of_entry >= 0)
        we_win = win_of_entry[went]
        we_cls = ecls[went]
        cnt_wc = np.bincount(
            we_win.astype(np.int64) * 5 + we_cls, weights=units[went],
            minlength=n_wins * 5,
        ).astype(np.int64).reshape(n_wins, 5)
        c0w, c1w, c2w, c3w = (cnt_wc[:, k] for k in range(4))
        uw = cnt_wc[:, DEEP]
        cls_ivs, g3w, dstartw = _alloc_levels(win_width, c0w, c1w, c2w, c3w, uw)

        rank_went = _group_rank(we_win, we_cls, units[went])
        rank_of_entry = np.full(c_nnz, -1, np.int32)
        rank_of_entry[went] = rank_went

        sigma_of_entry = np.full(c_nnz, -1, np.int32)
        iv_of_entry = np.full(c_nnz, -1, np.int32)
        for cls in (0, 1, 2):
            ids = went[we_cls == cls]
            if not ids.size:
                continue
            wv_ = win_of_entry[ids]
            rr = rank_of_entry[ids]
            st_, al_, pv_ = cls_ivs[cls]
            iv = np.zeros(ids.size, np.int32)
            ncols = st_.shape[1]
            if ncols > 1:
                hi = np.flatnonzero(rr >= pv_[wv_, 1])
                if hi.size:
                    rrh = rr[hi]
                    wvh = wv_[hi]
                    ivh = np.ones(hi.size, np.int32)
                    for k in range(2, ncols):
                        ivh += rrh >= pv_[wvh, k]
                    iv[hi] = np.minimum(ivh, ncols - 1)
            sigma_of_entry[ids] = st_[wv_, iv] + rr - pv_[wv_, iv]
            iv_of_entry[ids] = iv
        ids3 = went[we_cls == 3]
        sigma_of_entry[ids3] = g3w[win_of_entry[ids3]] + rank_of_entry[ids3]
        iv_of_entry[ids3] = 0
        deep_ids0 = went[we_cls == DEEP]
        dwin0 = win_of_entry[deep_ids0]
        sigma_of_entry[deep_ids0] = dstartw[dwin0] + rank_of_entry[deep_ids0]
        iv_of_entry[deep_ids0] = 0

        # --- class fold-level table --------------------------------------
        class_geom = []
        for j in active:
            W = win_min << j
            wins_j = np.flatnonzero(win_class == j)
            lv = 0
            if np.any(c1w[wins_j] > 0):
                lv = 1
            if np.any(c2w[wins_j] > 0):
                lv = 2
            if np.any((c3w[wins_j] > 0) | (uw[wins_j] > 0)):
                lv = 3
            class_geom.append((class_base[j], class_slots[j], W, lv))

        # --- runs + entry positions ----------------------------------------
        # run tables: (window, level_id, start, len); level_id indexes the
        # class's level list (0 = F0, 1..lv = F_k, then 3 per tier)
        run_win_l, run_lvl_l, run_src_l, run_len_l = [], [], [], []
        run_id = 0
        ent_run = np.full(c_nnz, -1, np.int32)
        ent_off = np.zeros(c_nnz, np.int32)

        def _emit(wins_sel, lvl, srcs, lens_, tab, wid0=0):
            nonlocal run_id
            run_win_l.append(np.asarray(wins_sel, np.int64) + wid0)
            run_lvl_l.append(np.full(wins_sel.size, lvl, np.int32))
            run_src_l.append(np.asarray(srcs, np.int64))
            run_len_l.append(np.asarray(lens_, np.int64))
            tab[wins_sel] = run_id + np.arange(wins_sel.size)
            run_id += wins_sel.size

        rid_iv = np.full((n_wins, 3, 8), -1, np.int64)
        rid_c3 = np.full(n_wins, -1, np.int64)
        for cls in (0, 1, 2):
            st_, al_, pv_ = cls_ivs[cls]
            for i in range(st_.shape[1]):
                wsel = np.flatnonzero(al_[:, i] > 0)
                if wsel.size:
                    _emit(wsel, cls, st_[wsel, i], al_[wsel, i],
                          rid_iv[:, cls, i])
        w3 = np.flatnonzero(c3w > 0)
        if w3.size:
            _emit(w3, 3, g3w[w3], c3w[w3], rid_c3)

        small_ids = went[we_cls <= 2]
        sw = win_of_entry[small_ids]
        sc = ecls[small_ids]
        siv = iv_of_entry[small_ids]
        ent_run[small_ids] = rid_iv[sw, sc, siv]
        for cls in (0, 1, 2):
            m_ = small_ids[sc == cls]
            _, _, pv_c = cls_ivs[cls]
            ent_off[m_] = (
                rank_of_entry[m_] - pv_c[win_of_entry[m_], iv_of_entry[m_]]
            )
        ent_run[ids3] = rid_c3[win_of_entry[ids3]]
        ent_off[ids3] = rank_of_entry[ids3]

        # --- radix-8 tiers ---------------------------------------------------
        tier_perm_cls = []  # per active class: [(class-global perm, V), ...]
        for (base, slots, W, lv), j in zip(class_geom, active):
            perms_j = []
            n_w_t = class_nw[j]
            items = deep_ids0[win_class[win_of_entry[deep_ids0]] == j]
            u = units[items]
            sprev = sigma_of_entry[items]
            wloc = win_loc[win_of_entry[items]]
            v_in = W >> 3
            tier = 2
            lvl_next = lv + 1
            while items.size:
                if tier > MAX_TIERS:
                    raise AssertionError("tier recursion failed to terminate")
                V = 2 * v_in
                if V < 256:
                    raise AssertionError(
                        f"tier arena V={V} < 256 in class W={W} — "
                        "w_need routing should have prevented this"
                    )
                n_slots = n_w_t * V
                kk = np.where(u <= 2, 1, np.where(u <= 4, 2, np.where(
                    u <= 8, 3, DEEP))).astype(np.int8)
                un = np.where(kk == DEEP, -(-u // 8), 1).astype(np.int32)
                cnt = np.bincount(
                    wloc.astype(np.int64) * 5 + kk, weights=un,
                    minlength=n_w_t * 5,
                ).astype(np.int64).reshape(n_w_t, 5)
                wv_t = np.full(n_w_t, V, np.int64)
                civ, g3t, dstt = _alloc_levels(
                    wv_t, cnt[:, 0], cnt[:, 1], cnt[:, 2], cnt[:, 3],
                    cnt[:, DEEP],
                )
                rk = _group_rank(wloc, kk, un)
                sig_t = np.empty(items.size, np.int32)
                iv_t = np.zeros(items.size, np.int32)
                for cls in (1, 2):
                    m_ = np.flatnonzero(kk == cls)
                    if not m_.size:
                        continue
                    st_, al_, pv_ = civ[cls]
                    iv = (rk[m_][:, None] >= pv_[wloc[m_]]).sum(
                        axis=1, dtype=np.int32
                    ) - 1
                    iv = np.minimum(iv, st_.shape[1] - 1)
                    sig_t[m_] = st_[wloc[m_], iv] + rk[m_] - pv_[wloc[m_], iv]
                    iv_t[m_] = iv
                m3 = np.flatnonzero(kk == 3)
                sig_t[m3] = g3t[wloc[m3]] + rk[m3]
                md = np.flatnonzero(kk == DEEP)
                sig_t[md] = dstt[wloc[md]] + rk[md]

                nper = u
                ii = np.repeat(np.arange(items.size, dtype=np.int32), nper)
                cumn = np.concatenate(
                    [np.zeros(1, np.int32), np.cumsum(nper, dtype=np.int32)[:-1]]
                )
                s = np.arange(int(nper.sum()), dtype=np.int32) - np.repeat(
                    cumn, nper
                )
                kki = kk[ii]
                stride = np.int32(V) >> np.minimum(kki, 3).astype(np.int32)
                tts = np.where(kki == DEEP, s & 7, s)
                sgf = np.where(kki == DEEP, sig_t[ii] + (s >> 3), sig_t[ii])
                dstp = wloc[ii] * np.int64(V) + sgf + tts * stride
                srcp = wloc[ii] * np.int64(V) + sprev[ii] + s
                fsz = np.where(kk == DEEP, 8 * un, 1 << np.minimum(kk, 3))
                tail = fsz - u
                ti = np.repeat(np.arange(items.size, dtype=np.int32), tail)
                cumt = np.concatenate(
                    [np.zeros(1, np.int32), np.cumsum(tail, dtype=np.int32)[:-1]]
                )
                st2 = u[ti] + (
                    np.arange(int(tail.sum()), dtype=np.int32)
                    - np.repeat(cumt, tail)
                )
                kkt = kk[ti]
                stridet = np.int32(V) >> np.minimum(kkt, 3).astype(np.int32)
                ttt = np.where(kkt == DEEP, st2 & 7, st2)
                sgt = np.where(kkt == DEEP, sig_t[ti] + (st2 >> 3), sig_t[ti])
                dstt_p = wloc[ti] * np.int64(V) + sgt + ttt * stridet
                zrank = _group_rank(
                    wloc[ti], np.zeros(ti.size, np.int8),
                    np.ones(ti.size, np.int32),
                )
                srct_p = wloc[ti] * np.int64(V) + np.int64(v_in) + zrank
                permt = _inverse_fill(
                    np.concatenate([dstp, dstt_p]),
                    np.concatenate([srcp, srct_p]), n_slots,
                )
                perms_j.append((permt, int(V)))

                rid_t = np.full((n_w_t, 3, 8), -1, np.int64)
                rid_t3 = np.full(n_w_t, -1, np.int64)
                for cls in (1, 2):
                    st_, al_, pv_ = civ[cls]
                    for i in range(st_.shape[1]):
                        wsel = np.flatnonzero(al_[:, i] > 0)
                        if wsel.size:
                            _emit(wsel, lvl_next + cls - 1, st_[wsel, i],
                                  al_[wsel, i], rid_t[:, cls, i],
                                  wid0=class_wid0[j])
                w3t = np.flatnonzero(cnt[:, 3] > 0)
                if w3t.size:
                    _emit(w3t, lvl_next + 2, g3t[w3t], cnt[w3t, 3], rid_t3,
                          wid0=class_wid0[j])
                fin = kk <= 3
                fi = items[fin]
                kf = kk[fin]
                ent_off[fi] = rk[fin]
                is3 = kf == 3
                ent_run[fi[is3]] = rid_t3[wloc[fin][is3]]
                for cls in (1, 2):
                    mc = np.flatnonzero(kf == cls)
                    if not mc.size:
                        continue
                    _, _, pv_ = civ[cls]
                    wl_ = wloc[fin][mc]
                    ent_run[fi[mc]] = rid_t[wl_, cls, iv_t[fin][mc]]
                    ent_off[fi[mc]] = rk[fin][mc] - pv_[wl_, iv_t[fin][mc]]

                nxt = kk == DEEP
                items = items[nxt]
                u = un[nxt]
                sprev = sig_t[nxt]
                wloc = wloc[nxt]
                v_in = V >> 3
                tier += 1
                lvl_next += 3
            tier_perm_cls.append(perms_j)

        # --- per-window run chain + phase-matched E cursor -----------------
        all_win = np.concatenate(run_win_l) if run_win_l else np.zeros(0, np.int64)
        all_lvl = np.concatenate(run_lvl_l) if run_lvl_l else np.zeros(0, np.int32)
        all_src = np.concatenate(run_src_l) if run_src_l else np.zeros(0, np.int64)
        all_len = np.concatenate(run_len_l) if run_len_l else np.zeros(0, np.int64)

        ordw = np.argsort(all_win, kind="stable")
        srt_w = all_win[ordw]
        srt_s = all_src[ordw]
        srt_l = all_len[ordw]
        wfirst = np.flatnonzero(np.diff(np.concatenate([[-1], srt_w])) != 0)
        wcnt = np.diff(np.concatenate([wfirst, [srt_w.size]]))
        wlist = srt_w[wfirst]

        if srt_w.size:
            p_ph = (srt_s % LANES).astype(np.int64)
            q_ph = ((srt_s + srt_l) % LANES).astype(np.int64)
            chain = np.empty(srt_w.size, np.int64)
            pos = 0
            for k0, cnt in zip(wfirst, wcnt):
                k0 = int(k0)
                cnt = int(cnt)
                if cnt == 1:
                    chain[pos] = k0
                    pos += 1
                    continue
                buckets = {}
                for i in range(k0 + cnt - 1, k0 - 1, -1):
                    buckets.setdefault(int(p_ph[i]), []).append(i)
                taken = [False] * cnt
                cur = 0
                for _ in range(cnt):
                    # minimum-gap next run: an exact phase match costs 0
                    # slots; on a miss, the smallest forward phase step
                    i = -1
                    for g in range(LANES):
                        lst = buckets.get((cur + g) & (LANES - 1))
                        while lst:
                            if taken[lst[-1] - k0]:
                                lst.pop()
                                continue
                            i = lst.pop()
                            break
                        if i >= 0:
                            break
                    taken[i - k0] = True
                    chain[pos] = i
                    pos += 1
                    cur = int(q_ph[i])
            ordw = ordw[chain]
            srt_w = all_win[ordw]
            srt_s = all_src[ordw]
            srt_l = all_len[ordw]
        gap = np.empty(srt_w.size, np.int64)
        if srt_w.size:
            gap[0] = srt_s[0] % LANES
            gap[1:] = (srt_s[1:] - srt_s[:-1] - srt_l[:-1]) % LANES
            gap[wfirst] = srt_s[wfirst] % LANES
        csum = np.cumsum(gap + srt_l)
        seg0 = np.repeat(csum[wfirst] - (gap[wfirst] + srt_l[wfirst]), wcnt)
        d_loc = csum - seg0 - srt_l
        wlast = np.concatenate([wfirst[1:], [srt_w.size]]) - 1
        curw = (
            csum[wlast] - seg0[wlast] if srt_w.size else np.zeros(0, np.int64)
        )
        cur_of_win = np.zeros(n_wins, np.int64)
        cur_of_win[wlist] = curw
        bad = np.flatnonzero(cur_of_win > win_width)
        if bad.size:
            # phase gaps overflowed the E arena: force the offending
            # windows' rows into the next width class and repack
            for wbad in bad:
                lo, hi = int(win_frow[wbad]), int(win_lrow[wbad])
                w_need[lo : hi + 1] = np.maximum(
                    w_need[lo : hi + 1], 2 * int(win_width[wbad])
                )
            continue
        d_run = np.empty_like(d_loc)
        d_run[ordw] = d_loc
        break
    else:
        raise AssertionError("window packing failed to converge")

    # --- expansion layout: one run per A entry, gap runs for the slack ---
    w_rows = (
        np.concatenate([r for j in active for r in cls_windows[j]])
        if n_wins else np.zeros(0, np.int64)
    )
    fb_len = int(p8_row[fb_rows].sum())
    row_of_ae = np.repeat(np.arange(m, dtype=np.int64), deg_a)
    g_ae = win_of_row[row_of_ae]
    g_ae = np.where(g_ae < 0, n_wins, g_ae)
    aeid = np.arange(nnz_a, dtype=np.int64)
    lkey = np.where(g_ae == n_wins, 0, -seg8)
    ordae = np.lexsort((aeid, lkey, g_ae))
    sg = seg8[ordae]
    cs2 = np.cumsum(sg) - sg
    gso = g_ae[ordae]
    gfirst = np.flatnonzero(np.diff(np.concatenate([[-1], gso])) != 0)
    gcounts = np.diff(np.concatenate([gfirst, [gso.size]]))
    base_of_grp = np.concatenate([win_base, [fb_base]])
    run_start_ae = np.empty(nnz_a, np.int64)
    run_start_ae[ordae] = base_of_grp[gso] + cs2 - np.repeat(cs2[gfirst], gcounts)

    used_w = np.bincount(
        win_of_row[w_rows], weights=p8_row[w_rows], minlength=n_wins
    ).astype(np.int64)
    gs = win_base + used_w
    gl = win_width - used_w
    gap_starts, gap_lens = [gs[gl > 0]], [gl[gl > 0]]
    for j in active:
        W = win_min << j
        n_pad = class_nw[j] - class_nw_real[j]
        if n_pad:
            gap_starts.append(
                class_base[j]
                + (class_nw_real[j] + np.arange(n_pad, dtype=np.int64)) * W
            )
            gap_lens.append(np.full(n_pad, W, np.int64))
    gap_starts = np.concatenate(gap_starts)
    gap_lens = np.concatenate(gap_lens)
    nch = -(-gap_lens // GAP_CHUNK)
    gch = np.repeat(gap_starts, nch)
    # a layout without slack has no gaps, and then no gap runs
    kin = np.arange(gch.size, dtype=np.int64) - np.repeat(
        np.cumsum(nch) - nch, nch)
    gap_run_start = gch + kin * GAP_CHUNK

    keep = seg8 > 0
    n_gap = gap_run_start.size
    run_start = np.concatenate([run_start_ae[keep], gap_run_start])
    run_aidx = np.concatenate([
        np.flatnonzero(keep), np.full(n_gap, nnz_a, np.int64)
    ])
    ordr = np.argsort(run_start, kind="stable")
    rs_s = run_start[ordr]
    ra_s = run_aidx[ordr]

    # --- the 8-aligned B table and the numeric form -----------------------
    _, rpt8, b8_idx = aligned_b_table(rpt_b, deg_b)
    b8_len = int(rpt8[-1])
    bank_rows = bank_rows_for(b8_len)
    # the JAX rule, for plans built for the accelerator: the bank's f32
    # bytes (16 copies x 128 lanes x 4 bytes per row) within the budget
    fused_expand = bank_rows * 16 * 512 <= FUSED_BANK_BUDGET
    expand = pw = None
    if fused_expand:
        rb_s = np.concatenate([
            rpt8[col_a[keep]], np.zeros(n_gap, np.int64)
        ])[ordr]
        fsel = rs_s >= fb_base
        if fsel.any():
            pw = build_piecewise_plan(
                rs_s[fsel] - fb_base, rb_s[fsel], ra_s[fsel], fb_len, nnz_a,
                b8_len,
            )
    else:
        b8_idx = np.zeros(0, np.int64)
        expand = build_expand_plan(
            rs_s,
            np.concatenate([rpt_b[col_a[keep]], np.zeros(n_gap, np.int64)])[ordr],
            np.concatenate([seg_len[keep], np.zeros(n_gap, np.int64)])[ordr],
            ra_s, fb_base + fb_len, nnz_a, nnz_b,
        )

    # --- tier-1 permutation: products -> fold slots, per class ----------
    lens64 = lens.astype(np.int64)
    delta = (run_start_ae - rpt_b[col_a]).astype(np.int32)
    exp_p = delta[apos] + bpos
    wv_e = np.maximum(win_of_entry, 0)
    stride_e = (
        win_width[wv_e] >> np.minimum(ecls, np.int8(3))
    ).astype(np.int32)
    base_e = win_base[wv_e] + sigma_of_entry
    sel = np.repeat(win_of_entry >= 0, lens64)
    t_p = np.arange(p_total, dtype=np.int32)
    t_p -= np.repeat(starts, lens64)
    is_deep = np.repeat(ecls == DEEP, lens64)
    tt = np.where(is_deep, t_p & 7, t_p)
    slot_p = np.repeat(base_e, lens64)
    slot_p += np.where(is_deep, t_p >> 3, 0)
    slot_p += tt * np.repeat(stride_e, lens64)
    perm = _inverse_fill(slot_p[sel], exp_p[sel], fb_base)

    # --- per-class fused plans: tiers, extraction, entry order ----------
    if not (ent_run[went] >= 0).all():
        raise AssertionError("uncovered window entry")
    e0_w = c_rpt[win_frow].astype(np.int64)
    e1_w = c_rpt[win_lrow + 1].astype(np.int64)
    n_ent_w = e1_w - e0_w
    phi_w = e0_w % LANES
    pos_in_E = d_run[ent_run[went]] + ent_off[went]  # window-local
    rank_c = went.astype(np.int64) - e0_w[we_win]

    fused_plans = []
    class_arena_base = {}
    arena_cur = 0
    eaidx_all = []
    apv_off = 0
    for ci, ((base, slots, W, lv), j) in enumerate(zip(class_geom, active)):
        class_arena_base[j] = arena_cur
        tier_vs = [V for _, V in tier_perm_cls[ci]]
        lw = np.asarray(level_widths(W, lv, tier_vs), np.int64)
        lbase = np.concatenate([[0], np.cumsum(lw)[:-1]])

        # E slots of this class's runs (window-local), and their sources
        rsel = np.flatnonzero(win_class[all_win] == j)
        r_wl = win_loc[all_win[rsel]].astype(np.int64)
        r_lvl = all_lvl[rsel]
        r_src = all_src[rsel]
        r_len = all_len[rsel]
        r_d = d_run[rsel]
        pr_ = np.repeat(np.arange(rsel.size, dtype=np.int64), r_len)
        cuml = np.concatenate([[0], np.cumsum(r_len)[:-1]])
        kin = np.arange(pr_.size, dtype=np.int64) - cuml[pr_]
        src_off = r_src[pr_] + kin
        e_slot = r_d[pr_] + kin
        if not ((src_off < lw[r_lvl[pr_]]).all() and (e_slot < W).all()):
            raise AssertionError("extraction run leaves its window")
        ext = np.full(slots, -1, np.int64)
        ext[r_wl[pr_] * W + e_slot] = lbase[r_lvl[pr_]] + src_off

        # entry permutation per window: out[(phi + rank) % W] = E[pos]
        msk = win_class[we_win] == j
        ew = win_of_entry[went[msk]]
        ewl = win_loc[ew].astype(np.int64)
        eperm = _inverse_fill(
            ewl * W + (phi_w[ew] + rank_c[msk]) % W,
            ewl * W + pos_in_E[msk], slots,
        )
        pieces = None
        if fused_expand:
            # the class's expansion runs, cut into per-subtile pieces
            esel = (rs_s >= base) & (rs_s < base + slots)
            blk = max(BLK_MIN, W)
            etrips, ecuts, eboffs, eends, eaidx, j2_cap = _class_pieces(
                rs_s[esel] - base, rb_s[esel], ra_s[esel], slots, blk,
                bank_rows, nnz_a,
            )
            pieces = ClassPieces(etrips, ecuts, eboffs, eends, j2_cap, blk,
                                 apv_off, apv_off + eaidx.size, bank_rows)
            eaidx_all.append(eaidx)
            apv_off += eaidx.size
        fused_plans.append(build_fused_plan(
            W, slots, lv, tier_vs,
            _local(perm[base : base + slots] - base, W, "tile"),
            [_local(p, V, "tier") for p, V in tier_perm_cls[ci]],
            ext, _local(eperm, W, "entry"), pieces,
        ))
        arena_cur += slots
    arena_len = int(arena_cur)
    eaidx_cat = np.concatenate(eaidx_all) if eaidx_all \
        else np.zeros(0, np.int64)

    # --- fallback pool: whole rows beyond window capability -------------
    fb_entry_ids = np.flatnonzero(win_of_entry < 0)
    fb = fb_shuffle = fb_perm = None
    fb_levels = ()
    fb_lvl_idx = ()
    fb_drow = fb_rcnt = fb_rows_seg = None
    fb_seg = 0
    if fb_entry_ids.size:
        ends_fb = np.cumsum(lens[fb_entry_ids]) - 1
        p_total_fb = int(lens[fb_entry_ids].sum())
        src_fb_prod = (exp_p[~sel] - fb_base).astype(np.int64)
        fb_ae = np.flatnonzero(win_of_row[row_of_ae] < 0)
        padc = (seg8 - seg_len)[fb_ae]
        pr = np.repeat(np.arange(fb_ae.size, dtype=np.int64), padc)
        cump = np.concatenate([[0], np.cumsum(padc)[:-1]])
        ki = np.arange(pr.size, dtype=np.int64) - cump[pr]
        fb_interior = (
            run_start_ae[fb_ae[pr]] - fb_base + seg_len[fb_ae[pr]] + ki
        )
        slab_fb = _build_slab_structure(
            ends_fb, p_total_fb, src_fb_prod, fb_interior, fb_len, c_cap,
            targets=fb_entry_ids,
        )
        fb_shuffle = build_shuffle_plan(slab_fb["src"], n_src=fb_len)
        fb_levels = slab_fb["levels"]
        fb_lvl_idx = tuple(int32_tensor(i) for i in slab_fb["lvl_idx"])

        # entry-sorted, phase-matched fallback segment per row
        fb_ent = np.asarray(slab_fb["asm_entry"], np.int64)
        fb_pos = np.asarray(slab_fb["asm_pos"], np.int64)
        ofb = np.argsort(fb_ent, kind="stable")
        rows_fb = row_of_entry[fb_ent[ofb]]
        rfirst = np.flatnonzero(np.diff(np.concatenate([[-1], rows_fb])) != 0)
        rcnt = np.diff(np.concatenate([rfirst, [rows_fb.size]]))
        c0r = c_rpt[rows_fb[rfirst]].astype(np.int64)
        gapf = np.empty(rfirst.size, np.int64)
        gapf[0] = c0r[0] % LANES
        gapf[1:] = (c0r[1:] - c0r[:-1] - rcnt[:-1]) % LANES
        csf = np.cumsum(gapf + rcnt)
        fb_drow = csf - rcnt
        fb_seg = _round_up(max(int(csf[-1]), slab_fb["res_off"]), LANES)
        pos_in_seg = np.repeat(fb_drow, rcnt) + (
            np.arange(rows_fb.size, dtype=np.int64) - np.repeat(rfirst, rcnt)
        )
        fb_perm = build_shuffle_plan(
            _inverse_fill(pos_in_seg, fb_pos[ofb], fb_seg), n_src=fb_seg
        )
        fb_rcnt = rcnt
        fb_rows_seg = rows_fb[rfirst]
        # K13's tables: the slab's slots less the zeros it pads with (the
        # runs' interior pads), each entry's slot in the segment
        real = np.ones(fb_len, bool)
        real[fb_interior] = False
        fb = fallback_from_slab(
            fb_shuffle.idx.numpy(), fb_levels, slab_fb["lvl_idx"],
            fb_pos[ofb], pos_in_seg, real, fb_seg)

    # --- merge: per-window entry runs (wrap-aware) + fallback rows ------
    out_base_w = np.array(
        [class_arena_base[win_class[w]] for w in range(n_wins)], np.int64
    ) + win_loc.astype(np.int64) * win_width
    wnz = np.flatnonzero(n_ent_w > 0)
    n1 = np.minimum(n_ent_w[wnz], win_width[wnz] - phi_w[wnz])
    n2 = n_ent_w[wnz] - n1
    r_src = [out_base_w[wnz] + phi_w[wnz]]
    r_dst = [e0_w[wnz]]
    r_len = [n1]
    wrap = np.flatnonzero(n2 > 0)
    if wrap.size:
        r_src.append(out_base_w[wnz[wrap]])
        r_dst.append(e0_w[wnz[wrap]] + n1[wrap])
        r_len.append(n2[wrap])
    if fb_drow is not None:
        r_src.append(arena_len + fb_drow)
        r_dst.append(c_rpt[fb_rows_seg].astype(np.int64))
        r_len.append(fb_rcnt)
    mrg_src = np.concatenate(r_src)
    mrg_dst = np.concatenate(r_dst)
    mrg_len = np.concatenate(r_len)
    ordm = np.argsort(mrg_dst, kind="stable")
    merge = build_runcopy_plan(
        mrg_src[ordm], mrg_len[ordm], arena_len + fb_seg,
        dst=mrg_dst[ordm], n_out=_round_up(c_cap, 1024),
    )

    return WindowStructure(
        expand=expand,
        fused=tuple(fused_plans),
        merge=merge,
        fb=fb,
        fb_shuffle=fb_shuffle,
        fb_lvl_idx=fb_lvl_idx,
        fb_perm=fb_perm,
        pw=pw,
        b8_idx=int32_tensor(b8_idx),
        apv_idx=int32_tensor(np.where(eaidx_cat < nnz_a, eaidx_cat, -1)),
        class_geom=tuple(class_geom),
        fb_levels=fb_levels,
        fb_off=0 if fused_expand else int(fb_base),
        fb_len=int(fb_len),
        n_compact=arena_len,
        fused_expand=bool(fused_expand),
        bank_rows=int(bank_rows),
    )


def apv_values(w: WindowStructure, a_val: torch.Tensor,
               gather=shuffle.gather) -> torch.Tensor:
    """v2: the per-piece A values of every class's piece tables, classes
    concatenated (0 for gap and table-pad pieces) — one K1 gather."""
    return gather(a_val, w.apv_idx)


class NumericOps(NamedTuple):
    """The kernels of the routed numeric phases, by role: window v1 runs
    expand, fused, fallback and runcopy; window v2 runs bank, gather,
    fused_v2, pieces, tiles8, fallback and runcopy; the global slab layout
    (``spgemm.spgemm_numeric_slab``) runs bank, gather, pieces or
    pieces_flat, tiles8, and scatter where the plan has run-dense
    subtiles."""

    gather: object
    expand: object
    fused: object
    runcopy: object
    bank: object
    fused_v2: object
    pieces: object
    tiles8: object
    pieces_flat: object
    scatter: object
    fallback: object


KERNEL_OPS = NumericOps(
    shuffle.gather, piecewise.piecewise_expand,
    window_fused.fused_class_apply, runcopy.runcopy, piecewise.build_bank,
    window_fused.fused_class_expand, piecewise.expand_pieces,
    gather_tiles.gather_tiles8, piecewise.expand_pieces_flat,
    gather_tiles.scatter_tiles, fallback.fallback_sum,
)
PLAIN_OPS = NumericOps(
    shuffle.gather_plain, piecewise.expand_plain,
    window_fused.fused_class_plain, runcopy.runcopy_plain,
    piecewise.build_bank_plain, window_fused.fused_class_expand_plain,
    piecewise.expand_pieces_plain, gather_tiles.gather_tiles8_plain,
    piecewise.expand_pieces_flat_plain, gather_tiles.scatter_tiles_plain,
    fallback.fallback_sum_plain,
)


def v2_delivery(w: WindowStructure, a_val: torch.Tensor, b_val: torch.Tensor,
                ops: NumericOps = KERNEL_OPS):
    """v2 delivery: the bank (K11) and the per-piece A values (K1)."""
    return (ops.bank(w.b8_idx, w.bank_rows, b_val),
            apv_values(w, a_val, ops.gather))


def merge_buffer(w: WindowStructure, like: torch.Tensor) -> torch.Tensor:
    """The merge source: the class arenas laid end to end (each class's
    K3 writes its slice), then the fallback segment (K13 writes it)."""
    return torch.empty(w.merge.n_src, dtype=like.dtype, device=like.device)


def _class_slices(w: WindowStructure, res: torch.Tensor):
    """Each class's slice of the merge buffer, in class order."""
    off = 0
    for fp in w.fused:
        yield fp, res[off : off + fp.slots]
        off += fp.slots


def v2_classes(w: WindowStructure, bank: torch.Tensor, apv: torch.Tensor,
               res: torch.Tensor, ops: NumericOps = KERNEL_OPS) -> None:
    """v2 classes: each class's entry-ordered arena (K3 v2), into its
    slice of the merge buffer ``res``."""
    for fp, out in _class_slices(w, res):
        ops.fused_v2(fp, bank, apv[fp.apv_lo : fp.apv_hi], out=out)


def fallback_segment(w: WindowStructure, prod: torch.Tensor,
                     res: torch.Tensor,
                     ops: NumericOps = KERNEL_OPS) -> torch.Tensor:
    """The fallback rows' entry-ordered merge segment, written into its
    slice of the merge buffer ``res`` from the fallback pool's products
    in ``prod`` (K13, one launch); returns the slice.  Counts the entries
    (alignment gaps included) and products it sums, from the plan."""
    count("numeric.window.fallback.entries", w.fb.n_out)
    count("numeric.window.fallback.products", w.fb.n_products)
    return ops.fallback(w.fb, prod[w.fb_off : w.fb_off + w.fb_len],
                        out=res[w.n_compact :])


def v2_fallback(w: WindowStructure, a_val: torch.Tensor, bank: torch.Tensor,
                res: torch.Tensor,
                ops: NumericOps = KERNEL_OPS) -> torch.Tensor:
    """v2 fallback: the pool's products through the piece route (K1, one
    K2 piece-mode launch, K12), then :func:`fallback_segment`."""
    prod = piecewise.expand_from_bank(w.pw, a_val, bank, ops.gather,
                                      ops.pieces, ops.tiles8, ops.pieces_flat,
                                      ops.scatter)
    return fallback_segment(w, prod, res, ops)


def merge_segments(plan, res: torch.Tensor, ops: NumericOps = KERNEL_OPS):
    """``c_val`` from the merge buffer ``res``, whose class arenas K3 and
    whose fallback segment K13 have written (K4)."""
    c_val = ops.runcopy(plan.win.merge, res)[: plan.c_capacity]
    c_val[plan.c_nnz :] = 0  # the capacity tail past nnz(C) holds zeros
    return c_val


def spgemm_numeric_window(plan, a: CSR, b: CSR,
                          ops: NumericOps = KERNEL_OPS) -> CSR:
    """Window numeric phase, in the plan's form.  v1: K2 expansion -> per
    class K3 fused reduction -> fallback pool (K13) -> K4 merge.  v2:
    delivery (K11, K1) -> classes (K3 v2) -> fallback (piece route, then
    K13) -> merge (K4).  Each class's K3 writes its slice of one merge
    buffer, and K13 the fallback segment behind them.

    ``ops=PLAIN_OPS`` runs the plain PyTorch version of every kernel on
    the inputs' device — the reference the kernels are timed and checked
    against on the card.

    Each stage is a span (``utils.profiling``): ``numeric.window.expand``
    (v1) or ``numeric.window.delivery`` (v2), then ``.classes``,
    ``.fallback`` and ``.merge``; the fallback stage counts its entries
    and products (``numeric.window.fallback.entries``, ``.products``).
    """
    w: WindowStructure = plan.win
    res = merge_buffer(w, a.val)
    if w.fused_expand:
        with span("numeric.window.delivery"):
            bank, apv = v2_delivery(w, a.val, b.val, ops)
        with span("numeric.window.classes"):
            v2_classes(w, bank, apv, res, ops)
        if w.fb is not None:
            with span("numeric.window.fallback"):
                v2_fallback(w, a.val, bank, res, ops)
    else:
        with span("numeric.window.expand"):
            prod = ops.expand(w.expand, a.val, b.val)
        with span("numeric.window.classes"):
            for (fp, out), (base, slots, _, _) in zip(_class_slices(w, res),
                                                      w.class_geom):
                ops.fused(fp, prod[base : base + slots], out=out)
        if w.fb is not None:
            with span("numeric.window.fallback"):
                fallback_segment(w, prod, res, ops)
    with span("numeric.window.merge"):
        c_val = merge_segments(plan, res, ops)
    return CSR(
        rpt=plan.c_rpt,
        col=plan.c_col,
        val=c_val,
        shape=plan.shape,
        nnz=plan.c_nnz,
    )

"""Product expansion, the pre-rolled B bank, and kernels K2 and K11.

Counterpart of ``nsparse_tpu/ops/kernels/piecewise.py``.  Two plan forms
expand products ``a.val[e] * b.val[j]``:

- :class:`ExpandPlan` (the v1 window numeric): every arena slot belongs
  to one run ``(start, b_start, live_len, aidx)`` that reads ``b.val``
  directly; K2 writes arena order.
- :class:`PiecewisePlan` (the v2 numeric expands its fallback pool with
  it, the global slab layout its whole product arena): per 1024-slot
  subtile, a J-budget table of pieces ``(cut, source code)`` whose
  per-piece A values come from one K1 gather; K2's piece mode writes a
  class-major compact buffer in one launch over every class (the classes'
  tables merged, :class:`PieceTables`), and K12 (``gather_tiles8``)
  restores arena order.  Run-dense subtiles (more pieces than the largest budget, 128:
  at most 128 runs of 8 or more products start in a subtile, so it takes
  runs with no products, from B rows with no entries) go element-wise, as
  in the JAX plan: K1 gathers of their table and A values, and K6
  (``scatter_tiles``) writes them into the arena.

The pieces read the 8-aligned B table behind ``BIAS`` zero slots, in one
of the JAX package's two modes:

- aligned (a bank of at most ``BANK_ROWS_MAX`` rows): the bank
  (:func:`build_bank`, K11) holds the table in ``BANK_K`` copies, each
  rolled 8 slots further, so that bank-row code ``k * bank_rows + q``
  names the 1024 table slots from ``128 q + 8 k - BIAS`` on.  The bank is
  the JAX array element for element; on the TPU it made every piece one
  aligned slice.
- unaligned (a larger bank): the code is a flat offset into the table
  itself (K11 with one copy, ``flat_table_rows`` rows of 128), and K2's
  flat mode reads ``table[code + p]``.  The JAX package's unaligned mode
  reads raw ``b.val`` at these offsets, which point into the 8-aligned
  table, so its C is wrong wherever a B row's degree is not a multiple
  of 8; the port reads the 8-aligned table.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from nsparse_tpu_torch.ops.kernels import cuda_lib, gather_tiles, shuffle
from nsparse_tpu_torch.tune import kernelgen
from nsparse_tpu_torch.utils.device import int32_tensor as t
from nsparse_tpu_torch.utils.device import to_device

LANES = 128
TILE = 1024                 # slots per subtile (8 x 128 on the TPU)
SUB = 8                     # subtiles per class group (the TPU grid step)
SUPER = SUB * TILE          # the piecewise arena is padded to this
BIAS = 2048                 # zero slots in front of the B table
SRC_ROWS = 16               # the JAX unaligned kernel's rows per piece read
BANK_K = kernelgen.BANK_K
BANK_ROWS_MAX = kernelgen.BANK_ROWS_MAX
J_CLASSES = kernelgen.PW_J_CLASSES
MAX_J = 128                 # K2 piece mode's piece table (csrc/expand.cu)
MAX_CLASSES = 8             # K2 piece mode's class table (csrc/expand.cu)


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


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


def _check_values(plan, a_val: torch.Tensor, b_val: torch.Tensor):
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


# -- the pre-rolled B bank (K11) ---------------------------------------------


def bank_rows_for(nnz_b8: int) -> int:
    """Bank rows (of 128 slots) for an 8-aligned B table of ``nnz_b8``
    slots: the BIAS zeros, the table and a subtile of slack, rounded to
    64 rows (the block of the JAX bank kernel)."""
    rows = (BIAS + _round_up(nnz_b8 + TILE + LANES, LANES)) // LANES
    return _round_up(rows, 64)


def aligned_b_table(rpt_b: np.ndarray, deg_b: np.ndarray):
    """Host: the 8-aligned B table, every B row padded to a multiple of 8
    slots.  Returns ``(deg8, rpt8, b8_idx)``: padded row lengths, row
    pointers, and the ``b.val`` index of each slot (-1 = a pad zero)."""
    deg_b = np.asarray(deg_b, dtype=np.int64)
    deg8 = -(-deg_b // 8) * 8
    rpt8 = np.zeros(deg8.size + 1, dtype=np.int64)
    np.cumsum(deg8, out=rpt8[1:])
    row = np.repeat(np.arange(deg8.size, dtype=np.int64), deg8)
    off_in = np.arange(int(rpt8[-1]), dtype=np.int64) - rpt8[row]
    b8_idx = np.where(off_in < deg_b[row],
                      np.asarray(rpt_b, np.int64)[row] + off_in, -1)
    return deg8, rpt8, b8_idx


def flat_table_rows(nnz_b8: int) -> int:
    """Rows (of 128) of the unaligned mode's flat table: the BIAS zeros
    and the 8-aligned table with the JAX package's slack (a subtile and
    the SRC_ROWS rows its kernel reads per piece)."""
    return (BIAS + _round_up(nnz_b8 + TILE + SRC_ROWS * LANES, LANES)) \
        // LANES


def _check_bank_args(b8_idx: torch.Tensor, bank_rows: int, copies: int):
    if BIAS + b8_idx.numel() > bank_rows * LANES:
        raise ValueError(f"{b8_idx.numel()} table slots do not fit "
                         f"{bank_rows} bank rows")
    if not 0 < 8 * copies <= bank_rows * LANES:
        raise ValueError(f"{copies} copies of a {bank_rows}-row bank")


def build_bank_plain(b8_idx: torch.Tensor, bank_rows: int,
                     b_val: torch.Tensor, copies: int = BANK_K
                     ) -> torch.Tensor:
    """Plain PyTorch version of K11."""
    _check_bank_args(b8_idx, bank_rows, copies)
    n = bank_rows * LANES
    dev = b_val.device
    j = torch.full((n,), -1, dtype=torch.long, device=dev)
    j[BIAS : BIAS + b8_idx.numel()] = b8_idx.long()
    flat = shuffle.gather_plain(b_val, j)
    roll = (torch.arange(n, device=dev)[None, :]
            + 8 * torch.arange(copies, device=dev)[:, None]) % n
    return flat[roll].reshape(copies * bank_rows, LANES)


def build_bank(b8_idx: torch.Tensor, bank_rows: int,
               b_val: torch.Tensor, copies: int = BANK_K) -> torch.Tensor:
    """K11: the (copies * bank_rows, 128) bank of B values.  Copy k is
    the flat table ``flat[j] = b_val[b8_idx[j - BIAS]]`` (0 outside the
    table, where ``b8_idx`` is -1 or outside ``b_val``) rolled by -8k:
    ``bank[k * bank_rows * 128 + t] = flat[(t + 8k) mod (bank_rows * 128)]``.
    The aligned piece mode reads ``BANK_K`` copies; one copy is the flat
    table of the unaligned mode.

    CPU tensors take :func:`build_bank_plain`; CUDA tensors launch the
    kernel (``csrc/build_bank.cu``) or raise.
    """
    if b_val.is_cpu:
        return build_bank_plain(b8_idx, bank_rows, b_val, copies)
    _check_bank_args(b8_idx, bank_rows, copies)
    out = b_val.new_empty(copies * bank_rows, LANES)
    cuda_lib.launch("build_bank", "nsp_build_bank", b_val, b_val.numel(),
                    b8_idx, b8_idx.numel(), bank_rows, BIAS, copies, out)
    build_bank.launches += 1
    return out


build_bank.launches = 0


# -- the piece-table expansion (K2 piece mode) -------------------------------


@dataclasses.dataclass(frozen=True)
class PieceTables:
    """The piece tables of every class of a plan, merged for one K2
    launch.

    Attributes:
      rows: per class with subtiles, ``(first compact subtile, J, first
        piece)`` on the host.
      cls: (len(rows), 3) int32, the same rows for the kernel.
      cuts / boffs: the classes' piece tables concatenated (class c's
        subtile s has its J pieces from ``first piece + s * J``).
      n_sub: compact subtiles, all classes.
    """

    rows: Tuple[Tuple[int, int, int], ...] = dataclasses.field(
        metadata={"host": True})
    cls: torch.Tensor
    cuts: torch.Tensor
    boffs: torch.Tensor
    n_sub: int

    def to(self, device) -> "PieceTables":
        return to_device(self, device)

    def classes(self):
        """Per row: (J, first compact subtile, subtiles, first piece)."""
        ends = [r[0] for r in self.rows[1:]] + [self.n_sub]
        return [(j, first, end - first, q0)
                for (first, j, q0), end in zip(self.rows, ends)]


def merge_piece_tables(j_budgets, cuts, boffs) -> PieceTables:
    """:class:`PieceTables` from per-class tables (budget J, cuts, boffs
    of whole J-piece subtiles, in compact order); classes with no
    subtiles get no row."""
    rows, first, q0 = [], 0, 0
    for j, c, b in zip(j_budgets, cuts, boffs):
        j, n = int(j), int(np.asarray(c).size)
        if not 0 < j <= MAX_J or n % j or np.asarray(b).size != n:
            raise ValueError(f"piece tables of budget {j} (at most {MAX_J}) "
                             "must be whole subtiles of one length")
        if n:
            rows.append((first, j, q0))
        first += n // j
        q0 += n
    if len(rows) > MAX_CLASSES:
        raise ValueError(f"{len(rows)} piece classes exceed {MAX_CLASSES}")

    def cat(parts):
        parts = [np.asarray(x, np.int64).reshape(-1) for x in parts]
        return t(np.concatenate(parts) if parts else np.zeros(0, np.int64))

    return PieceTables(
        rows=tuple(rows), cls=t(np.asarray(rows, np.int64).reshape(-1, 3)),
        cuts=cat(cuts), boffs=cat(boffs), n_sub=int(first))


@dataclasses.dataclass(frozen=True)
class PiecewisePlan:
    """Piece tables of the expansion of a product arena ``[0, n)`` (zero
    beyond ``n``, padded to ``n_pad``) from the 8-aligned B table.

    Attributes:
      ids: per class of ``J_CLASSES``, (n_groups * SUB,) int32 arena
        subtile ids (-1 = group pad, a zero tile).
      cuts: per class, (n_groups * SUB * J,) int32 piece starts within
        each subtile, non-decreasing (TILE or more = inert piece).
      boffs: per class, (n_groups * SUB * J,) int32 source codes: bank-row
        codes in the aligned mode, flat table offsets in the unaligned one.
      apv_idx: (sum of the classes' pieces,) int32 ``a.val`` index of
        every piece, classes concatenated (-1 = zero: gap and pad runs);
        ``apv_splits`` bound each class's slice.
      arena_src: (n_pad / TILE,) int32 compact tile of each arena tile;
        dead subtiles name the tile past the compact buffer (the JAX
        plan's trailing zero tile), which K12 reads as zeros.
      fb_ids: (n_fb,) int32 run-dense subtiles; fb_bidx / fb_aidx: (n_fb
        * TILE,) int32 8-aligned table index (-1 = zero) and ``a.val``
        index (``nnz_a`` = zero) of each of their slots.
      n, n_pad, nnz_a: arena, padded arena and ``a.val`` sizes; nnz_b:
        the 8-aligned B table's length; aligned: the mode; bank_rows: the
        bank the aligned mode reads (0 in the unaligned mode).
      pieces: ``cuts`` and ``boffs`` of every class merged for K2's one
        launch (derived; the per-class tuples are the JAX plan's).
    """

    ids: Tuple[torch.Tensor, ...]
    cuts: Tuple[torch.Tensor, ...]
    boffs: Tuple[torch.Tensor, ...]
    apv_idx: torch.Tensor
    arena_src: torch.Tensor
    fb_ids: torch.Tensor
    fb_bidx: torch.Tensor
    fb_aidx: torch.Tensor
    apv_splits: Tuple[Tuple[int, int], ...]
    n: int
    n_pad: int
    nnz_a: int
    nnz_b: int
    aligned: bool
    bank_rows: int
    pieces: PieceTables

    @property
    def n_compact(self) -> int:
        """Tiles of the class-major compact buffer."""
        return sum(int(i.shape[0]) for i in self.ids)

    @property
    def table_rows(self) -> int:
        """Rows (of 128) of what the pieces read: the bank, or the flat
        table."""
        return self.bank_rows if self.aligned else flat_table_rows(self.nnz_b)

    def to(self, device) -> "PiecewisePlan":
        return to_device(self, device)


def _check_codes(code: np.ndarray, bank_rows: int, what: str) -> None:
    """Each piece reads the 1024 bank slots from row ``code`` on."""
    if code.size and not ((code >= 0)
                          & (code <= BANK_K * bank_rows - TILE // LANES)).all():
        raise ValueError(f"{what}: bank row outside the bank")


def build_piecewise_plan(run_start, run_boff, run_aidx, n: int, nnz_a: int,
                         nnz_b: int) -> PiecewisePlan:
    """Host: route runs into per-subtile piece tables, in the aligned mode
    when the bank fits ``BANK_ROWS_MAX`` rows, else the unaligned mode
    (the JAX package's rule and tables).

    ``run_start``: non-decreasing product positions where a run begins
    (run 0 at 0; a run with no products starts where the next one does),
    multiples of 8; ``run_boff``: the 8-aligned table offset of each
    run's first product, a multiple of 8; ``run_aidx``: its ``a.val``
    index (``nnz_a`` for gap runs); ``nnz_b``: the aligned table's
    length.  ``[n, n_pad)`` is routed as one pad run of zeros.
    """
    run_start = np.asarray(run_start, dtype=np.int64)
    run_boff = np.asarray(run_boff, dtype=np.int64)
    run_aidx = np.asarray(run_aidx, dtype=np.int64)
    n_pad = _round_up(max(n, 1), SUPER)
    if not ((run_start % 8 == 0).all() and (run_boff % 8 == 0).all()):
        raise ValueError("aligned pieces need 8-aligned runs and offsets")
    if run_start.size and (run_start[0] != 0
                           or not (np.diff(run_start) >= 0).all()):
        raise ValueError("piece runs must start at 0 and ascend")
    if not ((run_aidx >= 0) & (run_aidx <= nnz_a)).all():
        raise ValueError("piece run A index out of range")
    rows_tot = bank_rows_for(nnz_b)
    aligned = rows_tot <= BANK_ROWS_MAX
    if not aligned:
        rows_tot = 0

    # the pad run: zero a.val slot, table offset 0
    run_start = np.concatenate([run_start, [n]])
    run_boff = np.concatenate([run_boff, [0]])
    run_aidx = np.concatenate([run_aidx, [nnz_a]])
    n_runs = run_start.size

    n_sub = n_pad // TILE
    sub_base = np.arange(n_sub, dtype=np.int64) * TILE
    first = np.searchsorted(run_start, sub_base, side="right") - 1
    starts_in = np.bincount(
        np.minimum(run_start // TILE, n_sub - 1), minlength=n_sub
    )
    # a run starting exactly at the tile base replaces the continuation
    at_base = np.zeros(n_sub, dtype=bool)
    at_base[run_start[(run_start % TILE == 0) & (run_start < n_pad)]
            // TILE] = True
    count = starts_in + (~at_base).astype(np.int64)

    # dead subtiles (only gap and pad runs) get no class: they read zeros
    pref = np.concatenate([[0], np.cumsum(run_aidx != nnz_a)])
    lo = np.maximum(first, 0)
    hi = np.minimum(first + count, n_runs)
    sub_live = pref[np.maximum(hi, lo)] - pref[lo] > 0

    cls_of = np.full(n_sub, -1, np.int64)
    for ci, J in enumerate(J_CLASSES):
        cls_of[sub_live & (cls_of < 0) & (count <= J)] = ci

    ids, cuts_l, boffs_l, aidx_l = [], [], [], []
    cpos_of = np.full(n_sub, -1, np.int64)
    cbase = 0
    for ci, J in enumerate(J_CLASSES):
        subs = np.flatnonzero(cls_of == ci).astype(np.int64)
        padded = np.full(-(-subs.size // SUB) * SUB, -1, np.int64)
        padded[: subs.size] = subs
        ids.append(padded)
        if not subs.size:
            cuts_l.append(np.zeros(0, np.int64))
            boffs_l.append(np.zeros(0, np.int64))
            aidx_l.append(np.zeros(0, np.int64))
            continue
        cpos_of[subs] = cbase + np.arange(subs.size)
        cbase += padded.size
        sc = np.maximum(padded, 0)
        # piece k of subtile s is run first[s] + k while k < count[s];
        # group pads carry only inert pieces (cut == TILE)
        k = np.arange(J, dtype=np.int64)
        r = first[sc][:, None] + k[None, :]
        valid = ((k[None, :] < count[sc][:, None]) & (r < n_runs)
                 & (padded >= 0)[:, None])
        rc = np.minimum(r, n_runs - 1)
        base = sub_base[sc][:, None]
        cut = np.where(valid, np.maximum(run_start[rc] - base, 0), TILE)
        eff = run_boff[rc] - run_start[rc] + base + BIAS
        if aligned:
            # bank-row code: eff = 128 q + 8 k -> row q of copy k
            boff = np.where(valid,
                            (eff % LANES) // 8 * rows_tot + eff // LANES, 0)
        else:
            boff = np.where(valid, eff, BIAS)
        # inert pieces repeat the previous piece's A index (the JAX
        # package keeps its gather stream near-monotone); never read
        flat = np.where(valid, run_aidx[rc], -1).reshape(-1)
        last = np.maximum.accumulate(
            np.where(flat >= 0, np.arange(flat.size), -1))
        ai = np.where(last >= 0, flat[np.maximum(last, 0)], 0)
        cuts_l.append(cut.reshape(-1))
        boffs_l.append(boff.reshape(-1))
        aidx_l.append(ai)

    # arena tile -> compact tile; dead and run-dense subtiles name the
    # tile past the end
    arena_src = np.where(cpos_of >= 0, cpos_of, cbase)
    # run-dense subtiles, element by element
    fb_subs = np.flatnonzero(sub_live & (cls_of < 0)).astype(np.int64)
    pos = (fb_subs[:, None] * TILE + np.arange(TILE)[None, :]).reshape(-1)
    ridx = np.searchsorted(run_start, pos, side="right") - 1
    fb_bidx = np.where(pos < n, run_boff[ridx] + pos - run_start[ridx], -1)
    fb_aidx = np.where(pos < n, run_aidx[ridx], 0)

    n_tbl = flat_table_rows(nnz_b) * LANES
    for J, c, b in zip(J_CLASSES, cuts_l, boffs_l):
        # a piece at or past TILE is inert: the cuts must ascend up to it
        # (a run with no products may leave one past TILE before the pads)
        c2 = np.minimum(c.reshape(-1, J), TILE)
        if c2.size and not (c2 >= 0).all() or (np.diff(c2, axis=1) < 0).any():
            raise ValueError("piece cuts must ascend inside their subtile")
        # only a piece that starts inside its subtile is ever read
        live = b[c < TILE]
        if aligned:
            _check_codes(live, rows_tot, "piece table")
        elif live.size and not ((live >= 0) & (live + TILE <= n_tbl)).all():
            raise ValueError("piece table: offset outside the flat table")

    aidx_cat = np.concatenate(aidx_l)
    splits, off = [], 0
    for a in aidx_l:
        splits.append((off, off + a.size))
        off += a.size
    return PiecewisePlan(
        ids=tuple(t(i) for i in ids),
        cuts=tuple(t(c) for c in cuts_l),
        boffs=tuple(t(b) for b in boffs_l),
        apv_idx=t(np.where(aidx_cat == nnz_a, -1, aidx_cat)),
        arena_src=t(arena_src),
        fb_ids=t(fb_subs), fb_bidx=t(fb_bidx), fb_aidx=t(fb_aidx),
        apv_splits=tuple(splits),
        n=int(n), n_pad=int(n_pad), nnz_a=int(nnz_a), nnz_b=int(nnz_b),
        aligned=bool(aligned), bank_rows=int(rows_tot),
        pieces=merge_piece_tables(J_CLASSES, cuts_l, boffs_l),
    )


def _check_pieces(tables: PieceTables, apv, src, out):
    if apv.numel() != tables.cuts.numel():
        raise ValueError(f"{apv.numel()} A values for "
                         f"{tables.cuts.numel()} pieces")
    if out.numel() != tables.n_sub * TILE:
        raise ValueError(f"{out.numel()} output slots for {tables.n_sub} "
                         "subtiles")
    if apv.dtype != src.dtype or out.dtype != src.dtype:
        raise TypeError("apv, the table and out must share a dtype")


def piece_sources(tables: PieceTables, row_scale: int = LANES):
    """Per slot of each compact subtile: its piece (an index into the
    merged tables: the last piece of its subtile whose cut is <= the slot,
    -1 if none) and its flat source index ``code * row_scale + slot``
    (row_scale 128: bank-row codes; 1: flat offsets)."""
    dev = tables.cuts.device
    pos = torch.arange(TILE, device=dev)
    sel, sidx = [], []
    for j, _, n, q0 in tables.classes():
        c = tables.cuts[q0 : q0 + n * j].view(n, j).long()
        s = torch.searchsorted(c, pos.expand(n, TILE).contiguous(),
                               right=True) - 1
        bo = tables.boffs[q0 : q0 + n * j].view(n, j).long().gather(
            1, s.clamp(min=0))
        base = q0 + torch.arange(n, device=dev)[:, None] * j
        sel.append(torch.where(s >= 0, base + s, -1))
        sidx.append(bo * row_scale + pos)
    if not sel:
        empty = torch.zeros(0, TILE, dtype=torch.long, device=dev)
        return empty, empty
    return torch.cat(sel), torch.cat(sidx)


def _pieces_plain(tables, apv, src, out, row_scale):
    _check_pieces(tables, apv, src, out)
    if not tables.n_sub:
        return out
    sel, sidx = piece_sources(tables, row_scale)
    out.view(tables.n_sub, TILE)[:] = torch.where(
        sel >= 0, src.reshape(-1)[sidx] * apv[sel.clamp(min=0)], 0)
    return out


def expand_pieces_plain(tables: PieceTables, apv: torch.Tensor,
                        bank: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K2's piece mode (fills ``out``), class by
    class."""
    return _pieces_plain(tables, apv, bank, out, LANES)


def expand_pieces_flat_plain(tables: PieceTables, apv: torch.Tensor,
                             table: torch.Tensor,
                             out: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K2's flat mode (fills ``out``)."""
    return _pieces_plain(tables, apv, table, out, 1)


def _launch_pieces(what: str, tables: PieceTables, apv, src, out,
                   row_scale: int) -> bool:
    """K2's piece kernel once over every class; False when there is no
    subtile (nothing launched)."""
    _check_pieces(tables, apv, src, out)
    if not tables.n_sub:
        return False
    cuda_lib.launch(what, "nsp_expand_pieces", src, apv, tables.cuts,
                    tables.boffs, tables.cls, len(tables.rows), tables.n_sub,
                    row_scale, out)
    return True


def expand_pieces(tables: PieceTables, apv: torch.Tensor, bank: torch.Tensor,
                  out: torch.Tensor) -> torch.Tensor:
    """K2 piece mode: every class's subtiles into ``out`` (the compact
    buffer), in one launch.  Slot p of a subtile takes the last of its J
    pieces whose cut is <= p, ``bank[boff * 128 + p] * apv[piece]``, and 0
    where no piece starts at or before p.

    CPU tensors take :func:`expand_pieces_plain`; CUDA tensors launch the
    kernel (``csrc/expand.cu``) or raise.
    """
    if out.device.type == "cpu":
        return expand_pieces_plain(tables, apv, bank, out)
    if _launch_pieces("expand_pieces", tables, apv, bank, out, LANES):
        expand_pieces.launches += 1
    return out


expand_pieces.launches = 0


def expand_pieces_flat(tables: PieceTables, apv: torch.Tensor,
                       table: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
    """K2 flat mode (the unaligned piece mode): as :func:`expand_pieces`,
    but slot p of a piece reads ``table[boff + p]`` from the flat table
    (the plan checks that every read lies inside it).

    CPU tensors take :func:`expand_pieces_flat_plain`; CUDA tensors launch
    the kernel (``csrc/expand.cu``, row scale 1) or raise.
    """
    if out.device.type == "cpu":
        return expand_pieces_flat_plain(tables, apv, table, out)
    if _launch_pieces("expand_pieces_flat", tables, apv, table, out, 1):
        expand_pieces_flat.launches += 1
    return out


expand_pieces_flat.launches = 0


def build_table(plan: PiecewisePlan, b8_idx: torch.Tensor,
                b_val: torch.Tensor, bank=build_bank) -> torch.Tensor:
    """What the plan's pieces read, by K11: the BANK_K-copy bank in the
    aligned mode, the one-copy flat table in the unaligned mode."""
    return bank(b8_idx, plan.table_rows, b_val,
                BANK_K if plan.aligned else 1)


def expand_from_bank(plan: PiecewisePlan, a_val: torch.Tensor,
                     bank: torch.Tensor, gather=shuffle.gather,
                     pieces=expand_pieces,
                     tiles8=gather_tiles.gather_tiles8,
                     pieces_flat=expand_pieces_flat,
                     scatter=gather_tiles.scatter_tiles) -> torch.Tensor:
    """The (n_pad,) product arena of a :class:`PiecewisePlan`: per-piece A
    values (K1), every class's pieces into the class-major compact buffer
    in one K2 launch (piece mode from the bank, or flat mode from the flat
    table; both from :func:`build_table`), then arena order (K12);
    run-dense subtiles element-wise (K1 twice, K6).  The kernel arguments
    let a caller pass their plain versions."""
    if a_val.numel() < plan.nnz_a:
        raise ValueError("a.val shorter than the plan's nnz")
    if a_val.dtype != bank.dtype:
        raise TypeError("a.val and the bank must share a dtype")
    rows = plan.table_rows * (BANK_K if plan.aligned else 1)
    if bank.shape != (rows, LANES):
        raise ValueError(f"table of shape {tuple(bank.shape)} for a plan "
                         f"that reads {rows} rows")
    run = pieces if plan.aligned else pieces_flat
    apv = gather(a_val, plan.apv_idx)
    compact = torch.empty(plan.n_compact * TILE, dtype=a_val.dtype,
                          device=a_val.device)
    run(plan.pieces, apv, bank, compact)
    arena = tiles8(compact, plan.arena_src)
    if plan.fb_ids.numel():
        # copy 0 of the bank, like the flat table, is the 8-aligned table
        # behind BIAS zeros, so index -1 lands on a zero
        flat = bank.reshape(-1)
        vals = gather(flat, plan.fb_bidx + BIAS) * gather(a_val, plan.fb_aidx)
        scatter(arena, plan.fb_ids, vals, TILE)
    return arena


def piecewise_expand(plan, a_val: torch.Tensor, b_val: torch.Tensor,
                     bank: torch.Tensor | None = None) -> torch.Tensor:
    """The product arena for these values (any values, same sparsity —
    the numeric re-run contract).

    An :class:`ExpandPlan` launches K2 (run form; CPU tensors take
    :func:`expand_plain`, CUDA tensors the kernel, ``csrc/expand.cu``, or
    raise).  A :class:`PiecewisePlan` takes the piece route of
    :func:`expand_from_bank` on ``bank`` (from :func:`build_table`; only
    its dtype is read from ``b_val``).
    """
    if isinstance(plan, PiecewisePlan):
        if bank is None:
            raise ValueError("a PiecewisePlan expands from its table: pass "
                             "bank=build_table(plan, b8_idx, b_val)")
        if b_val.dtype != a_val.dtype:
            raise TypeError("a.val and b.val must share a dtype")
        return expand_from_bank(plan, a_val, bank)
    if a_val.device.type == "cpu":
        return expand_plain(plan, a_val, b_val)
    _check_values(plan, a_val, b_val)
    out = torch.empty(plan.n, dtype=a_val.dtype, device=a_val.device)
    if plan.n_runs:
        cuda_lib.launch("piecewise_expand", "nsp_expand", a_val, b_val,
                        plan.run_start, plan.b_start, plan.live_len,
                        plan.aidx, plan.n_runs, out)
        piecewise_expand.launches += 1
    return out


piecewise_expand.launches = 0

"""Block-sparse SpGEMM: C = A @ B over dense (bs, bs) tiles (counterpart of
``nsparse_tpu/ops/spgemm_bsr.py``).

Matrices whose nonzeros cluster into dense-ish blocks (FEM stiffness,
multi-DOF meshes) admit a path of dense tile products: blockify A and B on
the host, plan the block-level product structure (every pair of an A tile
(i, k) and a B tile (k, j), sorted by the C tile (i, j)), and run one
kernel over the pairs (K9, ``ops/kernels/bsr_blocks.py``).  Zero fill-in
inside tiles is the price; ``plan_spgemm_bsr`` reports the fill ratio and
``choose_spgemm_path`` weighs the tile pairs against the ESC products.

The plan equals the JAX package's array for array; it adds one derived
table, ``c_pair_start``, the start of each C tile's run of pairs, which
the kernel's blocks read in place of a sequential grid.  f64 runs through
K9 natively (the JAX einsum branch exists because a TPU custom call cannot
carry f64).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from nsparse_tpu_torch.formats.csr import CSR
from nsparse_tpu_torch.ops.kernels import bsr_blocks
from nsparse_tpu_torch.ops.kernels.flat_gather import (
    FlatGatherPlan,
    build_flat_gather_plan,
    flat_gather,
)
from nsparse_tpu_torch.ops.spgemm import spgemm_flops
from nsparse_tpu_torch.tune import kernelgen
from nsparse_tpu_torch.utils.device import int32_tensor, to_device

def _int32(x: np.ndarray, what: str) -> np.ndarray:
    """Non-negative ``x`` as int32, raising where a value would reach 2**31
    (JAX casts silently)."""
    if x.size and x.max() >= 1 << 31:
        raise ValueError(f"{what} reaches 2**31: too large for int32 indices")
    return x.astype(np.int32)


def _blockify(a: CSR, bs: int):
    """Host: CSR -> (blocks (nb, bs, bs), block_row, block_col, fill_idx,
    valid).

    ``fill_idx`` maps every block slot to its source position in the CSR
    value array, so new values re-blockify on the device with one planned
    gather; structural-padding slots point at the block's first real source
    and are zeroed by ``valid``.
    """
    import scipy.sparse as sp

    m, n = a.shape
    s = a.to_scipy()
    mp = (m + bs - 1) // bs * bs
    np_ = (n + bs - 1) // bs * bs
    s.resize((mp, np_))
    b = s.tobsr(blocksize=(bs, bs))
    b.sort_indices()
    indptr = np.asarray(b.indptr)
    brow = np.repeat(
        np.arange(len(indptr) - 1, dtype=np.int32), np.diff(indptr)
    )
    # the same blockification of the 1-based source positions (exact in
    # float64) gives the slot -> source map; 0 slots are padding
    si = sp.csr_matrix(
        (np.arange(1, a.nnz + 1, dtype=np.float64), s.indices, s.indptr),
        shape=(mp, np_),
    ).tobsr(blocksize=(bs, bs))
    si.sort_indices()
    fill = np.asarray(si.data).astype(np.int64).reshape(-1, bs * bs) - 1
    valid = fill >= 0
    big = np.int64(1) << 60
    minsrc = np.where(valid, fill, big).min(axis=1)
    minsrc = np.where(minsrc == big, 0, minsrc)
    fill = np.where(valid, fill, minsrc[:, None])
    return (
        np.asarray(b.data),
        brow,
        np.asarray(b.indices, dtype=np.int32),
        _int32(fill, "a fill index").reshape(-1, bs, bs),
        valid.reshape(-1, bs, bs),
    )


@dataclasses.dataclass(frozen=True)
class BsrSpgemmPlan:
    """Block-product schedule for C = A @ B on dense tiles.

    Attributes:
      a_blocks / b_blocks: (nba + 1 | nbb + 1, bs, bs) dense tiles, the
        last one zero (kept so the tiles equal the JAX plan's).
      pair_a / pair_b: (npair,) int32 tile indices per block product.
      pair_c: (npair,) int32 output tile index, non-decreasing.
      c_pair_start: (nbc + 1,) int32 start of each C tile's run (derived).
      c_block_row / c_block_col: (nbc,) int32 C tile coordinates.
      a_fill_gp / b_fill_gp: planned gathers, CSR values -> tile slots.
      a_fill_mask / b_fill_mask: (slots,) float32 0/1, zero on padding.
      c_rpt / c_col: C's element-level pattern (that of |A| @ |B|).
      c_slot: (c_nnz,) int32 flat index of each C entry in the C tiles.
      shape, n_block_rows, bs; fill: stored slots / true nnz; flops: 2 x
        the intermediate products of the scalar matrices; c_nnz; nnz_a /
        nnz_b: the value counts the fill plans read.
    """

    a_blocks: torch.Tensor
    b_blocks: torch.Tensor
    pair_a: torch.Tensor
    pair_b: torch.Tensor
    pair_c: torch.Tensor
    c_pair_start: torch.Tensor
    c_block_row: torch.Tensor
    c_block_col: torch.Tensor
    a_fill_gp: FlatGatherPlan
    b_fill_gp: FlatGatherPlan
    a_fill_mask: torch.Tensor
    b_fill_mask: torch.Tensor
    c_rpt: torch.Tensor
    c_col: torch.Tensor
    c_slot: torch.Tensor
    shape: Tuple[int, int]
    n_block_rows: int
    bs: int
    fill: float
    flops: int
    c_nnz: int
    nnz_a: int
    nnz_b: int

    @property
    def n_pairs(self) -> int:
        return int(self.pair_a.shape[0])

    @property
    def n_c_blocks(self) -> int:
        return int(self.c_block_row.shape[0])

    def to(self, device) -> "BsrSpgemmPlan":
        return to_device(self, device)


def _block_pairs(a_brow, a_bcol, b_brow, b_bcol, nbc_a, nbc_b):
    """Every (A tile (i, k), B tile (k, j)) pair in (i, j, a_id, b_id)
    order.  Returns (pair_a, pair_b, pair_c, c_pair_start, c_block_row,
    c_block_col) as int64 arrays."""
    b_ptr = np.zeros(nbc_a + 1, dtype=np.int64)
    np.cumsum(np.bincount(b_brow, minlength=nbc_a), out=b_ptr[1:])
    first_b = b_ptr[a_bcol]
    cnt = b_ptr[a_bcol.astype(np.int64) + 1] - first_b
    a_id = np.repeat(np.arange(a_bcol.size, dtype=np.int64), cnt)
    run0 = np.zeros(a_bcol.size + 1, dtype=np.int64)
    np.cumsum(cnt, out=run0[1:])
    b_id = first_b[a_id] + np.arange(a_id.size, dtype=np.int64) - run0[a_id]
    i = a_brow[a_id].astype(np.int64)
    j = b_bcol[b_id].astype(np.int64)
    order = np.lexsort((b_id, a_id, j, i))
    key = i[order] * nbc_b + j[order]
    new = np.ones(key.size, dtype=bool)
    new[1:] = key[1:] != key[:-1]
    first = np.flatnonzero(new)
    return (a_id[order], b_id[order], np.cumsum(new) - 1,
            np.append(first, key.size), key[first] // nbc_b,
            key[first] % nbc_b)


def plan_spgemm_bsr(a: CSR, b: CSR, bs: int | None = None) -> BsrSpgemmPlan:
    """Host-side block symbolic phase (block-granular ESC planning).  The
    plan's tensors are on the CPU; move it with ``plan.to(device)``."""
    bs = bs or kernelgen.BSR_BS
    if a.shape[1] != b.shape[0]:
        raise ValueError(f"shape mismatch {a.shape} @ {b.shape}")
    a_blk, a_brow, a_bcol, a_fill, a_mask = _blockify(a, bs)
    b_blk, b_brow, b_bcol, b_fill, b_mask = _blockify(b, bs)
    nbr_a = (a.shape[0] + bs - 1) // bs
    nbc_a = (a.shape[1] + bs - 1) // bs
    nbc_b = (b.shape[1] + bs - 1) // bs
    pa, pb, pc, c_start, crow, ccol = _block_pairs(
        a_brow, a_bcol, b_brow, b_bcol, nbc_a, nbc_b)

    # the trailing zero tile of the JAX plan (its TPU grid pads pair runs
    # with it); no pair of the port's plan names it
    a_blk = np.concatenate([a_blk.reshape(-1, bs, bs),
                            np.zeros((1, bs, bs), a_blk.dtype)])
    b_blk = np.concatenate([b_blk.reshape(-1, bs, bs),
                            np.zeros((1, bs, bs), b_blk.dtype)])

    # element-level C pattern (|A| @ |B|) and each entry's tile slot: the
    # extraction back to CSR is one gather, and the pattern equals the ESC
    # path's structural output (explicit zeros kept)
    sa_abs = a.to_scipy()
    sb_abs = b.to_scipy()
    sa_abs.data = np.abs(sa_abs.data) + 1.0
    sb_abs.data = np.abs(sb_abs.data) + 1.0
    cpat = (sa_abs @ sb_abs).tocsr()
    cpat.sort_indices()
    c_col = np.asarray(cpat.indices, dtype=np.int64)
    c_rows = np.repeat(
        np.arange(cpat.shape[0], dtype=np.int64), np.diff(cpat.indptr)
    )
    tile_keys = crow * nbc_b + ccol  # sorted: the pairs were (i, j) sorted
    ekey = (c_rows // bs) * nbc_b + c_col // bs
    tid = np.searchsorted(tile_keys, ekey)
    c_slot = tid * (bs * bs) + (c_rows % bs) * bs + c_col % bs

    stored = a_blk.size + b_blk.size
    return BsrSpgemmPlan(
        a_blocks=torch.from_numpy(a_blk),
        b_blocks=torch.from_numpy(b_blk),
        pair_a=int32_tensor(pa),
        pair_b=int32_tensor(pb),
        pair_c=int32_tensor(pc),
        c_pair_start=int32_tensor(_int32(c_start, "the pair count")),
        c_block_row=int32_tensor(crow),
        c_block_col=int32_tensor(ccol),
        a_fill_gp=build_flat_gather_plan(a_fill.reshape(-1)),
        b_fill_gp=build_flat_gather_plan(b_fill.reshape(-1)),
        a_fill_mask=torch.from_numpy(a_mask.reshape(-1).astype(np.float32)),
        b_fill_mask=torch.from_numpy(b_mask.reshape(-1).astype(np.float32)),
        c_rpt=int32_tensor(_int32(np.asarray(cpat.indptr), "nnz(C)")),
        c_col=int32_tensor(c_col),
        c_slot=int32_tensor(_int32(c_slot, "a C tile slot")),
        shape=(a.shape[0], b.shape[1]),
        n_block_rows=nbr_a,
        bs=bs,
        fill=stored / max(a.nnz + b.nnz, 1),
        flops=spgemm_flops(a, b),
        c_nnz=int(cpat.nnz),
        nnz_a=a.nnz,
        nnz_b=b.nnz,
    )


def tile_products(plan: BsrSpgemmPlan) -> torch.Tensor:
    """Numeric phase on the plan's own tiles: the (nbc, bs, bs) dense C
    tiles (K9)."""
    return bsr_blocks.spgemm_bsr_blocks(
        plan.a_blocks, plan.b_blocks, plan.pair_a, plan.pair_b, plan.pair_c,
        plan.c_pair_start)


def block_stats(a: CSR, b: CSR, bs: int | None = None):
    """Host-side cost probe: (block_pairs, a_fill, b_fill) at block size
    ``bs``, read by :func:`choose_spgemm_path`."""
    import scipy.sparse as sp

    bs = bs or kernelgen.BSR_BS

    def graph(m):
        s = m.to_scipy().tocoo()
        br, bc = s.row // bs, s.col // bs
        nbr = (m.shape[0] + bs - 1) // bs
        nbc = (m.shape[1] + bs - 1) // bs
        g = sp.coo_matrix(
            (np.ones(len(br)), (br, bc)), shape=(nbr, nbc)
        ).tocsr()
        g.sum_duplicates()
        g.data[:] = 1.0
        return g

    ga, gb = graph(a), graph(b)
    pairs = int((ga @ gb).sum())  # sum of products of indicator entries
    a_fill = ga.nnz * bs * bs / max(a.nnz, 1)
    b_fill = gb.nnz * bs * bs / max(b.nnz, 1)
    return pairs, a_fill, b_fill


def choose_spgemm_path(a: CSR, b: CSR, bs: int | None = None) -> str:
    """'bsr' when the dense tile products are predicted to beat the ESC
    path, and the block fill does not exceed 64x; else 'esc'.  The product
    count is taken in int64 (``spgemm_flops``)."""
    bs = bs or kernelgen.BSR_BS
    pairs, a_fill, b_fill = block_stats(a, b, bs)
    if max(a_fill, b_fill) > 64:
        return "esc"
    p = spgemm_flops(a, b) // 2
    esc_ns = p * kernelgen.ESC_NS_PER_PRODUCT
    bsr_ns = pairs * kernelgen.BSR_US_PER_PAIR * 1e3
    return "bsr" if bsr_ns < esc_ns else "esc"


def _reblock(fill_gp: FlatGatherPlan, mask: torch.Tensor, val: torch.Tensor,
             bs: int, dtype: torch.dtype) -> torch.Tensor:
    """Device-side re-blockification: CSR values -> dense tiles (and the
    plan's trailing zero tile)."""
    vp = torch.nn.functional.pad(val.to(dtype), (0, 1))
    flat = flat_gather(fill_gp, vp, other=mask.to(dtype))
    blocks = flat.reshape(-1, bs, bs)
    return torch.cat([blocks, blocks.new_zeros(1, bs, bs)])


def spgemm_bsr_numeric(plan: BsrSpgemmPlan, a: CSR, b: CSR) -> torch.Tensor:
    """Values-only re-run (the ``SpGEMM_Hash_Numeric`` analog of the block
    path): re-blockify new A and B values on their device (planned
    gathers) in the plan's dtype, then the tile products (K9).  Returns the
    dense C tiles (``spgemm_bsr`` extracts C's entries)."""
    if not (a.val.is_floating_point() and b.val.is_floating_point()):
        raise TypeError("A and B values must be floating point")
    if (a.nnz, b.nnz) != (plan.nnz_a, plan.nnz_b):
        raise ValueError(f"plan built for nnz ({plan.nnz_a}, {plan.nnz_b}), "
                         f"got ({a.nnz}, {b.nnz})")
    devs = {a.val.device, b.val.device, plan.pair_a.device}
    if len(devs) != 1:
        raise ValueError(f"plan and values on different devices: {devs}")
    ab = _reblock(plan.a_fill_gp, plan.a_fill_mask, a.val[: a.nnz], plan.bs,
                  plan.a_blocks.dtype)
    bb = _reblock(plan.b_fill_gp, plan.b_fill_mask, b.val[: b.nnz], plan.bs,
                  plan.b_blocks.dtype)
    return tile_products(dataclasses.replace(plan, a_blocks=ab, b_blocks=bb))


def spgemm_bsr(a: CSR, b: CSR, plan: BsrSpgemmPlan | None = None) -> CSR:
    """C = A @ B through dense tiles, from the plan's tile values; returns
    canonical CSR with the pattern of |A| @ |B| (explicit zeros kept), so
    the block and ESC paths are interchangeable.  Without a plan, builds
    one on the host and moves it to the values' device."""
    if plan is None:
        plan = plan_spgemm_bsr(a, b).to(a.val.device)
    blocks = tile_products(plan)
    return CSR(
        rpt=plan.c_rpt,
        col=plan.c_col,
        val=blocks.reshape(-1).index_select(0, plan.c_slot),
        shape=plan.shape,
        nnz=plan.c_nnz,
    )

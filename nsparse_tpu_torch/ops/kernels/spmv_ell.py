"""The ``plus_times`` ELL SpMV in one pass, kernel K14 (``spmv_ell``).

Replaces no TPU kernel: the JAX package expands x to one value per slab
slot through planned gathers (``flat_gather``, the x-shuffle), then
multiplies and sums each slab with XLA.  K14 gathers x itself and sums
each slab row in registers (``csrc/spmv_ell.cu``), in two launches: every
slab's slot sums, then the rows (``y[i] = slot[pos[i]]`` plus a split
row's extra chunks).

The sums have one order, which :func:`spmv_ell_plain` repeats step for
step, so the kernel and its plain version agree bit for bit: a thread
per slab row adds the terms ``val[w, r] * x[col[w, r]]`` for
``w < lens[r]`` in ascending w from 0; a split row's extra chunk sums are
added to its first chunk's in the order of its ``split_slots`` row.  Every product and
sum is rounded on its own.
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from nsparse_tpu_torch.formats.ell import ELL
from nsparse_tpu_torch.ops.kernels import cuda_lib
from nsparse_tpu_torch.utils.profiling import count, span

BLOCK_THREADS = 256  # the kernel's block: a thread per slab row
MAX_SLABS = 32       # the kernel's slab table (csrc/spmv_ell.cu:kMaxSlabs)
FIELDS = 7           # table int64s a slab (csrc/spmv_ell.cu:kFields)


@dataclasses.dataclass(frozen=True)
class SlabTable:
    """K14's launch table of one ELL on the card, built once per ELL
    (:func:`slab_table`, kept as ``ELL.slab_table``).

    Attributes:
      table: host int64 array, per slab (widest first): values, columns
        and lengths pointers, rows, width, first output slot, first
        block.
      n_slabs, n_blocks, n_slots: slabs, blocks of the first launch, and
        the slot sums it writes (the slabs' rows, in the ELL's order).
      slots: the stored slots (``ELL.padded_nnz``).
      device: the slabs' card.
      split_run: (row blocks + 1,) int32 on the card, the first split row
        of each block of BLOCK_THREADS rows of the second launch
        (``searchsorted`` of ``split_rows``), or None without split rows.
    """

    table: ctypes.Array
    n_slabs: int
    n_blocks: int
    n_slots: int
    slots: int
    device: torch.device
    split_run: torch.Tensor | None


def slab_table(a: ELL) -> SlabTable:
    """The slab table of ``a``, whose tensors must lie on one card (raises
    ValueError or TypeError otherwise).  The pointers stay valid while
    ``a`` lives: a frozen ELL holds its tensors and never swaps them."""
    if len(a.vals) > MAX_SLABS:
        raise ValueError(f"spmv_ell: {len(a.vals)} slabs, at most "
                         f"{MAX_SLABS}")
    if not (len(a.vals) == len(a.cols) == len(a.lens)):
        raise ValueError("spmv_ell: slab values, columns and lengths differ "
                         "in number")
    splits = () if a.split_rows is None else (a.split_rows, a.split_slots)
    if a.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"spmv_ell: values must be float32 or float64, got "
                        f"{a.dtype}")
    index, _, _ = cuda_lib.validate("spmv_ell", *a.vals, *a.cols, *a.lens,
                                    a.pos, *splits)
    slot0, off = [], 0
    for val, col, ln in zip(a.vals, a.cols, a.lens):
        if val.dim() != 2 or col.shape != val.shape \
                or ln.shape != (val.shape[1],):
            raise ValueError("spmv_ell: a slab's values, columns and "
                             "lengths do not match")
        slot0.append(off)
        off += val.shape[1]
    fields, block = [], 0
    for i in sorted(range(len(a.vals)), key=lambda i: -a.vals[i].shape[0]):
        w, r = a.vals[i].shape
        fields += [a.vals[i].data_ptr(), a.cols[i].data_ptr(),
                   a.lens[i].data_ptr(), r, w, slot0[i], block]
        block += -(-r // BLOCK_THREADS)
    split_run = None
    if a.split_rows is not None:
        starts = torch.arange(0, a.shape[0] + BLOCK_THREADS, BLOCK_THREADS,
                              device=a.split_rows.device)
        split_run = torch.searchsorted(a.split_rows.long(), starts,
                                       out_int32=True)
    return SlabTable(
        table=(ctypes.c_int64 * max(len(fields), 1))(*fields),
        n_slabs=len(a.vals), n_blocks=block, n_slots=off,
        slots=a.padded_nnz, device=torch.device("cuda", index),
        split_run=split_run)


def spmv_ell_plain(a: ELL, x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K14: the kernel's sums in the kernel's
    order (the module's docstring), a slab's rows side by side."""
    xs = x if x.numel() else x.new_zeros(1)  # no slot reads an empty x
    outs = []
    for val, col, ln in zip(a.vals, a.cols, a.lens):
        ln = ln.long()
        acc = val.new_zeros(val.shape[1])
        for w in range(val.shape[0]):
            prod = val[w] * xs[col[w].long()]
            acc = acc + torch.where(w < ln, prod, 0)
        outs.append(acc)
    slot = torch.cat(outs)
    y = slot[a.pos.long()]
    if a.split_rows is not None:
        rows = a.split_rows.long()
        for j in range(a.split_slots.shape[1]):
            s = a.split_slots[:, j].long()
            y[rows] = y[rows] + torch.where(s >= 0, slot[s.clamp(min=0)], 0)
    return y


def spmv_ell(a: ELL, x: torch.Tensor) -> torch.Tensor:
    """K14: y = A @ x for the ELL ``a`` (``plus_times``).

    CPU tensors take :func:`spmv_ell_plain`; CUDA tensors launch the
    kernel twice (``csrc/spmv_ell.cu``: the slabs, in span ``spmv.slabs``,
    then the rows, in span ``spmv.rows``) or raise.  Counters (while
    recording): ``spmv.ell.k14`` (+1 a call) and ``spmv.ell.k14.slots``
    (the slots stored).
    """
    if x.dtype != a.dtype:
        raise TypeError(f"spmv_ell: x is {x.dtype}, values {a.dtype}")
    if x.dim() != 1 or x.numel() != a.shape[1]:
        raise ValueError(f"spmv_ell: x of shape {tuple(x.shape)} for a "
                         f"matrix of {a.shape[1]} columns")
    if a.vals[0].device.type == "cpu" and x.device.type == "cpu":
        return spmv_ell_plain(a, x)
    t = a.slab_table
    if x.device != t.device:
        raise ValueError(f"spmv_ell: x on {x.device}, the slabs on "
                         f"{t.device}")
    return _launch(a, x, t)


def _launch(a: ELL, x: torch.Tensor, t: SlabTable) -> torch.Tensor:
    """The kernel's two launches on the slabs of table ``t``."""
    m = a.shape[0]
    slot = torch.empty(t.n_slots, dtype=a.dtype, device=x.device)
    y = torch.empty(m, dtype=a.dtype, device=x.device)
    with span("spmv.slabs"):
        cuda_lib.launch("spmv_ell", "nsp_spmv_ell_slabs", x, slot, t.table,
                        t.n_slabs, t.n_blocks)
    with span("spmv.rows"):
        if a.split_rows is None:
            split = (0, 0, 0, 0)
        else:
            split = (a.split_rows, a.split_slots, t.split_run,
                     a.split_slots.shape[1])
        cuda_lib.launch("spmv_ell", "nsp_spmv_ell_rows", slot, a.pos, m,
                        *split, y)
    spmv_ell.launches += 2
    count("spmv.ell.k14")
    count("spmv.ell.k14.slots", t.slots)
    return y


spmv_ell.launches = 0

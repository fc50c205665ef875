"""Row-block partitioning of CSR matrices (counterpart of
``nsparse_tpu/parallel/partition.py``).

Each shard holds a contiguous row block with the full column range, as
one tensor per array on its own device.  The JAX padding contract is
kept, so the stacked views (``rpt``, ``col``, ``val``) equal the JAX
package's ``(D, ...)`` arrays: one shared capacity rounded to 128, row
pointer tails repeating the local nnz, padded slots holding ``col 0, val
0``, the last shard zero-padded to ``m_loc`` rows.  A SpGEMM result keeps
each shard's own plan capacity; its stacked views pad to the largest.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from nsparse_tpu_torch.formats.csr import CSR


def _round_up(x: int, m: int) -> int:
    return (max(x, 1) + m - 1) // m * m


def stack_padded(ts, fill=0) -> torch.Tensor:
    """The per-shard tensors ``ts`` padded with ``fill`` to the longest
    and stacked on the first one's device: the JAX package's ``(D, ...)``
    layout."""
    n = max(int(t.shape[0]) for t in ts)
    dev = ts[0].device
    return torch.stack([
        torch.nn.functional.pad(t.to(dev), (0, n - int(t.shape[0])),
                                value=fill)
        for t in ts
    ])


@dataclasses.dataclass(frozen=True)
class PartitionedCSR:
    """D row blocks of a global (M, N) CSR, one tensor per shard.

    Attributes:
      rpts: D (m_loc + 1,) int32 local row pointers (0-based per shard).
      cols: D int32 column indices (global column space), padded.
      vals: D value arrays, padded with zeros.
      shape: global (M, N); m_loc: rows per shard (the last zero-padded);
      nnz: global nnz; shard_nnz: each shard's nnz (its ``rpt[-1]``, kept
        on the host so that no call reads it back from a device).
    """

    rpts: Tuple[torch.Tensor, ...]
    cols: Tuple[torch.Tensor, ...]
    vals: Tuple[torch.Tensor, ...]
    shape: Tuple[int, int]
    m_loc: int
    nnz: int
    shard_nnz: Tuple[int, ...]

    @property
    def n_shards(self) -> int:
        return len(self.rpts)

    @property
    def capacity(self) -> int:
        return max(int(v.shape[0]) for v in self.vals)

    @property
    def dtype(self) -> torch.dtype:
        return self.vals[0].dtype

    @property
    def rpt(self) -> torch.Tensor:
        """(D, m_loc + 1) stacked row pointers."""
        return stack_padded(self.rpts)

    @property
    def col(self) -> torch.Tensor:
        """(D, capacity) stacked column indices."""
        return stack_padded(self.cols)

    @property
    def val(self) -> torch.Tensor:
        """(D, capacity) stacked values."""
        return stack_padded(self.vals)

    def shard(self, d: int) -> CSR:
        """Shard ``d`` as a CSR over (m_loc, N), padded arrays kept."""
        return CSR(rpt=self.rpts[d], col=self.cols[d], val=self.vals[d],
                   shape=(self.m_loc, self.shape[1]), nnz=self.shard_nnz[d])

    def with_values(self, vals) -> "PartitionedCSR":
        """Same sparsity, new values: one array per shard (the rows of a
        ``(D, capacity)`` tensor will do), each placed with its shard."""
        return dataclasses.replace(self, vals=tuple(
            v.to(old.device) for v, old in zip(vals, self.vals)))


def split_rows(rpt, col, val, m: int, n_shards: int, cap_multiple: int,
               col_shift=None):
    """Host arrays of the row blocks: (m_loc, per-shard rpt, col, val,
    nnz), columns moved by ``col_shift(d)`` where given."""
    m_loc = (m + n_shards - 1) // n_shards
    bounds = [(d * m_loc, min((d + 1) * m_loc, m)) for d in range(n_shards)]
    caps = [int(rpt[r1] - rpt[r0]) if r1 > r0 else 0 for r0, r1 in bounds]
    cap = _round_up(max(caps), cap_multiple)
    rpts, cols, vals, nnzs = [], [], [], []
    for d, (r0, r1) in enumerate(bounds):
        rpt_s = np.zeros(m_loc + 1, np.int32)
        col_s = np.zeros(cap, np.int32)
        val_s = np.zeros(cap, val.dtype)
        if r1 > r0:
            base = int(rpt[r0])
            loc = rpt[r0 : r1 + 1] - base
            rpt_s[: r1 - r0 + 1] = loc
            rpt_s[r1 - r0 + 1 :] = loc[-1]  # padded rows are empty
            nloc = int(loc[-1])
            c = col[base : base + nloc]
            col_s[:nloc] = c if col_shift is None else c - col_shift(d)
            val_s[:nloc] = val[base : base + nloc]
        rpts.append(rpt_s)
        cols.append(col_s)
        vals.append(val_s)
        nnzs.append(int(rpt_s[-1]))
    return m_loc, rpts, cols, vals, tuple(nnzs)


def place(arrays, mesh, default):
    """Host arrays as tensors, shard ``d``'s on ``mesh.devices[d]`` (or
    all on ``default`` without a mesh)."""
    devs = mesh.devices if mesh is not None else [default] * len(arrays)
    return tuple(torch.from_numpy(x).to(dev) for x, dev in zip(arrays, devs))


def partition_rows(a: CSR, n_shards: int, cap_multiple: int = 128,
                   mesh=None) -> PartitionedCSR:
    """Split ``a`` into ``n_shards`` contiguous row blocks (host-side);
    shard ``d`` goes to ``mesh.devices[d]``, or to ``a``'s device without
    a mesh."""
    rpt, col, val = a.host_arrays()
    m_loc, rpts, cols, vals, nnzs = split_rows(rpt, col, val, a.shape[0],
                                               n_shards, cap_multiple)
    dev = a.device
    return PartitionedCSR(
        rpts=place(rpts, mesh, dev), cols=place(cols, mesh, dev),
        vals=place(vals, mesh, dev), shape=a.shape, m_loc=m_loc, nnz=a.nnz,
        shard_nnz=nnzs)


def local_spmv(rpt: torch.Tensor, col: torch.Tensor, val: torch.Tensor,
               x: torch.Tensor, m_loc: int, nnz: int | None = None
               ) -> torch.Tensor:
    """SpMV on one shard's padded arrays, its valid range carried by the
    row pointers: the padded tail goes to a sentinel row ``m_loc`` (its
    slots are val-0 no-ops anyway).  Given the shard's ``nnz`` the tail is
    skipped: its atomic adds into the one sentinel row would serialize
    on a card."""
    n = col.shape[0] if nnz is None else nnz
    idx = torch.arange(n, dtype=rpt.dtype, device=rpt.device)
    rows = torch.searchsorted(rpt, idx, right=True) - 1
    rows = rows.clamp(0, m_loc)
    prod = val[:n] * x[col[:n].long()]
    y = torch.zeros(m_loc + 1, dtype=prod.dtype, device=prod.device)
    return y.index_add_(0, rows, prod)[:m_loc]

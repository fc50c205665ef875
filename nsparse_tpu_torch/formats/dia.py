"""DIA (diagonal) format of the PyTorch port (counterpart of
``nsparse_tpu/formats/dia.py``).

A matrix stored by diagonals computes ``y = sum_d vals[d] * shift(x,
off_d)``: no column indices, every term a contiguous read of x.  Only
diagonals holding most of the entries are kept; ``from_csr`` rejects
matrices whose entries do not concentrate on a few diagonals.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from nsparse_tpu_torch.formats.csr import CSR
from nsparse_tpu_torch.utils.device import int32_tensor, to_device

LANES = 128


@dataclasses.dataclass(frozen=True)
class DIA:
    """Diagonal-major storage.

    Attributes:
      vals: (ndiag, Mp) values, Mp = M rounded up to 128;
        ``vals[d, i] = A[i, i + offsets[d]]`` (0 where absent).
      offsets: ascending diagonal offsets (col - row).
      shape: (M, N).
      nnz: entries stored on the kept diagonals.
      off_t: the offsets as an int32 tensor beside ``vals`` (what the
        kernel reads).
    """

    vals: torch.Tensor
    offsets: Tuple[int, ...]
    shape: Tuple[int, int]
    nnz: int
    off_t: torch.Tensor

    @property
    def dtype(self) -> torch.dtype:
        return self.vals.dtype

    @property
    def ndiag(self) -> int:
        return len(self.offsets)

    @property
    def padded_nnz(self) -> int:
        return int(self.vals.numel())

    @classmethod
    def from_numpy(cls, vals, offsets, shape, nnz) -> "DIA":
        """From host arrays (a JAX DIA's fields)."""
        return cls(vals=torch.from_numpy(np.array(vals)),
                   offsets=tuple(int(o) for o in offsets),
                   shape=(int(shape[0]), int(shape[1])), nnz=int(nnz),
                   off_t=int32_tensor(offsets))

    @classmethod
    def from_csr(cls, a: CSR, max_diags: int = 64,
                 min_coverage: float = 0.95) -> "DIA":
        """Host-side conversion; raises ValueError when fewer than
        ``min_coverage`` of the entries lie on the ``max_diags`` fullest
        diagonals."""
        m, n = a.shape
        rpt, col, val = a.host_arrays()
        nnz = a.nnz
        col = col[:nnz]
        val = val[:nnz]
        rows = np.repeat(np.arange(m, dtype=np.int64), np.diff(rpt))
        offs = col.astype(np.int64) - rows

        uniq, counts = np.unique(offs, return_counts=True)
        order = np.argsort(-counts)
        keep = uniq[order[:max_diags]]
        covered = counts[order[:max_diags]].sum()
        if nnz and covered < min_coverage * nnz:
            raise ValueError(
                f"matrix is not diagonal: {len(uniq)} diagonals, "
                f"top-{max_diags} cover {covered / nnz:.1%} < "
                f"{min_coverage:.0%}")
        keep = np.sort(keep)

        mp = (m + LANES - 1) // LANES * LANES
        vals = np.zeros((len(keep), mp), dtype=val.dtype)
        on_kept = np.isin(offs, keep)
        vals[np.searchsorted(keep, offs[on_kept]), rows[on_kept]] = \
            val[on_kept]
        return cls.from_numpy(vals, keep, (m, n), int(on_kept.sum()))

    def to(self, device) -> "DIA":
        return to_device(self, device)

    def to_dense(self) -> torch.Tensor:
        """(M, N) dense tensor of the kept diagonals."""
        m, n = self.shape
        out = torch.zeros(self.shape, dtype=self.dtype,
                          device=self.vals.device)
        for d, off in enumerate(self.offsets):
            i = torch.arange(max(0, -off), min(m, n - off),
                             device=self.vals.device)
            out[i, i + off] = self.vals[d, i]
        return out

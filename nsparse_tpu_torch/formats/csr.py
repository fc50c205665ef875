"""CSR container of the PyTorch port.

Counterpart of ``nsparse_tpu/formats/csr.py``.  The JAX class pads its
arrays to a static capacity because XLA needs static shapes; PyTorch runs
eagerly, so a matrix built here holds exactly ``nnz`` entries.  A SpGEMM
result keeps the plan's 128-padded capacity (``col``/``val`` longer than
``nnz``), as the JAX result does, so the two compare array for array.

Canonical form: per-row column indices sorted ascending, duplicates summed.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class CSR:
    """Compressed sparse row matrix.

    Attributes:
      rpt: (M+1,) int32 row pointers (``rpt[M] == nnz``).
      col: (capacity,) int32 column indices (entries past ``nnz`` are 0).
      val: (capacity,) values (entries past ``nnz`` are 0).
      shape: (M, N).
      nnz: true non-zero count (<= capacity).
    """

    rpt: torch.Tensor
    col: torch.Tensor
    val: torch.Tensor
    shape: Tuple[int, int]
    nnz: int

    @classmethod
    def from_numpy(cls, rpt, col, val, shape) -> "CSR":
        """From host arrays in canonical form; arrays longer than
        ``rpt[-1]`` (a JAX CSR's padded capacity) are cut to ``nnz``."""
        rpt = np.ascontiguousarray(rpt, dtype=np.int32)
        nnz = int(rpt[-1])
        col = np.ascontiguousarray(np.asarray(col)[:nnz], dtype=np.int32)
        val = np.ascontiguousarray(np.asarray(val)[:nnz])
        if col.size != nnz or val.size != nnz:
            raise ValueError(f"col/val shorter than nnz={nnz}")
        return cls(
            rpt=torch.from_numpy(rpt),
            col=torch.from_numpy(col),
            val=torch.from_numpy(val),
            shape=(int(shape[0]), int(shape[1])),
            nnz=nnz,
        )

    @classmethod
    def from_scipy(cls, mat, dtype=None) -> "CSR":
        m = mat.tocsr()
        m.sum_duplicates()
        m.sort_indices()
        val = m.data if dtype is None else m.data.astype(dtype)
        return cls.from_numpy(m.indptr, m.indices, val, m.shape)

    @property
    def dtype(self) -> torch.dtype:
        return self.val.dtype

    @property
    def device(self) -> torch.device:
        return self.val.device

    def to(self, device) -> "CSR":
        return dataclasses.replace(
            self,
            rpt=self.rpt.to(device),
            col=self.col.to(device),
            val=self.val.to(device),
        )

    def with_values(self, val: torch.Tensor) -> "CSR":
        """Same sparsity, new values (the numeric re-run contract)."""
        if tuple(val.shape) != tuple(self.val.shape):
            raise ValueError(
                f"values of shape {tuple(val.shape)} for a matrix with "
                f"capacity {tuple(self.val.shape)}"
            )
        return dataclasses.replace(self, val=val)

    def host_arrays(self):
        """(rpt, col, val) as numpy arrays (copied off the device)."""
        return (
            self.rpt.cpu().numpy(),
            self.col.cpu().numpy(),
            self.val.cpu().numpy(),
        )

    def to_scipy(self):
        import scipy.sparse as sp

        rpt, col, val = self.host_arrays()
        nnz = self.nnz
        return sp.csr_matrix((val[:nnz], col[:nnz], rpt), shape=self.shape)

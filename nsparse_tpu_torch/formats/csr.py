"""CSR container of the PyTorch port.

Counterpart of ``nsparse_tpu/formats/csr.py``.  The JAX class pads its
arrays to a static capacity because XLA needs static shapes; PyTorch runs
eagerly, so a matrix built here holds exactly ``nnz`` entries.  A SpGEMM
result keeps the plan's 128-padded capacity (``col``/``val`` longer than
``nnz``), as the JAX result does, so the two compare array for array;
``with_capacity`` pads or cuts a matrix to a given capacity.

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

    @classmethod
    def from_dense(cls, dense) -> "CSR":
        """From a dense array or tensor (its zeros dropped)."""
        import scipy.sparse as sp

        if isinstance(dense, torch.Tensor):
            dense = dense.cpu().numpy()
        return cls.from_scipy(sp.csr_matrix(np.asarray(dense)))

    @classmethod
    def from_coo(cls, coo) -> "CSR":
        """Host-side COO -> CSR (sorted, duplicates summed)."""
        return cls.from_scipy(coo.to_scipy())

    @property
    def dtype(self) -> torch.dtype:
        return self.val.dtype

    @property
    def capacity(self) -> int:
        return int(self.val.shape[0])

    @property
    def nrows(self) -> int:
        return self.shape[0]

    @property
    def ncols(self) -> int:
        return self.shape[1]

    def nnz_per_row(self) -> torch.Tensor:
        return self.rpt[1:] - self.rpt[:-1]

    def nnz_max(self) -> int:
        """The most entries of any row (0 for a matrix without rows)."""
        return int(self.nnz_per_row().max()) if self.shape[0] else 0

    def valid_mask(self) -> torch.Tensor:
        return torch.arange(self.capacity, device=self.device) < self.nnz

    def row_ids(self) -> torch.Tensor:
        """(capacity,) int32 row of each entry; the padded tail is M."""
        m = self.shape[0]
        rows = torch.full((self.capacity,), m, dtype=torch.int32,
                          device=self.device)
        rows[: self.nnz] = torch.repeat_interleave(
            torch.arange(m, dtype=torch.int32, device=self.device),
            self.nnz_per_row().long(), output_size=self.nnz)
        return rows

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

    def with_capacity(self, cap: int) -> "CSR":
        """``col``/``val`` padded with zeros, or cut, to ``cap`` entries
        (never below ``nnz`` or 1)."""
        cap = max(int(cap), self.nnz, 1)
        if cap <= self.capacity:
            return dataclasses.replace(self, col=self.col[:cap],
                                       val=self.val[:cap])
        pad = cap - self.capacity
        return dataclasses.replace(
            self, col=torch.nn.functional.pad(self.col, (0, pad)),
            val=torch.nn.functional.pad(self.val, (0, pad)))

    def astype(self, dtype) -> "CSR":
        """Values cast to ``dtype`` (a torch or numpy dtype)."""
        if not isinstance(dtype, torch.dtype):
            dtype = torch.from_numpy(np.zeros(0, dtype=dtype)).dtype
        return dataclasses.replace(self, val=self.val.to(dtype))

    def to_dense(self) -> torch.Tensor:
        """(M, N) dense tensor on the matrix's device."""
        nnz = self.nnz
        out = torch.zeros(self.shape, dtype=self.dtype, device=self.device)
        return out.index_put_(
            (self.row_ids()[:nnz].long(), self.col[:nnz].long()),
            self.val[:nnz], accumulate=True)

    def transpose(self) -> "CSR":
        """Host-side transpose: the canonical CSR of A^T."""
        return CSR.from_scipy(self.to_scipy().T)

    def __eq__(self, other) -> bool:
        """Tolerant matrix equality (the reference's ``CSR::operator==``):
        exact structure, values within ``checking.ans_check``'s rtol."""
        from nsparse_tpu_torch.utils.checking import csr_allclose

        if not isinstance(other, CSR):
            return NotImplemented
        return csr_allclose(self, other)

    def __hash__(self):
        return id(self)

"""Block-sparse-row (BSR) format of the PyTorch port (counterpart of
``nsparse_tpu/formats/bsr.py``).

Dense ``(br, bc)`` tiles stored by block row, sorted by block column
within a row.  Every block row holds at least one tile (a zero tile at
block column 0 when it has none), so a kernel that walks block rows
writes every block of y.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from nsparse_tpu_torch.formats.csr import CSR
from nsparse_tpu_torch.utils.device import int32_tensor, to_device


@dataclasses.dataclass(frozen=True)
class BSR:
    """Block sparse row matrix.

    Attributes:
      data: (nblocks, br, bc) dense tiles.
      block_col: (nblocks,) int32 block column of each tile.
      block_row: (nblocks,) int32 block row of each tile.
      block_rpt: (n_block_rows + 1,) int32 tile row pointers.
      shape: logical (M, N); blocksize: (br, bc).
      nnz: scalar nnz of the source matrix.
    """

    data: torch.Tensor
    block_col: torch.Tensor
    block_row: torch.Tensor
    block_rpt: torch.Tensor
    shape: Tuple[int, int]
    blocksize: Tuple[int, int]
    nnz: int

    @property
    def dtype(self) -> torch.dtype:
        return self.data.dtype

    @property
    def nblocks(self) -> int:
        return int(self.data.shape[0])

    @property
    def n_block_rows(self) -> int:
        return int(self.block_rpt.shape[0]) - 1

    @property
    def padded_nnz(self) -> int:
        return int(self.data.numel())

    @property
    def fill_ratio(self) -> float:
        return self.padded_nnz / max(self.nnz, 1)

    @classmethod
    def from_numpy(cls, data, block_col, block_row, block_rpt, shape,
                   blocksize, nnz) -> "BSR":
        """From host arrays (a JAX BSR's fields)."""
        return cls(data=torch.from_numpy(np.array(data)),
                   block_col=int32_tensor(block_col),
                   block_row=int32_tensor(block_row),
                   block_rpt=int32_tensor(block_rpt),
                   shape=(int(shape[0]), int(shape[1])),
                   blocksize=(int(blocksize[0]), int(blocksize[1])),
                   nnz=int(nnz))

    @classmethod
    def from_csr(cls, a: CSR, blocksize: Tuple[int, int] = (8, 128)
                 ) -> "BSR":
        """Host-side conversion through scipy's BSR (zero fill inside
        tiles), with a zero tile for every empty block row."""
        import scipy.sparse as sp

        br, bc = blocksize
        m, n = a.shape
        mp = ((m + br - 1) // br) * br
        np_ = ((n + bc - 1) // bc) * bc
        s = a.to_scipy()
        s = sp.csr_matrix((s.data, s.indices, s.indptr), shape=(m, n))
        s.resize((mp, np_))
        b = s.tobsr(blocksize=(br, bc))
        b.sort_indices()
        indptr = np.asarray(b.indptr, dtype=np.int32)
        indices = np.asarray(b.indices, dtype=np.int32)
        data = np.asarray(b.data)

        counts = np.diff(indptr)
        if (counts == 0).any():
            # zero tile at block column 0 for each empty block row
            new_indptr = np.zeros(mp // br + 1, dtype=np.int32)
            np.cumsum(np.maximum(counts, 1), out=new_indptr[1:])
            nblocks = int(new_indptr[-1])
            dst = np.repeat(new_indptr[:-1], counts) + (
                np.arange(indices.size) - np.repeat(indptr[:-1], counts))
            new_data = np.zeros((nblocks, br, bc), dtype=data.dtype)
            new_indices = np.zeros(nblocks, dtype=np.int32)
            new_data[dst] = data
            new_indices[dst] = indices
            indptr, indices, data = new_indptr, new_indices, new_data

        block_row = (np.searchsorted(indptr, np.arange(len(indices)),
                                     side="right") - 1).astype(np.int32)
        return cls.from_numpy(data, indices, block_row, indptr, (m, n),
                              (br, bc), a.nnz)

    def to(self, device) -> "BSR":
        return to_device(self, device)

    def to_dense(self) -> torch.Tensor:
        """(M, N) dense tensor: the tiles summed into place, cut to
        ``shape``."""
        br, bc = self.blocksize
        m, n = self.shape
        nbc = -(-n // bc)
        grid = torch.zeros(self.n_block_rows * nbc, br, bc, dtype=self.dtype,
                           device=self.data.device)
        grid.index_add_(0, self.block_row.long() * nbc
                        + self.block_col.long(), self.data)
        dense = grid.view(self.n_block_rows, nbc, br, bc).transpose(1, 2)
        return dense.reshape(self.n_block_rows * br, nbc * bc)[:m, :n]

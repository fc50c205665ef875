"""COO container of the PyTorch port (counterpart of
``nsparse_tpu/formats/coo.py``).

Arrays may be padded beyond ``nnz`` to a capacity, as in the JAX class;
padded slots carry ``row == col == 0`` and ``val == 0``.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from nsparse_tpu_torch.utils.device import to_device


@dataclasses.dataclass(frozen=True)
class COO:
    """Coordinate-format sparse matrix: int32 ``row``/``col``, values
    ``val``, all of one (capacity,) length; ``nnz`` entries are real."""

    row: torch.Tensor
    col: torch.Tensor
    val: torch.Tensor
    shape: Tuple[int, int]
    nnz: int

    @property
    def dtype(self) -> torch.dtype:
        return self.val.dtype

    @property
    def capacity(self) -> int:
        return int(self.val.shape[0])

    @classmethod
    def from_arrays(cls, row, col, val, shape, pad_to: int | None = None
                    ) -> "COO":
        row = np.asarray(row, dtype=np.int32)
        col = np.asarray(col, dtype=np.int32)
        val = np.asarray(val)
        nnz = int(row.shape[0])
        cap = int(pad_to) if pad_to is not None else nnz
        if cap < nnz:
            raise ValueError(f"pad_to={cap} < nnz={nnz}")
        pr = np.zeros(cap, dtype=np.int32)
        pc = np.zeros(cap, dtype=np.int32)
        pv = np.zeros(cap, dtype=val.dtype)
        pr[:nnz], pc[:nnz], pv[:nnz] = row, col, val
        return cls(row=torch.from_numpy(pr), col=torch.from_numpy(pc),
                   val=torch.from_numpy(pv),
                   shape=(int(shape[0]), int(shape[1])), nnz=nnz)

    def to(self, device) -> "COO":
        return to_device(self, device)

    def to_scipy(self):
        import scipy.sparse as sp

        nnz = self.nnz
        return sp.coo_matrix(
            (self.val[:nnz].cpu().numpy(),
             (self.row[:nnz].cpu().numpy(), self.col[:nnz].cpu().numpy())),
            shape=self.shape)

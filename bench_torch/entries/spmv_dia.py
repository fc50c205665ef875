"""y = A x on HPCG's operator held by its diagonals: set-up builds A's
27 diagonals on the card (HPCG's values, 26 and -1) and wraps them in the
program's ``DIA``, as a stencil code would, with no conversion from CSR;
each call is ``spmv(dia, x_k)`` over a pool of standard-normal x, as
each CG iteration multiplies the operator by a new search direction.

The work of a call: 2 operations a stored entry of A; least bytes A's
values once, x and y (the stencil needs no index: the CSR yardstick
would count the columns too and put a kernel near the memory bandwidth
above 100%).  The reference runs on the canonical CSR of the same
operator, made once the window has closed.
"""

from __future__ import annotations

import torch

import reference
import reference_hpcg


class Entry:
    def __init__(self, ctx):
        nt, dev, gen = ctx.program, ctx.device, ctx.gen
        self.grid = gen.dims(ctx.cfg)
        self._gen = gen
        offsets, vals = gen.diagonals(self.grid, dev)
        n = self.grid[0] * self.grid[1] * self.grid[2]
        nnz = int((vals != 0).sum())
        self.dia = nt.DIA(vals=vals, offsets=offsets, shape=(n, n), nnz=nnz,
                          off_t=torch.tensor(offsets, dtype=torch.int32,
                                             device=dev))
        self.pool = ctx.traffic["pool"]
        self.val_bytes = vals.element_size()
        self.x = torch.randn((self.pool, n), generator=ctx.rng(0), device=dev,
                             dtype=vals.dtype)
        self.prep_s = None
        self.work = [(2 * nnz, (nnz + 2 * n) * self.val_bytes)] * self.pool
        self._nt = nt
        self._csr = None

    def csr(self):
        """The operator as the reference reads it: a canonical CSR."""
        if self._csr is None:
            self._csr = self._gen.operator(self.grid, self.x.device)
        return self._csr

    def call(self, k):
        return self._nt.spmv(self.dia, self.x[k])

    def control(self, k):
        return reference_hpcg.spmv_control(self.csr(), self.x[k])

    def release(self):
        self.dia = None

    def check(self, k, out):
        return reference.spmv_gap(self.csr(), self.x[k], out, "plus_times")


def setup(ctx):
    return Entry(ctx)

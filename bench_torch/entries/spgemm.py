"""One-shot C = A @ A: each call ``spgemm(a_k, a_k)`` with no plan (the
default device planner and the sort numeric phase), a_k the k-th of
``pool`` patterns, each from its own edge seed and the run's seed, taken
in turn so that no pattern repeats in consecutive calls."""

from __future__ import annotations

import reference
import yardstick


class Entry:
    def __init__(self, ctx):
        nt = ctx.program
        self.pool = ctx.traffic["pool"]
        self.graphs = [ctx.graph(j) for j in range(self.pool)]
        self.val_bytes = self.graphs[0].val.element_size()
        self.prep_s = None
        self.a = [nt.CSR(rpt=g.rpt, col=g.col, val=g.val, shape=g.shape,
                         nnz=g.nnz) for g in self.graphs]
        self.work = []
        for g in self.graphs:
            p, nnz_c = reference.spgemm_symbolic(g, g)
            self.work.append(yardstick.spgemm_work(
                g.shape, g.nnz, g.shape, g.nnz, nnz_c, p, self.val_bytes,
                structure=True))
        self._nt = nt

    def call(self, k):
        return self._nt.spgemm(self.a[k], self.a[k])

    def control(self, k):
        g = self.graphs[k]
        return reference.spgemm_control(g, g)

    def release(self):
        self.a = None

    def check(self, k, out):
        g = self.graphs[k]
        return reference.spgemm_gaps(g, g, *reference.csr_parts(out))


def setup(ctx):
    return Entry(ctx)

"""C = A @ A re-run on a plan built once: ``spgemm_plan(a, a)`` on the
host and moved to the card in set-up (``prep_s``), then each call
``spgemm_numeric(plan, a_k, a_k)``, a_k the pattern with the k-th of
``pool`` weight vectors drawn on the card."""

from __future__ import annotations

import time

import torch

import reference
import yardstick


class Entry:
    def __init__(self, ctx):
        nt, dev = ctx.program, ctx.device
        self.graph = ctx.graph(0)
        g = self.graph
        self.pool = ctx.traffic["pool"]
        self.vals = ctx.gen.weights(g, self.pool, ctx.rng(0))
        self.val_bytes = g.val.element_size()
        host = nt.CSR(rpt=g.rpt.cpu(), col=g.col.cpu(), val=g.val.cpu(),
                      shape=g.shape, nnz=g.nnz)
        # the host planner is compiled at its first use: before prep_s
        one = nt.CSR.from_dense(torch.ones(1, 1, dtype=g.val.dtype))
        nt.spgemm_plan(one, one)
        t0 = time.perf_counter()
        self.plan = nt.spgemm_plan(host, host).to(dev)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        self.prep_s = time.perf_counter() - t0
        self.a = [nt.CSR(rpt=g.rpt, col=g.col, val=self.vals[k],
                         shape=g.shape, nnz=g.nnz) for k in range(self.pool)]
        p, nnz_c = reference.spgemm_symbolic(g, g)
        self.work = [yardstick.spgemm_work(g.shape, g.nnz, g.shape, g.nnz,
                                           nnz_c, p, self.val_bytes,
                                           structure=False)] * self.pool
        self._nt = nt

    def _csr(self, k):
        g = self.graph
        return reference.Csr(rpt=g.rpt, col=g.col, val=self.vals[k],
                             shape=g.shape)

    def call(self, k):
        return self._nt.spgemm_numeric(self.plan, self.a[k], self.a[k])

    def control(self, k):
        return reference.spgemm_control(self._csr(k), self._csr(k))

    def release(self):
        self.plan = self.a = None

    def check(self, k, out):
        a = self._csr(k)
        return reference.spgemm_gaps(a, a, *reference.csr_parts(out))


def setup(ctx):
    return Entry(ctx)

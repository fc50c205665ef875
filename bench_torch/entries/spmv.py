"""y = A (.) x on one ELL: set-up converts the graph with
``ELL.from_csr(a, **traffic["ell"])`` on the host and moves it to the
card (``prep_s``); each call is ``spmv(ell, x_k, semiring=...)`` over a
pool of x vectors drawn on the card: ``normal`` (standard normal) or
``distance`` (uniform in [0, 1), a share ``unreached`` of them +inf, as
in the middle of a Bellman-Ford relaxation)."""

from __future__ import annotations

import time

import torch

import reference
import yardstick


def draw_x(spec: dict, pool: int, n: int, dtype, g, device):
    if spec["dist"] == "normal":
        return torch.randn((pool, n), generator=g, device=device,
                           dtype=torch.float32).to(dtype)
    if spec["dist"] == "distance":
        x = torch.rand((pool, n), generator=g, device=device,
                       dtype=torch.float32).to(dtype)
        far = torch.rand((pool, n), generator=g, device=device,
                         dtype=torch.float32) < spec["unreached"]
        return x.masked_fill_(far, float("inf"))
    raise ValueError(f"unknown x distribution {spec['dist']!r}")


class Entry:
    def __init__(self, ctx):
        nt, dev, tr = ctx.program, ctx.device, ctx.traffic
        self.graph = g = ctx.graph(0)
        self.pool = tr["pool"]
        self.semiring = tr["semiring"]
        self.val_bytes = g.val.element_size()
        self.x = draw_x(tr["x"], self.pool, g.shape[1], g.val.dtype,
                        ctx.rng(0), dev)
        host = nt.CSR(rpt=g.rpt.cpu(), col=g.col.cpu(), val=g.val.cpu(),
                      shape=g.shape, nnz=g.nnz)
        t0 = time.perf_counter()
        self.ell = nt.ELL.from_csr(host, **tr["ell"]).to(dev)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        self.prep_s = time.perf_counter() - t0
        self.work = [yardstick.spmv_work(g.shape, g.nnz, self.val_bytes)
                     ] * self.pool
        self._nt = nt

    def call(self, k):
        return self._nt.spmv(self.ell, self.x[k], semiring=self.semiring)

    def control(self, k):
        return reference.spmv_ref(self.graph, self.x[k], self.semiring,
                                  "tf32")[0]

    def release(self):
        self.ell = None

    def check(self, k, out):
        return reference.spmv_gap(self.graph, self.x[k], out, self.semiring)


def setup(ctx):
    return Entry(ctx)

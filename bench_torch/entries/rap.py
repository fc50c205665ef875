"""An algebraic-multigrid set-up on HPCG's operator: each call forms the
coarse operators A_{l+1} = rap(R_l, A_l, P_l) for every level but the
coarsest, each from the call's own coarser product, on value set k of
``pool`` (the fine operator's coefficients, drawn from the run's seed;
R_l and P_l fixed), taken in turn.  A call returns its coarse operators.

The work of a call, counted from the reference's symbolic pass in
set-up: 2 operations per product of each A·P and each R·(A·P); least
bytes each level's R, A and P read once and its A_{l+1} written once as
CSR (the intermediate A·P not counted, so a fused product is held to the
same work).

Set-up ends with one call under the program's recorder (reset first),
inside the recorder's span ``bench.call``, so that
``metrics/host_syncs_per_call.py`` and ``metrics/sync_wait_ms.py`` can
read one call's host reads.
"""

from __future__ import annotations

import reference_hpcg
import yardstick
from reference import Csr

RECORDED_CALL = "bench.call"  # the recorder's span around the call


class Entry:
    def __init__(self, ctx):
        nt, dev = ctx.program, ctx.device
        self._rap = nt.rap  # a program without rap fails here, at once
        self.pool = ctx.traffic["pool"]
        h = ctx.gen.hierarchy(ctx.cfg, dev)
        self.val_bytes = 8
        self.prep_s = None
        self.a0 = [Csr(rpt=h.a.rpt, col=h.a.col,
                       val=ctx.gen.coefficients(h, ctx.rng(k)),
                       shape=h.a.shape) for k in range(self.pool)]
        self.transfers = h.transfers
        self.work = [galerkin_work(h.a, h.transfers)] * self.pool

        def program(m):
            return nt.CSR(rpt=m.rpt, col=m.col, val=m.val, shape=m.shape,
                          nnz=m.nnz)

        self._a = [program(a) for a in self.a0]
        self._rp = [(program(r), program(p)) for r, p in h.transfers]
        self._recorded_call(ctx)

    def _recorded_call(self, ctx):
        import torch

        from nsparse_tpu_torch.utils import profiling

        self.call(0)
        if ctx.device.type == "cuda":
            torch.cuda.synchronize(ctx.device)
        profiling.reset()
        with profiling.recording(), profiling.span(RECORDED_CALL):
            self.call(0)
            if ctx.device.type == "cuda":
                torch.cuda.synchronize(ctx.device)

    def call(self, k):
        a, out = self._a[k], []
        for r, p in self._rp:
            a = self._rap(r, a, p)
            out.append(a)
        return out

    def control(self, k):
        return reference_hpcg.hierarchy_control(self.a0[k], self.transfers)

    def release(self):
        self._a = self._rp = None

    def check(self, k, out):
        return reference_hpcg.hierarchy_gaps(self.a0[k], self.transfers, out)


def galerkin_work(a0: Csr, transfers) -> tuple[int, int]:
    """(operations, least bytes) of one set-up, from the reference's
    symbolic pass: 2 a product of every A·P and R·(A·P); each level's R,
    A and P read once and A_{l+1} written once as float64 CSR."""
    ops = nbytes = 0
    a = a0
    for (r, p), (p_ap, _, p_rap, coarse) in zip(
            transfers, reference_hpcg.galerkin_symbolic(a0, transfers)):
        ops += 2 * (p_ap + p_rap)
        nbytes += sum(yardstick.csr_bytes(m.shape[0], m.nnz, 8)
                      for m in (r, a, p, coarse))
        a = coarse
    return ops, nbytes


def setup(ctx):
    return Entry(ctx)

"""Times the hash SpGEMM's routes for long rows against each other.

``ops/kernels/spgemm_hash.py`` sends the rows past the warp route to the
dense accumulator alone while it takes at most ``DENSE_PASSES`` passes
over a row's products (one a slice of N); past that, rows that fit go to
hash tables in shared memory, the rest to the dense route while it takes
at most ``TABLE_PASSES``, then to tables in device memory.  This script
times C = A @ A with a phase's routes past the warp route set by hand:

- ``dense:P``: the dense route in P passes (smaller slices stand in for a
  wider N at the same products);
- ``blocks+dense:P``: the hash blocks, then the dense route in P passes;
- ``blocks+global``: the hash blocks, then tables in device memory;
- ``rule``: what ``hash_routes`` gives.

The other phase keeps a fixed route table, so that the two cutoffs rest on
crossovers measured on the card.  Values are positive; each variant's C
is held to the first one's (``rpt`` and ``col`` equal, values within 1e-4
f32 / 1e-10 f64 relative: the routes sum in other orders).

Run on a card from the repository root (about 4 minutes with the build):

    python3 tools/hash_variants.py [--shapes rmat-18-f32,...]
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke as cs  # noqa: E402
import nsparse_tpu_torch as nt  # noqa: E402
from nsparse_tpu_torch.ops.kernels import cuda_lib  # noqa: E402
from nsparse_tpu_torch.ops.kernels import spgemm_hash as sh  # noqa: E402
from nsparse_tpu_torch.utils import profiling  # noqa: E402
from nsparse_tpu_torch.utils.timing import time_cuda  # noqa: E402

B_D, B_G = "blocks+dense", "blocks+global"
# name: (graph, scale, edge factor, dtype, the phase varied, the other
# phase's routes, the varied phase's variants)
SHAPES = {
    "g500-16-f64": ("g500", 16, 16, np.float64, "numeric", "rule",
                    ("dense:5", "dense:20", "dense:40", f"{B_D}:5",
                     f"{B_D}:20", B_G)),
    "g500-17-f32": ("g500", 17, 16, np.float32, "numeric", "rule",
                    ("dense:5", "dense:20", "dense:40", f"{B_D}:5",
                     f"{B_D}:20", B_G)),
    "rmat-18-f32": ("rmat", 18, 4, np.float32, "numeric", "rule",
                    ("dense:10", "dense:40", "dense:160", f"{B_D}:10",
                     f"{B_D}:40", f"{B_D}:160", f"{B_D}:320", B_G)),
    "rmat-18-f64": ("rmat", 18, 4, np.float64, "numeric", "rule",
                    ("dense:19", "dense:80", f"{B_D}:19", f"{B_D}:80",
                     f"{B_D}:160", f"{B_D}:320", B_G)),
    "rmat-18-sym": ("rmat", 18, 4, np.float32, "symbolic", "dense:10",
                    ("dense:1", "dense:32", "dense:128", "dense:256",
                     f"{B_D}:32", f"{B_D}:128", f"{B_D}:256", B_G)),
}
ROUTES = sh.hash_routes


def routes_of(spec: str, phase: str, n_cols: int, val_bytes: int):
    """The routes of ``phase`` that ``spec`` names (module docstring)."""
    if spec == "rule":
        return ROUTES(phase, n_cols, val_bytes)
    vb = 0 if phase == "symbolic" else val_bytes
    head = list(ROUTES(phase, n_cols, val_bytes)[:2])  # pwarp, warp
    kind, _, passes = spec.partition(":")
    if kind == "dense":
        return (*head, sh.dense_route(n_cols, vb, int(passes)))
    tail = (sh.dense_route(n_cols, vb, int(passes)) if kind == B_D else
            sh.Route("global", sh.GLOBAL, None, 0, sh.TAIL_THREADS,
                     sh.SCRATCH_BYTES))
    return (*head, *sh.block_routes(vb), tail)


def variant(phase: str, spec: str, other: str):
    def routes(p, n_cols, val_bytes):
        return routes_of(spec if p == phase else other, p, n_cols,
                         val_bytes)
    return routes


def graph(kind, scale, ef):
    if kind == "g500":
        return cs.g500_graph(nt, scale=scale, edge_factor=ef, seed=1)
    m = nt.rmat_csr(scale, ef, dtype=np.float32, seed=1)
    return m.with_values(m.val.abs() + 0.5)


def rows_by_route(a_d, phase: str) -> dict:
    key = f"spgemm_hash.rows.{phase}."
    profiling.reset()
    with profiling.recording():
        nt.spgemm(a_d, a_d)
    torch.cuda.synchronize()
    got = {k[len(key):]: v for k, v in profiling.snapshot()["counters"]
           .items() if k.startswith(key) and v}
    profiling.reset()
    return got


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--shapes", default=",".join(SHAPES))
    ap.add_argument("--trials", type=int, default=3)
    args = ap.parse_args()
    card = cs.card_line()
    print(card, flush=True)
    t0 = time.perf_counter()
    cuda_lib.KERNELS.get()
    print(f"built in {time.perf_counter() - t0:.1f} s", flush=True)
    for name in args.shapes.split(","):
        kind, scale, ef, dt, phase, other, specs = SHAPES[name]
        host = cs.with_dtype_values(graph(kind, scale, ef), dt)
        a_d = host.to("cuda")
        n, vb = host.shape[1], np.dtype(dt).itemsize
        flops = nt.spgemm_flops(host, host)
        least = -(-n // sh.dense_route(n, 0 if phase == "symbolic" else vb)
                  .slots)
        print(f"== {name}: N {n}, nnz(A) {host.nnz}, products "
              f"{flops // 2}; {phase} varied, the fewest dense passes "
              f"{least}, the rule {[r.name for r in ROUTES(phase, n, vb)]}"
              f"; the other phase {other}", flush=True)
        variants = [(spec, variant(phase, spec, other)) for spec in specs]
        ref = None
        times = {spec: [] for spec in specs}
        for rnd in range(2):
            for spec, routes in variants if rnd == 0 else variants[::-1]:
                sh.hash_routes = routes
                try:
                    if rnd == 0:
                        c = nt.spgemm(a_d, a_d)
                        torch.cuda.synchronize()
                        if ref is None:
                            ref = c
                        else:
                            same = torch.equal(c.rpt, ref.rpt) and \
                                torch.equal(c.col, ref.col)
                            rel = float(((c.val - ref.val).abs() /
                                         ref.val.abs().clamp_min(1e-30))
                                        .max())
                            tol = 1e-4 if dt == np.float32 else 1e-10
                            if not same or rel > tol:
                                raise SystemExit(
                                    f"{name} {spec}: C differs (structure "
                                    f"equal {same}, max rel {rel:.3g})")
                            print(f"   {spec}: C equal to the first "
                                  f"variant's, values within {rel:.3g}",
                                  flush=True)
                            del c
                        print(f"   {spec}: {phase} rows by route "
                              f"{rows_by_route(a_d, phase)}", flush=True)
                    times[spec].append(time_cuda(
                        lambda: nt.spgemm(a_d, a_d), trials=args.trials))
                finally:
                    sh.hash_routes = ROUTES
        for spec in specs:
            t = times[spec]
            print(f"{name} {phase} {spec} [{card}]: {min(t):.3f} ms "
                  f"(rounds {', '.join(f'{x:.3f}' for x in t)}; "
                  f"{flops / min(t) / 1e6:.2f} GFLOP/s; nnz(C) {ref.nnz})",
                  flush=True)
        del ref, a_d
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()

"""Command line of the port (counterpart of ``nsparse_tpu/cli.py``).

    python -m nsparse_tpu_torch --precision single spgemm gen:rmat:14:8 --planner host

Loads a matrix (a .mtx path, ``gen:rmat:SCALE:EF`` or ``gen:stencil:NX:NY``),
builds the host plan of C = A @ A, times the numeric phase, and checks C
against the scipy oracle: it prints the same funnel and pass/FAIL verdict
as the JAX CLI.  It runs on the card when one is present, timed with CUDA
events; without one it runs on the CPU, timed by the host clock and
labelled as such.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch


def _load(spec: str, dtype):
    from nsparse_tpu_torch.io.generate import rmat_csr, stencil_csr
    from nsparse_tpu_torch.io.matrix_market import read_mtx

    if spec.startswith("gen:"):
        parts = spec.split(":")
        if parts[1] == "stencil":
            return stencil_csr(int(parts[2]), int(parts[3]), dtype=dtype)
        if parts[1] == "rmat":
            return rmat_csr(int(parts[2]), int(parts[3]), dtype=dtype)
        raise SystemExit(f"unknown generator {parts[1]}")
    return read_mtx(spec, dtype=dtype)


def cmd_spgemm(args) -> int:
    from nsparse_tpu_torch.ops.spgemm import spgemm_numeric, spgemm_plan
    from nsparse_tpu_torch.utils.checking import (
        check_spgemm_answer,
        spgemm_abs_oracle,
        spgemm_oracle,
    )

    dtype = np.float32 if args.precision == "single" else np.float64
    dev = torch.device("cuda" if torch.cuda.is_available() else "cpu")
    a = _load(args.matrix, dtype)
    m, n = a.shape
    print(f"matrix: {args.matrix}  M={m} N={n} nnz={a.nnz}")

    t0 = time.perf_counter()
    plan = spgemm_plan(a, a)
    sym_ms = (time.perf_counter() - t0) * 1e3
    # the compression funnel the reference prints (spgemm_hash.cu:64)
    print(f"nnz(A): {a.nnz}  intermediate products: {plan.n_products}  "
          f"nnz(C): {plan.c_nnz}")
    print(f"symbolic (host plan, {plan.planner} planner): {sym_ms:.1f} ms")

    plan_d, a_d = plan.to(dev), a.to(dev)
    if dev.type == "cuda":
        from nsparse_tpu_torch.utils.roofline import (
            chip_specs,
            spgemm_roofline_gflops,
        )
        from nsparse_tpu_torch.utils.timing import gflops, time_cuda

        ms = time_cuda(lambda: spgemm_numeric(plan_d, a_d, a_d),
                       trials=args.trials)
        name = torch.cuda.get_device_name(dev)
        spec = chip_specs(name)
        roof = spgemm_roofline_gflops(
            a.nnz, a.nnz, plan.c_nnz, plan.n_products, spec,
            val_bytes=np.dtype(dtype).itemsize,
        )
        gf = gflops(plan.flops, ms)
        print(f"SpGEMM numeric [{name}]: {ms:.4f} ms  {gf:.2f} GFLOPS  "
              f"({100 * gf / roof:.1f}% of {spec.name} roofline)")
    else:
        t0 = time.perf_counter()
        for _ in range(args.trials):
            spgemm_numeric(plan_d, a_d, a_d)
        ms = (time.perf_counter() - t0) * 1e3 / max(args.trials, 1)
        print(f"SpGEMM numeric [{dev}, host clock]: {ms:.4f} ms")

    c = spgemm_numeric(plan_d, a_d, a_d)
    ok = check_spgemm_answer(
        c, spgemm_oracle(a, a), abs_ref=spgemm_abs_oracle(a, a)
    )
    print("pass" if ok else "FAIL")
    return 0 if ok else 1


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="nsparse_tpu_torch")
    ap.add_argument("--precision", choices=["single", "double"],
                    default="double")
    sub = ap.add_subparsers(dest="cmd", required=True)
    sg = sub.add_parser("spgemm", help="C = A @ A with a host plan")
    sg.add_argument("matrix")
    sg.add_argument("--trials", type=int, default=11)
    sg.add_argument("--planner", choices=["host"], default="host",
                    help="symbolic phase; only the host planner is ported")
    sg.set_defaults(fn=cmd_spgemm)
    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())

"""Command line of the port (counterpart of ``nsparse_tpu/cli.py``).

    python -m nsparse_tpu_torch --precision single spmv gen:stencil:2048:2048 --format dia
    python -m nsparse_tpu_torch --precision single spgemm gen:rmat:14:8
    python -m nsparse_tpu_torch --precision single spgemm gen:rmat:14:8 --planner host
    python -m nsparse_tpu_torch --precision single spgemm gen:fem:4096:16 --method bsr

Loads a matrix (a .mtx path, ``gen:stencil:NX:NY``, ``gen:rmat:SCALE:EF``,
``gen:fem:NODES:DOF`` or ``gen:random:M:N:DENSITY``), builds the format or
the plan, times the product and checks it against the scipy oracle,
printing the same lines and pass/FAIL verdict as the JAX CLI.  It runs on
the card (``--device cuda``, the default), timed with CUDA events; it
refuses to start when no card is visible.  ``--device cpu`` runs it on
the host, timed by the host clock and labelled as such.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch


def _load(spec: str, dtype):
    from nsparse_tpu_torch.io.generate import (
        fem_block_csr,
        random_csr,
        rmat_csr,
        stencil_csr,
    )
    from nsparse_tpu_torch.io.matrix_market import read_mtx

    if spec.startswith("gen:"):
        parts = spec.split(":")
        kind = parts[1]
        if kind == "stencil":
            return stencil_csr(int(parts[2]), int(parts[3]), dtype=dtype)
        if kind == "rmat":
            return rmat_csr(int(parts[2]), int(parts[3]), dtype=dtype)
        if kind == "fem":
            return fem_block_csr(int(parts[2]), dof=int(parts[3]),
                                 dtype=dtype)
        if kind == "random":
            return random_csr(int(parts[2]), int(parts[3]), float(parts[4]),
                              dtype=dtype)
        raise SystemExit(f"unknown generator {kind}")
    return read_mtx(spec, dtype=dtype)


def _device(name: str) -> torch.device:
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"--device {name}: no CUDA card is visible to PyTorch; pass "
            "--device cpu to run on the host")
    return dev


def _timed(fn, dev: torch.device, trials: int):
    """(ms per call, label): CUDA events on a card, the host clock on the
    CPU."""
    if dev.type == "cuda":
        from nsparse_tpu_torch.utils.timing import time_cuda

        return (time_cuda(fn, trials=trials),
                torch.cuda.get_device_name(dev))
    fn()
    t0 = time.perf_counter()
    for _ in range(trials):
        fn()
    return ((time.perf_counter() - t0) * 1e3 / max(trials, 1),
            f"{dev}, host clock")


def cmd_spmv(args) -> int:
    from nsparse_tpu_torch.formats.bsr import BSR
    from nsparse_tpu_torch.formats.dia import DIA
    from nsparse_tpu_torch.formats.ell import ELL
    from nsparse_tpu_torch.ops.spmv import spmv
    from nsparse_tpu_torch.tune.autotune import autotune_spmv
    from nsparse_tpu_torch.tune.plan import Plan
    from nsparse_tpu_torch.utils.checking import (
        ans_check,
        spmv_abs_oracle,
        spmv_oracle,
    )

    dtype = np.float32 if args.precision == "single" else np.float64
    dev = _device(args.device)
    a = _load(args.matrix, dtype)
    m, n = a.shape
    print(f"matrix: {args.matrix}  M={m} N={n} nnz={a.nnz}")
    x = torch.from_numpy(
        np.random.default_rng(0).standard_normal(n).astype(dtype))

    t0 = time.perf_counter()
    if args.format == "auto":
        fmt, plan = autotune_spmv(a, x, trials=args.tune_trials,
                                  measure=args.tune_mode == "measure",
                                  cache_dir=args.plan_cache, device=dev)
    else:
        plan = Plan(format=args.format)
        build = {"ell": ELL.from_csr, "bsr": BSR.from_csr,
                 "dia": DIA.from_csr}.get(args.format, lambda c: c)
        fmt = build(a).to(dev)
    print(f"conversion/tuning: {(time.perf_counter() - t0) * 1e3:.1f} ms  "
          f"format={plan.format}")

    x_d = x.to(dev)
    ms, where = _timed(lambda: spmv(fmt, x_d), dev, args.trials)
    gf = 2.0 * a.nnz / (max(ms, 1e-6) * 1e-3) / 1e9
    line = f"SpMV [{plan.format}, {where}]: {ms:.4f} ms  {gf:.2f} GFLOPS"
    if dev.type == "cuda":
        from nsparse_tpu_torch.utils.roofline import (
            chip_specs,
            spmv_roofline_gflops,
        )

        spec = chip_specs(where)
        roof = spmv_roofline_gflops(
            a.nnz, m, n, spec, val_bytes=np.dtype(dtype).itemsize,
            idx_bytes=0 if plan.format == "dia" else 4,
            padded_nnz=getattr(fmt, "padded_nnz", a.nnz))
        line += f"  ({100 * gf / roof:.1f}% of {spec.name} roofline)"
    print(line)

    ok, nf = ans_check(spmv(fmt, x_d), spmv_oracle(a, x), dtype=dtype,
                       scale=spmv_abs_oracle(a, x))
    print("pass" if ok else f"FAIL ({nf} mismatches)")
    return 0 if ok else 1


def _check_spgemm(c, a) -> int:
    from nsparse_tpu_torch.utils.checking import (
        check_spgemm_answer,
        spgemm_abs_oracle,
        spgemm_oracle,
    )

    ok = check_spgemm_answer(
        c, spgemm_oracle(a, a), abs_ref=spgemm_abs_oracle(a, a))
    print("pass" if ok else "FAIL")
    return 0 if ok else 1


def _spgemm_bsr(a, dev, trials: int) -> int:
    """C = A @ A through dense tile products (the block path)."""
    from nsparse_tpu_torch.ops.spgemm_bsr import (
        plan_spgemm_bsr,
        spgemm_bsr,
        tile_products,
    )
    from nsparse_tpu_torch.utils.timing import gflops

    t0 = time.perf_counter()
    plan = plan_spgemm_bsr(a, a)
    sym_ms = (time.perf_counter() - t0) * 1e3
    print(f"nnz(A): {a.nnz}  block pairs: {plan.n_pairs}  "
          f"fill: {plan.fill:.1f}x")
    print(f"symbolic (block plan): {sym_ms:.1f} ms")
    plan_d = plan.to(dev)
    ms, where = _timed(lambda: tile_products(plan_d), dev, trials)
    line = f"SpGEMM bsr [{where}]: {ms:.4f} ms"
    if dev.type == "cuda":
        tile_tf = gflops(2 * plan.n_pairs * plan.bs**3, ms) / 1e3
        line += (f"  {gflops(plan.flops, ms):.2f} GFLOPS useful  "
                 f"({tile_tf:.2f} TFLOP/s of tile products)")
    print(line)
    return _check_spgemm(spgemm_bsr(a.to(dev), a.to(dev), plan_d), a)


def _layout_line(plan, planner: str) -> str:
    detail = ""
    if plan.layout == "window":
        w = plan.win
        detail = (f", numeric form {'v2' if w.fused_expand else 'v1'}, bank "
                  f"{w.bank_rows} rows")
    elif plan.layout == "global":
        pw = plan.glob.pw
        detail = (f", {'aligned' if pw.aligned else 'unaligned'} pieces, "
                  f"table {pw.table_rows} rows")
    return f"layout: {plan.layout} ({planner} plan{detail})"


def cmd_spgemm(args) -> int:
    from nsparse_tpu_torch.ops.spgemm import (
        spgemm_numeric,
        spgemm_plan,
        spgemm_plan_device,
    )
    from nsparse_tpu_torch.ops.spgemm_bsr import choose_spgemm_path

    dtype = np.float32 if args.precision == "single" else np.float64
    dev = _device(args.device)
    a = _load(args.matrix, dtype)
    m, n = a.shape
    print(f"matrix: {args.matrix}  M={m} N={n} nnz={a.nnz}")

    method = args.method
    if method == "auto":
        method = choose_spgemm_path(a, a)
        print(f"method: {method} (auto)")
    if method == "bsr":
        return _spgemm_bsr(a, dev, args.trials)

    # auto: the one-shot device planner, as the JAX CLI without a cache
    planner = "device" if args.planner == "auto" else args.planner
    a_d = a.to(dev)
    t0 = time.perf_counter()
    if planner == "host":
        plan = spgemm_plan(a, a)
        sym_ms = (time.perf_counter() - t0) * 1e3
        plan_d = plan.to(dev)
    else:
        plan = plan_d = spgemm_plan_device(a_d, a_d)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        sym_ms = (time.perf_counter() - t0) * 1e3
    # the compression funnel the reference prints (spgemm_hash.cu:64)
    print(f"nnz(A): {a.nnz}  intermediate products: {plan.n_products}  "
          f"nnz(C): {plan.c_nnz}")
    print(f"symbolic ({planner} plan, {plan.planner} planner): "
          f"{sym_ms:.1f} ms")
    print(_layout_line(plan, planner))

    ms, where = _timed(lambda: spgemm_numeric(plan_d, a_d, a_d), dev,
                       args.trials)
    line = f"SpGEMM numeric [{where}]: {ms:.4f} ms"
    if dev.type == "cuda":
        from nsparse_tpu_torch.utils.roofline import (
            chip_specs,
            spgemm_roofline_gflops,
        )
        from nsparse_tpu_torch.utils.timing import gflops

        spec = chip_specs(where)
        roof = spgemm_roofline_gflops(
            a.nnz, a.nnz, plan.c_nnz, plan.n_products, spec,
            val_bytes=np.dtype(dtype).itemsize)
        gf = gflops(plan.flops, ms)
        line += (f"  {gf:.2f} GFLOPS  ({100 * gf / roof:.1f}% of "
                 f"{spec.name} roofline)")
    print(line)

    return _check_spgemm(spgemm_numeric(plan_d, a_d, a_d), a)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="nsparse_tpu_torch")
    ap.add_argument("--precision", choices=["single", "double"],
                    default="double")
    sub = ap.add_subparsers(dest="cmd", required=True)

    def add_device(p):
        p.add_argument("--device", default="cuda",
                       help="where to run: cuda (default; fails without a "
                            "card) or cpu")

    sp = sub.add_parser("spmv", help="y = A @ x in a chosen or tuned format")
    sp.add_argument("matrix")
    sp.add_argument("--format", choices=["auto", "dia", "ell", "bsr", "csr"],
                    default="auto")
    sp.add_argument("--trials", type=int, default=101)
    sp.add_argument("--tune-trials", type=int, default=5)
    sp.add_argument("--plan-cache", default=None,
                    help="directory of tuning plans, keyed by matrix and card")
    sp.add_argument("--tune-mode", choices=["model", "measure"],
                    default="model",
                    help="tuning objective: the formats' footprint (model) "
                         "or measured time per candidate (measure, on a "
                         "card)")
    add_device(sp)
    sp.set_defaults(fn=cmd_spmv)

    sg = sub.add_parser("spgemm", help="C = A @ A through a plan")
    sg.add_argument("matrix")
    sg.add_argument("--trials", type=int, default=11)
    sg.add_argument("--planner", choices=["auto", "host", "device"],
                    default="auto",
                    help="symbolic phase of the esc method: device = "
                         "one-shot on the card (auto, the default); host = "
                         "the reusable plan in its window, global or sort "
                         "layout")
    sg.add_argument("--method", choices=["auto", "esc", "bsr"],
                    default="auto",
                    help="esc (window path), bsr (dense tile products) or "
                         "auto (the block-statistics cost model)")
    add_device(sg)
    sg.set_defaults(fn=cmd_spgemm)
    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())

"""Command line of the port (counterpart of ``nsparse_tpu/cli.py``).

    python -m nsparse_tpu_torch --precision single spmv gen:stencil:2048:2048 --format dia
    python -m nsparse_tpu_torch --precision single spgemm gen:rmat:14:8
    python -m nsparse_tpu_torch --precision single spgemm gen:rmat:14:8 --planner host
    python -m nsparse_tpu_torch --precision single spgemm gen:fem:4096:16 --method bsr
    python -m nsparse_tpu_torch --precision single spgemm data/circuit_zipf.mtx --plan-cache plans/
    python -m nsparse_tpu_torch --precision single spmv gen:stencil:2048:2048 --format dia --profile traces/
    python -m nsparse_tpu_torch --precision single spgemm gen:rmat:14:8 --planner host --profile traces/
    python -m nsparse_tpu_torch --precision single spmv-xla data/circuit_zipf.mtx
    python -m nsparse_tpu_torch --precision single spgemm-xla data/circuit_zipf.mtx
    python -m nsparse_tpu_torch rap --devices 4 --n 65536

Loads a matrix (a .mtx path, ``gen:stencil:NX:NY``, ``gen:rmat:SCALE:EF``,
``gen:fem:NODES:DOF`` or ``gen:random:M:N:DENSITY``), builds the format or
the plan, times the product and checks it against the scipy oracle,
printing the same lines and pass/FAIL verdict as the JAX CLI.  ``spmv-xla``
and ``spgemm-xla`` are the library yardsticks: one ``torch.sparse_csr_tensor``
product (cuSPARSE on a card), timed and checked the same way.  ``rap``
runs the distributed Galerkin product R @ A @ P (``parallel.rap_halo``)
over a mesh of ``--devices`` shards and checks it against scipy.  It runs on
the card (``--device cuda``, the default), timed with CUDA events; it
refuses to start when no card is visible.  ``--device cpu`` runs it on
the host, timed by the host clock and labelled as such.
"""

from __future__ import annotations

import argparse
import contextlib
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


def _recorded(args):
    """With ``--profile``: the recorder on (``utils.profiling``) for the
    set-up and the traced calls."""
    from nsparse_tpu_torch.utils import profiling

    if not args.profile:
        return contextlib.nullcontext()
    profiling.reset()
    return profiling.recording()


def _profile(fn, *args, trace_dir: str) -> None:
    """Trace calls of ``fn(*args)`` into ``trace_dir`` and print the
    recorder's table of what was recorded so far."""
    from nsparse_tpu_torch.utils.profiling import profile_op, table

    _, pms, tdir = profile_op(fn, *args, trace_dir=trace_dir)
    print(f"trace written to {tdir} ({pms:.4f} ms/iter)")
    print(table())


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

    with _recorded(args):
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
        print(f"conversion/tuning: {(time.perf_counter() - t0) * 1e3:.1f} "
              f"ms  format={plan.format}")

        x_d = x.to(dev)
        if args.profile:
            _profile(spmv, fmt, x_d, trace_dir=args.profile)
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

    # auto: the one-shot device planner, or with a plan cache the
    # reusable host plan, as the JAX CLI chooses
    planner = args.planner
    if planner == "auto":
        planner = "host" if args.plan_cache else "device"
    a_d = a.to(dev)
    hit = False
    with _recorded(args):
        t0 = time.perf_counter()
        if planner == "host":
            if args.plan_cache:
                from nsparse_tpu_torch.tune.spgemm_cache import (
                    spgemm_plan_cached,
                )

                plan, hit = spgemm_plan_cached(a, a, args.plan_cache)
            else:
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
              f"{sym_ms:.1f} ms" + ("  [cache hit]" if hit else ""))
        print(_layout_line(plan, planner))
        if args.profile:
            _profile(spgemm_numeric, plan_d, a_d, a_d,
                     trace_dir=args.profile)

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

    from nsparse_tpu_torch.utils.checking import (
        check_spgemm_answer_device,
        spgemm_abs_oracle,
        spgemm_oracle,
    )

    # checked on the device: only the verdicts come back
    ok = check_spgemm_answer_device(
        spgemm_numeric(plan_d, a_d, a_d), spgemm_oracle(a, a),
        abs_ref=spgemm_abs_oracle(a, a))
    print("pass" if ok else "FAIL")
    return 0 if ok else 1


def _library_csr(a, dev):
    """``a`` as a ``torch.sparse_csr_tensor`` on ``dev``."""
    a_d = a.to(dev)
    return torch.sparse_csr_tensor(a_d.rpt, a_d.col[: a.nnz],
                                   a_d.val[: a.nnz], size=a.shape)


def cmd_spmv_xla(args) -> int:
    """The library yardstick: ``torch.sparse_csr_tensor @ x`` (cuSPARSE on
    a card)."""
    from nsparse_tpu_torch.utils.checking import (
        ans_check,
        spmv_abs_oracle,
        spmv_oracle,
    )
    from nsparse_tpu_torch.utils.timing import gflops

    dtype = np.float32 if args.precision == "single" else np.float64
    dev = _device(args.device)
    a = _load(args.matrix, dtype)
    m, n = a.shape
    print(f"matrix: {args.matrix}  M={m} N={n} nnz={a.nnz}")
    x = torch.from_numpy(
        np.random.default_rng(0).standard_normal(n).astype(dtype))
    csr, x_d = _library_csr(a, dev), x.to(dev)
    ms, where = _timed(lambda: csr @ x_d, dev, args.trials)
    print(f"SpMV [torch.sparse_csr, {where}]: {ms:.4f} ms  "
          f"{gflops(2.0 * a.nnz, ms):.2f} GFLOPS")
    ok, nf = ans_check(csr @ x_d, spmv_oracle(a, x), dtype=dtype,
                       scale=spmv_abs_oracle(a, x))
    print("pass" if ok else f"FAIL ({nf} mismatches)")
    return 0 if ok else 1


def cmd_spgemm_xla(args) -> int:
    """The library yardstick: ``torch.sparse_csr_tensor @
    torch.sparse_csr_tensor`` (cuSPARSE on a card, which plans in every
    call).  A refusal by the library is reported with exit code 1."""
    import scipy.sparse as sp

    from nsparse_tpu_torch.formats.csr import CSR
    from nsparse_tpu_torch.ops.spgemm import spgemm_flops
    from nsparse_tpu_torch.utils.timing import gflops

    dtype = np.float32 if args.precision == "single" else np.float64
    dev = _device(args.device)
    a = _load(args.matrix, dtype)
    m, n = a.shape
    print(f"matrix: {args.matrix}  M={m} N={n} nnz={a.nnz}")
    csr = _library_csr(a, dev)
    try:
        ms, where = _timed(lambda: csr @ csr, dev, args.trials)
        c = csr @ csr
    except RuntimeError as e:  # the library refuses some products
        print(f"SpGEMM [torch.sparse_csr]: unsupported on this device ({e})")
        return 1
    print(f"SpGEMM [torch.sparse_csr, {where}]: {ms:.4f} ms  "
          f"{gflops(spgemm_flops(a, a), ms):.2f} GFLOPS")
    got = sp.csr_matrix((c.values().cpu().numpy(),
                         c.col_indices().cpu().numpy(),
                         c.crow_indices().cpu().numpy()), shape=c.shape)
    return _check_spgemm(CSR.from_scipy(got), a)


def cmd_rap(args) -> int:
    """Distributed R @ A @ P over a mesh of ``--devices`` shards: A the
    5-point stencil on about ``--n`` unknowns (or a loaded matrix), P the
    4:1 consecutive aggregation, R = P^T, through ``rap_halo``; checked
    against scipy with the |R||A||P| bound.  On the card each shard takes
    a card of its own when there are enough, else every shard shares the
    first (a virtual mesh; the JAX CLI forces one on the host)."""
    import scipy.sparse as sp

    from nsparse_tpu_torch.formats.csr import CSR
    from nsparse_tpu_torch.io.generate import stencil_csr
    from nsparse_tpu_torch.parallel import (
        gather_partitioned,
        make_mesh,
        partition_rows,
        rap_halo,
    )
    from nsparse_tpu_torch.utils.checking import check_spgemm_answer

    dtype = np.float32 if args.precision == "single" else np.float64
    dev = _device(args.device)
    d = args.devices
    if dev.type == "cuda" and torch.cuda.device_count() >= d:
        mesh = make_mesh(d)
    else:
        mesh = make_mesh(d, device=dev)
    names = [str(x) for x in mesh.devices]
    print(f"mesh: {d} shards on "
          + (f"{names[0]} (virtual mesh)" if len(set(names)) == 1
             else ", ".join(names)))
    n = args.n
    a = _load(args.matrix, dtype) if args.matrix else stencil_csr(
        int(n ** 0.5), n // int(n ** 0.5), dtype=dtype)
    n = a.shape[0]
    nc = n // 4
    agg = np.arange(n) // 4
    p_s = sp.csr_matrix((np.ones(n, dtype), (np.arange(n), agg)),
                        shape=(n, nc))
    p = CSR.from_scipy(p_s)
    r = CSR.from_scipy(p_s.T.tocsr())
    print(f"R({nc}x{n}) @ A({n}x{n}, nnz={a.nnz}) @ P({n}x{nc}) "
          f"over a {d}-device mesh")

    t0 = time.perf_counter()
    parts = [partition_rows(x, d, mesh=mesh) for x in (r, a, p)]
    got = gather_partitioned(rap_halo(*parts, mesh))
    print(f"plans, numeric and gather: {time.perf_counter() - t0:.2f} s "
          "host time")
    ref = (r.to_scipy() @ a.to_scipy() @ p.to_scipy()).tocsr()
    ref.sum_duplicates()
    ref.sort_indices()
    sa = (abs(r.to_scipy()) @ abs(a.to_scipy()) @ abs(p.to_scipy())).tocsr()
    sa.sum_duplicates()
    sa.sort_indices()
    ok = check_spgemm_answer(got, ref, abs_ref=sa)
    print(f"halo R.A.P: nnz(RAP)={got.nnz}  "
          f"{'pass' if ok else 'FAIL'} (all comm = neighbor halo copies)")
    return 0 if ok else 1


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
    sp.add_argument("--profile", default=None, metavar="TRACE_DIR",
                    help="write a torch.profiler trace (Chrome JSON) of "
                         "the SpMV into TRACE_DIR and print the recorder's "
                         "spans and counters of the conversion and the "
                         "traced calls")
    add_device(sp)
    sp.set_defaults(fn=cmd_spmv)

    sx = sub.add_parser("spmv-xla", help="the library yardstick: "
                        "torch.sparse_csr_tensor @ x")
    sx.add_argument("matrix")
    sx.add_argument("--trials", type=int, default=101)
    add_device(sx)
    sx.set_defaults(fn=cmd_spmv_xla)

    sg = sub.add_parser("spgemm", help="C = A @ A through a plan")
    sg.add_argument("matrix")
    sg.add_argument("--trials", type=int, default=11)
    sg.add_argument("--planner", choices=["auto", "host", "device"],
                    default="auto",
                    help="symbolic phase of the esc method: device = "
                         "one-shot on the card (auto without a plan "
                         "cache); host = the reusable plan in its window, "
                         "global or sort layout (auto with a plan cache)")
    sg.add_argument("--method", choices=["auto", "esc", "bsr"],
                    default="auto",
                    help="esc (window path), bsr (dense tile products) or "
                         "auto (the block-statistics cost model)")
    sg.add_argument("--plan-cache", default=None, metavar="DIR",
                    help="directory of saved SpGEMM plans (the host plan, "
                         "keyed by the sparsity fingerprints); with "
                         "--planner auto it selects the host planner")
    sg.add_argument("--profile", default=None, metavar="TRACE_DIR",
                    help="write a torch.profiler trace (Chrome JSON) of "
                         "the numeric phase into TRACE_DIR and print the "
                         "recorder's spans and counters of the plan and "
                         "the traced calls")
    add_device(sg)
    sg.set_defaults(fn=cmd_spgemm)

    sgx = sub.add_parser("spgemm-xla", help="the library yardstick: "
                         "torch.sparse_csr_tensor @ torch.sparse_csr_tensor")
    sgx.add_argument("matrix")
    sgx.add_argument("--trials", type=int, default=11)
    add_device(sgx)
    sgx.set_defaults(fn=cmd_spgemm_xla)

    sr = sub.add_parser("rap", help="distributed R.A.P over a mesh")
    sr.add_argument("matrix", nargs="?", default=None)
    sr.add_argument("--devices", type=int, default=8)
    sr.add_argument("--n", type=int, default=1024)
    add_device(sr)
    sr.set_defaults(fn=cmd_rap)
    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())

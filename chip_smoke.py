#!/usr/bin/env python3
"""Drive the PyTorch port's SpGEMM main path once on one CUDA card.

    python3 chip_smoke.py          # from the repository root, one card

Phases (any failure exits non-zero before the final line):
  1. the card's name and power limit (nvidia-smi) and the toolchain;
  2. build the four Hopper kernels from ``nsparse_tpu_torch/csrc``;
  3. the main path at its headline size: C = A @ A on R-MAT-14 (edge
     factor 8, seed 1, float32) — ``spgemm_plan`` on the host, then
     ``spgemm_numeric`` on cuda:0 with every launch count set to 0 just
     before and read just after; C is checked against the scipy oracle
     with the |A||B| bound, then re-run with new values on the same plan,
     in float32 and in float64;
  4. each kernel against its plain PyTorch version on the card, on the
     inputs the main path gives it, and both timed with CUDA events;
  5. the numeric phase timed with the kernels and with the plain versions;
  6. the numeric phase under torch.profiler: device busy time per call
     against the wall, device operations per call, and each device
     kernel's share of the device time.
The second-to-last line is the kernel table as JSON; the last line is
``{"ok": true, "device": {...}}``.
"""

import json
import subprocess
import sys
import time

import numpy as np

SCALE, EDGE_FACTOR, SEED = 14, 8, 1
# structural counts of the headline product (device independent)
N_PRODUCTS, NNZ_C = 17_075_504, 8_935_048
TRIALS = 20

KERNELS = {
    # NumericOps field: (name, route, source, the TPU kernel it replaces)
    "expand": ("expand", "cuda", "nsparse_tpu_torch/csrc/expand.cu",
               "nsparse_tpu/ops/kernels/piecewise.py:492"),
    "gather": ("gather", "cuda", "nsparse_tpu_torch/csrc/gather.cu",
               "nsparse_tpu/ops/kernels/shuffle_pallas.py:399"),
    "fused": ("fused_class", "cuda", "nsparse_tpu_torch/csrc/fused_class.cu",
              "nsparse_tpu/ops/kernels/window_fused.py:463"),
    "runcopy": ("runcopy", "cuda", "nsparse_tpu_torch/csrc/runcopy.cu",
                "nsparse_tpu/ops/kernels/runcopy.py:1035"),
}


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def card_line() -> str:
    r = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return r.stdout.strip().splitlines()[0]


def record_calls(plan, a, numeric, kernel_ops):
    """Run the window numeric phase ``numeric`` once through recording
    wrappers of ``kernel_ops``; returns {field: [args of each call]} —
    every kernel call of the main path with the inputs it gives it."""
    ops_type = type(kernel_ops)
    calls = {f: [] for f in ops_type._fields}

    def recorder(field):
        def call(*args):
            calls[field].append(args)
            return getattr(kernel_ops, field)(*args)
        return call

    numeric(plan, a, a, ops=ops_type(*map(recorder, ops_type._fields)))
    return calls


def short_name(kernel: str) -> str:
    """A device kernel's name without its argument list, cut to 90
    characters (the template arguments name the elementwise op)."""
    name = kernel[5:] if kernel.startswith("void ") else kernel
    name = name.replace("(anonymous namespace)::", "")
    depth = 0
    for i, ch in enumerate(name):
        depth += {"<": 1, ">": -1}.get(ch, 0)
        if ch == "(" and depth == 0 and i:
            name = name[:i]
            break
    return name[:90].rstrip()


def profile_numeric(torch, fn, calls: int = 10) -> None:
    """Print where the device time of ``calls`` runs of ``fn`` goes, as
    torch.profiler records it (the wall clock includes the profiler's own
    host cost)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / calls
    by_name = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            us, n = by_name.get(short_name(e.name), (0.0, 0))
            by_name[short_name(e.name)] = (us + e.time_range.elapsed_us(), n + 1)
    if not by_name:
        print("profile: torch.profiler recorded no device events "
              "(device breakdown not measured)")
        return
    busy_ms = sum(us for us, _ in by_name.values()) / calls / 1e3
    n_ops = sum(n for _, n in by_name.values()) / calls
    print(f"profile ({calls} numeric calls, profiler on): device busy "
          f"{busy_ms:.4f} ms per call of {wall_ms:.4f} ms wall "
          f"({100 * busy_ms / wall_ms:.1f}%), {n_ops:g} device ops per call")
    for name, (us, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0]):
        print(f"  {100 * us / calls / 1e3 / busy_ms:5.1f}%  "
              f"{us / calls / 1e3:.4f} ms  {n / calls:g}/call  {name}")


def main() -> None:
    try:
        import torch
    except ImportError as e:
        fail(f"torch is not importable: {e}")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a card")
    try:
        import nsparse_tpu_torch as nt
        from nsparse_tpu_torch.ops.kernels import (
            cuda_lib, piecewise, runcopy, shuffle, window_fused)
        from nsparse_tpu_torch.ops.spgemm_window import (
            KERNEL_OPS, PLAIN_OPS, spgemm_numeric_window)
        from nsparse_tpu_torch.utils.timing import time_cuda
    except ImportError as e:
        fail(f"the port is not importable (run from the repository root): {e}")

    card = card_line()
    print(card)
    name = torch.cuda.get_device_name(0)
    print(f"device: {name}  torch {torch.__version__}  cuda "
          f"{torch.version.cuda}  python {sys.version.split()[0]}")
    dev = torch.device("cuda:0")

    t0 = time.perf_counter()
    cuda_lib.KERNELS.get()
    print(f"kernels built: {time.perf_counter() - t0:.1f} s "
          f"(nvcc {' '.join(cuda_lib.NVCC_FLAGS)})", flush=True)

    a = nt.rmat_csr(SCALE, EDGE_FACTOR, dtype=np.float32, seed=SEED)
    t0 = time.perf_counter()
    plan = nt.spgemm_plan(a, a)
    print(f"R-MAT-{SCALE} C = A^2 f32: nnz(A) {a.nnz}  intermediate products "
          f"{plan.n_products}  nnz(C) {plan.c_nnz}  host plan "
          f"{time.perf_counter() - t0:.1f} s ({plan.planner} planner)",
          flush=True)
    if (plan.n_products, plan.c_nnz) != (N_PRODUCTS, NNZ_C):
        fail(f"funnel {plan.n_products}/{plan.c_nnz}, "
             f"expected {N_PRODUCTS}/{NNZ_C}")
    plan_d, a_d = plan.to(dev), a.to(dev)

    wrappers = {"gather": shuffle.gather,
                "expand": piecewise.piecewise_expand,
                "fused_class": window_fused.fused_class_apply,
                "runcopy": runcopy.runcopy}
    for fn in wrappers.values():
        fn.launches = 0
    c = nt.spgemm_numeric(plan_d, a_d, a_d)
    torch.cuda.synchronize()
    launches = {k: fn.launches for k, fn in wrappers.items()}
    print(f"main path launches: {launches}")
    if min(launches.values()) < 1:
        fail(f"a kernel of the main path never launched: {launches}")

    ref_ok = nt.check_spgemm_answer(
        c, nt.spgemm_oracle(a, a), verbose=True,
        abs_ref=nt.spgemm_abs_oracle(a, a))
    vals = c.val[: c.nnz]
    print(f"C vs scipy (rtol 1e-5, |A||B| bound): "
          f"{'pass' if ref_ok else 'FAIL'}  finite "
          f"{bool(torch.isfinite(vals).all())}")
    if not ref_ok or not torch.isfinite(vals).all():
        fail("C does not match the scipy oracle")

    v2 = np.random.default_rng(SEED + 1).standard_normal(a.nnz)
    a2 = a.with_values(torch.from_numpy(v2.astype(np.float32)))
    c2 = nt.spgemm_numeric(plan_d, a2.to(dev), a2.to(dev))
    rerun_ok = nt.check_spgemm_answer(
        c2, nt.spgemm_oracle(a2, a2), verbose=True,
        abs_ref=nt.spgemm_abs_oracle(a2, a2))
    print(f"value re-run on the same plan vs scipy: "
          f"{'pass' if rerun_ok else 'FAIL'}")
    if not rerun_ok:
        fail("value re-run does not match the scipy oracle")

    a64 = a2.with_values(torch.from_numpy(v2))
    c64 = nt.spgemm_numeric(plan_d, a64.to(dev), a64.to(dev))
    f64_ok = nt.check_spgemm_answer(
        c64, nt.spgemm_oracle(a64, a64), verbose=True,
        abs_ref=nt.spgemm_abs_oracle(a64, a64))
    print(f"float64 values on the same plan vs scipy (rtol 1e-8): "
          f"{'pass' if f64_ok else 'FAIL'}")
    if not f64_ok:
        fail("float64 numeric does not match the scipy oracle")

    # each kernel vs its plain version, on the main path's own inputs
    calls = record_calls(plan_d, a_d, spgemm_numeric_window, KERNEL_OPS)
    table = []
    for field, (kname, route, src, replaces) in KERNELS.items():
        kernel, plain = getattr(KERNEL_OPS, field), getattr(PLAIN_OPS, field)
        err = 0.0
        for args in calls[field]:
            got, want = kernel(*args), plain(*args)
            if got.shape != want.shape:
                fail(f"{kname}: shape {tuple(got.shape)} != "
                     f"{tuple(want.shape)}")
            err = max(err, float((got - want).abs().max()))

        def run(fn, arglist=calls[field]):
            for args in arglist:
                fn(*args)

        plain_ms = time_cuda(lambda: run(plain), trials=TRIALS)
        ms = time_cuda(lambda: run(kernel), trials=TRIALS)
        table.append(dict(
            name=kname, route=route, source=src, replaces=replaces,
            launches=launches[kname], max_abs_err=err, ms=ms,
            plain_ms=plain_ms, calls_per_numeric=len(calls[field])))
        print(f"{kname}: {len(calls[field])} call(s)/numeric  max_abs_err "
              f"{err} (tolerance: exact)  kernel {ms:.4f} ms  plain "
              f"{plain_ms:.4f} ms  [{name}]", flush=True)
        if err != 0.0:
            fail(f"{kname} disagrees with its plain version: {err}")

    # numeric phase: plain, kernels, kernels, plain (one card, one call)
    times = {"plain": [], "kernels": []}
    for mode in ("plain", "kernels", "kernels", "plain"):
        ops = PLAIN_OPS if mode == "plain" else KERNEL_OPS
        times[mode].append(time_cuda(
            lambda: spgemm_numeric_window(plan_d, a_d, a_d, ops=ops),
            trials=TRIALS))
    ms_k, ms_p = float(np.mean(times["kernels"])), float(np.mean(times["plain"]))
    print(f"numeric phase [{name}, {card}]: kernels {ms_k:.4f} ms "
          f"({times['kernels']})  plain {ms_p:.4f} ms ({times['plain']})  "
          f"{2 * plan.n_products / (ms_k * 1e-3) / 1e9:.2f} GFLOPS")
    profile_numeric(torch, lambda: spgemm_numeric_window(plan_d, a_d, a_d))

    print(json.dumps({"kernels": table}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()

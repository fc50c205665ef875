#!/usr/bin/env python3
"""Host cost of the SpGEMM plan cache on one R-MAT matrix.

    python3 tools/plan_cache_cost.py [SCALE] [LAYOUT]

Builds the host plan of C = A @ A for ``rmat_csr(SCALE, 8, seed=1)`` in
float32 (``LAYOUT``: window, the default, global or sort), saves it with
``save_spgemm_plan`` into a temporary directory and loads it back with
``load_spgemm_plan`` (every index table checked), and prints the build,
save and load host seconds and the file's MB.  Runs on the CPU; no card.
Keep SCALE small on a shared machine (R-MAT-14's window plan is about
0.5 GB).
"""

import os
import sys
import tempfile
import time

import numpy as np


def main() -> None:
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
        __file__))))
    import nsparse_tpu_torch as nt
    from nsparse_tpu_torch.tune import spgemm_cache as sc

    scale = int(sys.argv[1]) if len(sys.argv) > 1 else 12
    layout = sys.argv[2] if len(sys.argv) > 2 else "window"
    kw = (dict(shuffle=False) if layout == "sort"
          else dict(shuffle=True, layout=layout))
    a = nt.rmat_csr(scale, 8, dtype=np.float32, seed=1)
    t0 = time.perf_counter()
    plan = nt.spgemm_plan(a, a, **kw)
    t_build = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "plan.npz")
        t0 = time.perf_counter()
        sc.save_spgemm_plan(plan, path)
        t_save = time.perf_counter() - t0
        t0 = time.perf_counter()
        sc.load_spgemm_plan(path)
        t_load = time.perf_counter() - t0
        mb = os.path.getsize(path) / 1e6
    print(f"R-MAT-{scale} {plan.layout} plan (P {plan.n_products}): build "
          f"{t_build:.2f} s, {mb:.1f} MB, save {t_save:.2f} s, load "
          f"{t_load:.2f} s (host, tables checked)")


if __name__ == "__main__":
    main()

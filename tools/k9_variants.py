#!/usr/bin/env python3
"""What K9's time is made of, on one card: variants of
``nsparse_tpu_torch/csrc/spgemm_bsr.cu`` timed on the block paths' tile
products.

    python3 tools/k9_variants.py        # from the repository root

Each variant is the source with a few lines replaced (``VARIANTS``),
built with the kernels' nvcc flags into ``_build/`` and called through its
C entry point on the FEM f32 (4,096 nodes) and FEM-512 f64 block plans
that ``chip_smoke.py`` drives, in turns, the source as it is first and
last.  ``one-pass`` keeps only the hi * hi TF32 product: one TF32 pass,
which is not float32-accurate (its error is printed, not held); its time
beside the three passes says how much of K9 the tensor-core work is.
``one-block`` is the float32 ring of the first tensor-core design, 4
stages and one block an SM.
"""

import ctypes
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

VARIANTS = {
    "as built": [],
    "one-pass": [
        ("mma_tf32(acc[i][j], al[i], bh[j]);", "(void)0;"),
        ("mma_tf32(acc[i][j], ah[i], bl[j]);", "(void)0;"),
    ],
    "one-block": [
        ("static constexpr int kStages = 3;",
         "static constexpr int kStages = 4;"),
        ("static constexpr int kMinBlocks = 2;",
         "static constexpr int kMinBlocks = 1;"),
    ],
}
ORDER = ("as built", "one-pass", "one-block", "as built")
TRIALS = 10


def build(name: str, text: str):
    """The variant's library, built from ``text``."""
    from nsparse_tpu_torch.buildlib import BUILD_DIR, build_shared
    from nsparse_tpu_torch.ops.kernels.cuda_lib import (
        CSRC_DIR, NVCC_FLAGS, nvcc)

    for old, new in VARIANTS[name]:
        if old not in text:
            sys.exit(f"k9_variants: {name}: {old!r} is not in the source")
        text = text.replace(old, new)
    tag = name.replace(" ", "_")
    src_dir = os.path.join(BUILD_DIR, "k9_variants")
    os.makedirs(src_dir, exist_ok=True)
    src = os.path.join(src_dir, f"spgemm_bsr_{tag}.cu")
    with open(src, "w") as f:
        f.write(text)
    lib = build_shared(f"libk9_{tag}", [src],
                       [nvcc(), *NVCC_FLAGS, "-I", CSRC_DIR], timeout=900)
    fns = {}
    for sfx in ("f32", "f64"):
        fn = getattr(lib, f"nsp_spgemm_bsr_{sfx}")
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int64, ctypes.c_int,
                                               ctypes.c_void_p,
                                               ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fns[sfx] = fn
    return fns


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        sys.exit("k9_variants: torch.cuda.is_available() is false")
    import chip_smoke as cs
    import nsparse_tpu_torch as nt
    from nsparse_tpu_torch.ops.kernels.bsr_blocks import (
        spgemm_bsr_blocks_plain)
    from nsparse_tpu_torch.ops.kernels.cuda_lib import CSRC_DIR
    from nsparse_tpu_torch.utils.timing import time_cuda

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(card, flush=True)
    with open(os.path.join(CSRC_DIR, "spgemm_bsr.cu")) as f:
        text = f.read()
    with ThreadPoolExecutor(len(VARIANTS)) as pool:
        libs = dict(zip(VARIANTS, pool.map(lambda n: build(n, text),
                                           VARIANTS)))
    dev = torch.device("cuda:0")
    for what, cfg, dtype in (("FEM f32", cs.FEM, np.float32),
                             ("FEM-512 f64", cs.FEM_F64, np.float64)):
        a = nt.fem_block_csr(cfg["n_nodes"], dof=cfg["dof"],
                             neighbors=cfg["neighbors"],
                             bandwidth=cfg["bandwidth"], dtype=dtype,
                             seed=cfg["seed"])
        p = nt.plan_spgemm_bsr(a, a).to(dev)
        args = (p.a_blocks, p.b_blocks, p.pair_a, p.pair_b, p.pair_c,
                p.c_pair_start)
        want = spgemm_bsr_blocks_plain(*args)
        scale = spgemm_bsr_blocks_plain(args[0].abs(), args[1].abs(),
                                        *args[2:]).clamp(min=1e-30)
        c = torch.empty_like(want)
        flops = 2.0 * p.n_pairs * p.bs ** 3
        sfx = "f32" if dtype == np.float32 else "f64"
        for name in ORDER:
            fn = libs[name][sfx]

            def run():
                rc = fn(*(t.data_ptr() for t in args[:4]),
                        args[5].data_ptr(), p.n_c_blocks, p.bs, c.data_ptr(),
                        torch.cuda.current_stream(dev).cuda_stream)
                if rc:
                    sys.exit(f"k9_variants: {name}: CUDA error {rc}")

            run()
            torch.cuda.synchronize()
            err = float(((c - want).abs() / scale).max())
            ms = time_cuda(run, trials=TRIALS)
            print(f"{what} {name} [{card}]: {ms:.4f} ms by CUDA events, "
                  f"{flops / (ms * 1e-3) / 1e12:.2f} TFLOP/s of tile "
                  f"products, max |err| / (|A||B|) vs the plain version "
                  f"{err:.3g}", flush=True)


if __name__ == "__main__":
    main()

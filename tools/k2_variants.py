#!/usr/bin/env python3
"""K2's piece modes at other block sizes, on one card: variants of
``nsparse_tpu_torch/csrc/expand.cu`` timed on the global layout's calls.

    python3 tools/k2_variants.py        # from the repository root

Each variant is the source with a few lines replaced (``VARIANTS``),
built with the kernels' nvcc flags into ``_build/`` and called through its
C entry point on the one piece-mode call of R-MAT-14 in the global slab
layout and the one flat-mode call of R-MAT-16 (edge factor 4), the calls
``chip_smoke.py`` drives, in float32, in turns, the source as it is
first and last.  Each call is timed by CUDA events around 20 launches
queued behind a device sleep, and checked against the source as built
with ``torch.equal``.
"""

import ctypes
import os
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

VARIANTS = {
    "as built": [],
    # a thread's slots: 4 (256 threads a block) or 16 (64 threads)
    "256 threads": [("constexpr int kPieceThreads = 128;",
                     "constexpr int kPieceThreads = 256;")],
    "64 threads": [("constexpr int kPieceThreads = 128;",
                    "constexpr int kPieceThreads = 64;")],
}
ORDER = ("as built", "256 threads", "64 threads", "as built")
QUEUED = 20


def build(name: str, text: str):
    """The variant's float32 piece-mode entry point, built from ``text``."""
    from nsparse_tpu_torch.buildlib import BUILD_DIR, build_shared
    from nsparse_tpu_torch.ops.kernels.cuda_lib import (
        _SIGNATURES, CSRC_DIR, NVCC_FLAGS, nvcc)

    for old, new in VARIANTS[name]:
        if old not in text:
            sys.exit(f"k2_variants: {name}: {old!r} is not in the source")
        text = text.replace(old, new)
    tag = name.replace(" ", "_")
    src_dir = os.path.join(BUILD_DIR, "k2_variants")
    os.makedirs(src_dir, exist_ok=True)
    src = os.path.join(src_dir, f"expand_{tag}.cu")
    with open(src, "w") as f:
        f.write(text)
    lib = build_shared(f"libk2_{tag}", [src],
                       [nvcc(), *NVCC_FLAGS, "-I", CSRC_DIR], timeout=900)
    fn = lib.nsp_expand_pieces_f32
    fn.argtypes = _SIGNATURES["nsp_expand_pieces"]
    fn.restype = ctypes.c_int
    return fn


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        sys.exit("k2_variants: torch.cuda.is_available() is false")
    import chip_smoke as cs
    import nsparse_tpu_torch as nt
    from nsparse_tpu_torch.ops.kernels import piecewise
    from nsparse_tpu_torch.ops.kernels.cuda_lib import validate

    card = cs.card_line()
    print(card, flush=True)
    with open(os.path.join(ROOT, "nsparse_tpu_torch", "csrc",
                           "expand.cu")) as f:
        text = f.read()
    with ThreadPoolExecutor(len(VARIANTS)) as pool:
        libs = dict(zip(VARIANTS, pool.map(lambda n: build(n, text),
                                           VARIANTS)))

    dev = torch.device("cuda:0")
    cases = []
    for what, a in (
            ("R-MAT-14 global (piece mode)", nt.rmat_csr(
                cs.SCALE, cs.EDGE_FACTOR, dtype=np.float32, seed=cs.SEED)),
            ("R-MAT-16 global (flat mode)", nt.rmat_csr(
                cs.UNALIGNED["scale"], cs.UNALIGNED["edge_factor"],
                dtype=np.float32, seed=cs.UNALIGNED["seed"]))):
        g = nt.spgemm_plan(a, a, layout="global").glob
        pw, ad = g.pw.to(dev), a.to(dev)
        table = piecewise.build_table(pw, g.b8_idx.to(dev), ad.val)
        apv = ad.val[pw.apv_idx.long().clamp(min=0)] * (pw.apv_idx >= 0)
        out = torch.empty(pw.n_compact * piecewise.TILE, device=dev)
        tb = pw.pieces
        args = validate("k2", table, apv, tb.cuts, tb.boffs, tb.cls,
                        len(tb.rows), tb.n_sub,
                        piecewise.LANES if pw.aligned else 1, out)[2]
        cases.append((what, args, out))
    stream = torch.cuda.current_stream().cuda_stream
    ref = {}
    for name in ORDER:
        fn = libs[name]
        for what, args, out in cases:
            def run(c=args):
                return fn(*c, stream)

            if run():
                print(f"{name}: {what}: launch error", flush=True)
                continue
            torch.cuda.synchronize()
            got = out.clone()
            same = torch.equal(got, ref.setdefault(what, got))
            ms = cs.queued_device_ms(torch, run, calls=QUEUED)
            print(f"{name} [{card}] {what}: {cs.fmt_ms(ms)} ms queued, "
                  f"equal to as built: {same}", flush=True)


if __name__ == "__main__":
    main()

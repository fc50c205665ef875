#!/usr/bin/env python3
"""What K3's time is made of, on one card: variants of
``nsparse_tpu_torch/csrc/fused_class.cu`` timed on R-MAT-14's classes.

    python3 tools/k3_variants.py        # from the repository root

Each variant is the source with a few lines replaced (``VARIANTS``),
built with the kernels' nvcc flags into ``_build/`` and called through its
C entry points on every class of the v2 and the v1 window plan of C = A^2
on R-MAT-14 (the headline product of ``chip_smoke.py``), in float32, in
turns, the source as it is first and last.  Each class is timed by CUDA
events around 20 launches queued behind a device sleep (the device's time
alone), with the blocks per window each variant takes.  Variants that
change what the kernel computes (``no zero fill``, ``no extraction``,
``v1 reads x in order``) are timed only, to say what their part costs;
the others are checked against the source as built with
``torch.equal``.
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
    # the block's zero fill of its output slots
    "no zero fill": [
        ("    tb.out[base + rank * local_w + i] = T(0);\n", ""),
    ],
    # the extraction: its table reads and scattered writes
    "no extraction": [
        ("  if (d >= 0) out[d] = v;", "  (void)out; (void)d; (void)v;"),
    ],
    # v1's product gather (random reads within the window) against reads
    # in order
    "v1 reads x in order": [
        ("v[m] = __ldg(tb.x + base + __ldg(tb.tile + base + f));",
         "v[m] = __ldg(tb.x + base + f);"),
    ],
    "256 threads": [
        ("constexpr int kMaxThreads = 512;",
         "constexpr int kMaxThreads = 256;"),
    ],
    # no cluster: the W = 32768 class on 106 blocks
    "one block a window": [
        ("constexpr int kMaxCluster = 8;", "constexpr int kMaxCluster = 1;"),
    ],
}
EXACT = ("as built", "256 threads", "one block a window")
ORDER = ("as built", "no zero fill", "no extraction", "v1 reads x in order",
         "256 threads", "one block a window", "as built")
QUEUED = 20


def build(name: str, text: str):
    """The variant's (v1, v2) float32 entry points and its geometry query,
    built from ``text``."""
    from nsparse_tpu_torch.buildlib import BUILD_DIR, build_shared
    from nsparse_tpu_torch.ops.kernels.cuda_lib import (
        _SIGNATURES, CSRC_DIR, NVCC_FLAGS, nvcc)

    for old, new in VARIANTS[name]:
        if old not in text:
            sys.exit(f"k3_variants: {name}: {old!r} is not in the source")
        text = text.replace(old, new)
    tag = name.replace(" ", "_")
    src_dir = os.path.join(BUILD_DIR, "k3_variants")
    os.makedirs(src_dir, exist_ok=True)
    src = os.path.join(src_dir, f"fused_class_{tag}.cu")
    with open(src, "w") as f:
        f.write(text)
    lib = build_shared(f"libk3_{tag}", [src],
                       [nvcc(), *NVCC_FLAGS, "-I", CSRC_DIR], timeout=900)
    fns = []
    for entry in ("nsp_fused_class", "nsp_fused_class_v2"):
        fn = getattr(lib, entry + "_f32")
        fn.argtypes, fn.restype = _SIGNATURES[entry], ctypes.c_int
        fns.append(fn)
    geom = lib.nsp_fused_class_geom
    geom.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int64, ctypes.c_int,
                     ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    geom.restype = ctypes.c_int
    return (*fns, geom)


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        sys.exit("k3_variants: torch.cuda.is_available() is false")
    import chip_smoke as cs
    import nsparse_tpu_torch as nt
    from nsparse_tpu_torch.ops import spgemm_window as sw
    from nsparse_tpu_torch.ops.kernels import piecewise
    from nsparse_tpu_torch.ops.kernels.cuda_lib import validate

    card = cs.card_line()
    print(card, flush=True)
    with open(os.path.join(ROOT, "nsparse_tpu_torch", "csrc",
                           "fused_class.cu")) as f:
        text = f.read()
    names = list(VARIANTS)
    with ThreadPoolExecutor(len(names)) as pool:
        libs = dict(zip(names, pool.map(lambda n: build(n, text), names)))

    dev = torch.device("cuda:0")
    a = nt.rmat_csr(cs.SCALE, cs.EDGE_FACTOR, dtype=np.float32, seed=cs.SEED)
    plan2 = nt.spgemm_plan(a, a)
    budget, sw.FUSED_BANK_BUDGET = sw.FUSED_BANK_BUDGET, 0
    try:
        plan1 = nt.spgemm_plan(a, a)
    finally:
        sw.FUSED_BANK_BUDGET = budget
    p2, p1, ad = plan2.to(dev), plan1.to(dev), a.to(dev)
    bank, apv = sw.v2_delivery(p2.win, ad.val, ad.val)
    prod = piecewise.piecewise_expand(p1.win.expand, ad.val, ad.val)
    stream = torch.cuda.current_stream().cuda_stream

    def blocks(geom, fp, expand):
        got = (ctypes.c_int * 4)()
        if geom(int(expand), 4, fp.n_win, fp.w, fp.lv, len(fp.tier_vs), got):
            return "?"
        return got[0]

    def calls(name):
        """Per class: (form, width, blocks per window, a launch of the
        variant, its output)."""
        v1, v2, geom = libs[name]
        out = []
        for fp in p2.win.fused:
            o = torch.empty(fp.slots, device=dev)
            args = validate("k3", bank, apv[fp.apv_lo: fp.apv_hi], fp.etrips,
                            fp.ecuts, fp.eboffs, fp.eends, fp.esub,
                            fp.tile_inv, fp.pyr_dst, fp.tier_idx, o,
                            fp.n_win, fp.w, fp.lv, len(fp.tier_vs),
                            fp.blk // 1024, fp.j2_cap)[2]
            out.append(("v2", fp.w, blocks(geom, fp, True),
                        lambda f=v2, c=args: f(*c, stream), o))
        for fp, (base, slots, _, _) in zip(p1.win.fused, p1.win.class_geom):
            o = torch.empty(fp.slots, device=dev)
            args = validate("k3", prod[base: base + slots], fp.tile_idx,
                            fp.pyr_dst, fp.tier_idx, o, fp.n_win, fp.w,
                            fp.lv, len(fp.tier_vs))[2]
            out.append(("v1", fp.w, blocks(geom, fp, False),
                        lambda f=v1, c=args: f(*c, stream), o))
        return out

    ref = None
    for name in ORDER:
        row, outs = [], []
        for form, w, nb, run, o in calls(name):
            rc = run()
            if rc:
                print(f"{name}: {form} W={w}: launch error {rc}", flush=True)
                row.append((form, w, nb, None))
                outs.append(None)
                continue
            torch.cuda.synchronize()
            outs.append(o.clone())
            row.append((form, w, nb, cs.queued_device_ms(
                torch, run, calls=QUEUED)))
        if ref is None:
            ref = outs
        same = "" if name not in EXACT else " equal to as built: " + str(all(
            o is not None and torch.equal(o, r) for o, r in zip(outs, ref)))
        for form in ("v2", "v1"):
            ms = [m for f, _, _, m in row if f == form]
            tot = None if any(m is None for m in ms) else sum(ms)
            print(f"{name} [{card}] {form}: "
                  + "  ".join(f"W={w} {cs.fmt_ms(m)} ({nb})"
                              for f, w, nb, m in row if f == form)
                  + f"  sum {cs.fmt_ms(tot)} ms queued (blocks per "
                  f"window in brackets){same}", flush=True)


if __name__ == "__main__":
    main()

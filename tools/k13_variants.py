#!/usr/bin/env python3
"""What K13's time is made of, on one card: variants of
``nsparse_tpu_torch/csrc/fallback_sum.cu`` (and of the warp table the
host builds for it) timed on the fallback pools of a Graph500 scale-13
graph (the re-run cell's shape) and of R-MAT-14, in float32.

    python3 tools/k13_variants.py        # from the repository root

Each variant is the source with a few lines replaced (``VARIANTS``) and,
where it says so, the plan rebuilt with another ``THREAD_MAX`` or its
warps in another order; it is built with the kernels' nvcc flags into
``_build/`` and called through its C entry point, in turns, the source as
it is first and last.  Each call is timed by CUDA events around 20
launches queued behind a device sleep (the device's time alone) and
checked against the source as built with ``torch.equal``.
"""

import ctypes
import dataclasses
import os
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

# name: (source edits, THREAD_MAX of the plan, warps in class order)
VARIANTS = {
    "as built": ([], None, False),
    # more registers a thread, fewer blocks an SM
    "two blocks an SM": ([("__launch_bounds__(kThreads, 4)",
                           "__launch_bounds__(kThreads, 2)")], None, False),
    "six blocks an SM": ([("__launch_bounds__(kThreads, 4)",
                           "__launch_bounds__(kThreads, 6)")], None, False),
    # fewer loads in flight a thread
    "batches of 8": ([("constexpr int kBatch = 16;",
                       "constexpr int kBatch = 8;")], None, False),
    # members without a slot (chunks, pads) skip their sources too
    "no dead sources": ([("      j[i] = __ldg(s + stride * bitrev(b * B + i, "
                          "LOG));",
                          "      j[i] = live ? __ldg(s + stride * "
                          "bitrev(b * B + i, LOG)) : -1;")], None, False),
    # width 128 a thread per member; width 64, 32 a warp per member
    "threads to 128": ([("constexpr int kThreadMax = 64;",
                         "constexpr int kThreadMax = 128;"),
                        ("    default: return member_sum<T, 6>",
                         "    case 64: return member_sum<T, 6>(x, s, stride, "
                         "live);\n    default: return member_sum<T, 7>")],
                       128, False),
    "warps from 64": ([("constexpr int kThreadMax = 64;",
                        "constexpr int kThreadMax = 32;")], 32, False),
    "warps from 32": ([("constexpr int kThreadMax = 64;",
                        "constexpr int kThreadMax = 16;")], 16, False),
    # the warps class after class, not by the segment slot they write
    "class order": ([], None, True),
}
EXACT = tuple(VARIANTS)
ORDER = ("as built", *[n for n in VARIANTS if n != "as built"], "as built")
QUEUED = 20


def build(name: str, text: str):
    """The variant's float32 entry point, built from ``text``."""
    from nsparse_tpu_torch.buildlib import BUILD_DIR, build_shared
    from nsparse_tpu_torch.ops.kernels.cuda_lib import (
        _SIGNATURES, CSRC_DIR, NVCC_FLAGS, nvcc)

    for old, new in VARIANTS[name][0]:
        if old not in text:
            sys.exit(f"k13_variants: {name}: {old!r} is not in the source")
        text = text.replace(old, new)
    tag = name.replace(" ", "_")
    src_dir = os.path.join(BUILD_DIR, "k13_variants")
    os.makedirs(src_dir, exist_ok=True)
    src = os.path.join(src_dir, f"fallback_sum_{tag}.cu")
    with open(src, "w") as f:
        f.write(text)
    lib = build_shared(f"libk13_{tag}", [src],
                       [nvcc(), *NVCC_FLAGS, "-I", CSRC_DIR], timeout=900)
    fn = lib.nsp_fallback_sum_f32
    fn.argtypes, fn.restype = _SIGNATURES["nsp_fallback_sum"], ctypes.c_int
    return fn


def rebuilt(fb, thread_max, class_order):
    """``fb`` with its warp table built under ``thread_max`` (or as it
    is), its warps in class order where asked."""
    import torch

    from nsparse_tpu_torch.ops.kernels import fallback

    if thread_max is not None:
        lvl0 = [(w, c) for w, _, c, _ in fb.classes if w > 0]
        n0 = sum(c for _, c in lvl0)
        dst = fb.dst.numpy().astype(np.int64)
        gap = [c for c in fb.classes if c[0] == fallback.GAP]
        gaps = dst[gap[0][3] : gap[0][3] + gap[0][2]] if gap else dst[:0]
        lng = [c for c in fb.classes if c[0] == fallback.LONG]
        ch = fb.chunks.numpy().reshape(-1, 2).astype(np.int64)
        saved, fallback.THREAD_MAX = fallback.THREAD_MAX, thread_max
        try:
            fb = fallback.build_fallback_plan(
                fb.src.numpy(), lvl0, dst[:n0], gaps[gaps >= 0], ch[:, 0],
                ch[:, 1], dst[lng[0][3]:] if lng else dst[:0], fb.n_src,
                fb.n_out)
        finally:
            fallback.THREAD_MAX = saved
    if class_order:
        # the long entries' blocks stay first
        w = fb.warps.view(-1, 2).numpy()
        long_k = [k for k, c in enumerate(fb.classes)
                  if c[0] == fallback.LONG]
        k = np.where(np.isin(w[:, 0], long_k), -1, w[:, 0])
        order = np.lexsort((w[:, 1], k))
        fb = dataclasses.replace(fb, warps=torch.from_numpy(
            w[order].reshape(-1).copy()))
    return fb


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        sys.exit("k13_variants: torch.cuda.is_available() is false")
    import chip_smoke as cs
    import nsparse_tpu_torch as nt
    from nsparse_tpu_torch.ops import spgemm_window as sw
    from nsparse_tpu_torch.ops.kernels import piecewise
    from nsparse_tpu_torch.ops.kernels.cuda_lib import validate

    card = cs.card_line()
    print(card, flush=True)
    with open(os.path.join(ROOT, "nsparse_tpu_torch", "csrc",
                           "fallback_sum.cu")) as f:
        text = f.read()
    names = list(VARIANTS)
    with ThreadPoolExecutor(len(names)) as pool:
        libs = dict(zip(names, pool.map(lambda n: build(n, text), names)))

    dev = torch.device("cuda:0")
    pools = []
    g = cs.g500_graph(nt, 13, 16, cs.SEED)
    a = nt.rmat_csr(cs.SCALE, cs.EDGE_FACTOR, dtype=np.float32, seed=cs.SEED)
    budget, sw.FUSED_BANK_BUDGET = sw.FUSED_BANK_BUDGET, 0
    try:
        for label, m in (("Graph500-13", g), (f"R-MAT-{cs.SCALE}", a)):
            plan = nt.spgemm_plan(m, m)
            md, w = m.to(dev), plan.win
            prod = piecewise.piecewise_expand(w.expand.to(dev), md.val, md.val)
            pools.append((label, w.fb, prod[w.fb_off : w.fb_off + w.fb_len]))
    finally:
        sw.FUSED_BANK_BUDGET = budget
    stream = torch.cuda.current_stream().cuda_stream

    ref = {}
    for name in ORDER:
        _, thread_max, class_order = VARIANTS[name]
        line = []
        for label, fb, x in pools:
            p = rebuilt(fb, thread_max, class_order).to(dev)
            out = torch.empty(p.n_out, device=dev)
            flat = [v for c in p.classes for v in c]
            args = validate("k13", x, p.src, p.dst, p.chunks, p.warps,
                            p.warps.numel() // 2,
                            (ctypes.c_int64 * len(flat))(*flat),
                            len(p.classes), out)[2]

            def run(f=libs[name], c=args):
                return f(*c, stream)

            rc = run()
            torch.cuda.synchronize()
            if rc:
                line.append(f"{label} launch error {rc}")
                continue
            same = ""
            if label not in ref:
                ref[label] = out.clone()
            elif name in EXACT:
                same = f", equal {torch.equal(out, ref[label])}"
            ms = cs.queued_device_ms(torch, run, calls=QUEUED)
            line.append(f"{label} {cs.fmt_ms(ms)} ms ({p.warps.numel() // 2}"
                        f" warps{same})")
        print(f"{name} [{card}]: " + "  ".join(line), flush=True)


if __name__ == "__main__":
    main()

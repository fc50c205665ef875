#!/usr/bin/env python3
"""What K14's time is made of, on one card: variants of
``nsparse_tpu_torch/csrc/spmv_ell.cu`` (and of the slab table the host
builds for it) timed on the ``g500-s21.spmv`` cell's ELL (the
benchmark's generator on the card, the cell's geometry), in float32.

    python3 tools/k14_variants.py        # from the repository root

Each variant is the source with a few lines replaced (``VARIANTS``) and,
where it says so, the table built with the narrowest slabs first; it
is built with the kernels' nvcc flags into ``_build/`` and its first
launch (the slabs) called through its C entry point, in turns, the
source as it is first and last.  Each is timed by CUDA events around 20
launches queued behind a device sleep (the device's time alone) and
checked against the source as built with ``torch.equal``: no variant
changes the order of adds.
"""

import ctypes
import dataclasses
import os
import sys
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

SLABS = "__launch_bounds__(kThreads)\nell_slabs_kernel"
UNROLL4 = ("constexpr int kUnroll = 8;", "constexpr int kUnroll = 4;")


def blocks_an_sm(n: int) -> tuple:
    """The edit that asks for ``n`` resident blocks an SM (fewer
    registers a thread)."""
    return (SLABS, f"__launch_bounds__(kThreads, {n})\nell_slabs_kernel")


# name: (source edits, narrowest slabs first)
VARIANTS = {
    "as built": ([], False),
    "unroll 4": ([UNROLL4], False),
    "unroll 16": ([("constexpr int kUnroll = 8;",
                    "constexpr int kUnroll = 16;")], False),
    # the slabs through L1 and L2 as x is
    "no streaming loads": ([("pv[u] = __ldcs(v", "pv[u] = __ldg(v"),
                            ("pc[u] = __ldcs(c", "pc[u] = __ldg(c")],
                           False),
    # more resident blocks, fewer registers a thread (spills)
    "six blocks an SM": ([blocks_an_sm(6)], False),
    "narrowest first": ([], True),
}
ORDER = ("as built", *[n for n in VARIANTS if n != "as built"], "as built")
QUEUED = 20


def build(name: str, text: str):
    """The variant's float32 slabs entry point, built from ``text``."""
    from nsparse_tpu_torch.buildlib import BUILD_DIR, build_shared
    from nsparse_tpu_torch.ops.kernels.cuda_lib import (
        _SIGNATURES, CSRC_DIR, NVCC_FLAGS, nvcc)

    for old, new in VARIANTS[name][0]:
        if old not in text:
            sys.exit(f"k14_variants: {name}: {old!r} is not in the source")
        text = text.replace(old, new)
    tag = name.replace(" ", "_").replace(",", "")
    src_dir = os.path.join(BUILD_DIR, "k14_variants")
    os.makedirs(src_dir, exist_ok=True)
    src = os.path.join(src_dir, f"spmv_ell_{tag}.cu")
    with open(src, "w") as f:
        f.write(text)
    lib = build_shared(f"libk14_{tag}", [src],
                       [nvcc(), *NVCC_FLAGS, "-I", CSRC_DIR], timeout=900)
    fn = lib.nsp_spmv_ell_slabs_f32
    fn.argtypes = _SIGNATURES["nsp_spmv_ell_slabs"]
    fn.restype = ctypes.c_int
    return fn


def table(ell, narrow_first):
    """The slab table of ``ell`` as built, or its slabs narrowest first
    where asked."""
    from nsparse_tpu_torch.ops.kernels import spmv_ell as k14

    t = k14.slab_table(ell)
    if not narrow_first:
        return t
    n = k14.FIELDS
    f = [list(t.table[n * i: n * i + n]) for i in range(t.n_slabs)][::-1]
    block = 0
    for row in f:
        row[6] = block
        block += -(-row[3] // k14.BLOCK_THREADS)
    flat = [v for row in f for v in row]
    return dataclasses.replace(t, table=(ctypes.c_int64 * len(flat))(*flat))


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        sys.exit("k14_variants: torch.cuda.is_available() is false")
    import chip_smoke as cs
    import nsparse_tpu_torch as nt

    card = cs.card_line()
    print(card, flush=True)
    with open(os.path.join(ROOT, "nsparse_tpu_torch", "csrc",
                           "spmv_ell.cu")) as f:
        text = f.read()
    names = list(VARIANTS)
    with ThreadPoolExecutor(len(names)) as pool:
        libs = dict(zip(names, pool.map(lambda n: build(n, text), names)))

    s = cs.Smoke(torch, card)
    tr = cs.cell_traffic(cs.CELL_TRAFFIC)
    a = cs.cell_graph(s, cs.CELL_CONFIG, cs.CELL_SEED)
    geom = {k: v for k, v in tr["ell"].items() if k != "xshuffle"}
    ell = nt.ELL.from_csr(a, xshuffle=False, **geom).to(s.dev)
    x = torch.randn(a.shape[1], device=s.dev)
    nbytes = a.nnz * 8 + (a.shape[0] + 1) * 4 + sum(a.shape) * 4
    bound = nbytes / s.bw * 1e3
    print(f"K14 variants on {cs.CELL_CONFIG}: nnz {a.nnz}, "
          f"{ell.padded_nnz} slots, widths {ell.widths}; CSR bound of the "
          f"whole call {bound:.4f} ms", flush=True)
    stream = torch.cuda.current_stream().cuda_stream

    ref = None
    for name in ORDER:
        t = table(ell, VARIANTS[name][1])
        out = torch.empty(t.n_slots, device=s.dev)
        args = (x.data_ptr(), out.data_ptr(), t.table, t.n_slabs, t.n_blocks)

        def run(f=libs[name], c=args):
            return f(*c, stream)

        rc = run()
        torch.cuda.synchronize()
        if rc:
            print(f"{name}: launch error {rc}", flush=True)
            continue
        y = out[ell.pos.long()]
        if ref is None:
            ref = y.clone()
        same = f", equal {torch.equal(y, ref)}"
        ev = s.time_cuda(run, trials=cs.TRIALS)
        ms = cs.queued_device_ms(torch, run, calls=QUEUED)
        print(f"{name} [{card}]: slabs launch {cs.fmt_ms(ms)} ms queued, "
              f"{ev:.4f} ms by events ({t.n_blocks} blocks{same})",
              flush=True)


if __name__ == "__main__":
    main()

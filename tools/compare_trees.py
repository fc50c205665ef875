#!/usr/bin/env python3
"""Compare two trees of the port on one card, kernel by kernel.

    python3 tools/compare_trees.py DIR [KERNEL ...]

DIR is the root of a checkout of the repository (an unpacked ``git
archive`` of another commit, or ``.``).  The script imports DIR's
``nsparse_tpu_torch`` and DIR's own ``chip_smoke.py``, runs that script's
path phases that the KERNELs run on, which print their path times and
record each kernel's calls:
  SpGEMM window and the other ESC layouts   K3 fused_class and
      fused_class_v2, K2 expand_pieces and expand_pieces_flat, K4 runcopy;
  SpMV                                      K7 spmv_dia, K8 spmv_bsr;
  SpGEMM, SpMV and block SpGEMM (every path)  any other kernel but K10;
and then, from this tree's ``chip_smoke.py``, on the calls DIR's paths
made: the phase of each KERNEL that has one (K9 spgemm_bsr_blocks:
``k9_phase``, without its tensor-core check; K1 gather: ``k1_phase``; K11
build_bank and K5 gather_subset: ``bank_subset_phase``; K3 and K2's piece
modes: ``k3_k2_phase``; K10 windowed_gather: ``windowed_gather_phase``,
which runs DIR's K10 alone and needs no path), the launch-cost phase
(when a KERNEL runs on the SpMV or block paths, or is K4), and the kernel
table's rows of KERNEL (default: fused_class fused_class_v2 expand_pieces
expand_pieces_flat), every bound by this tree's rule (for K3, the rule of
the tables the tree's plans hold).
Run it once per tree in one call of the card, in turns (parent, change,
change, parent), to compare them.
"""

import functools
import importlib.util
import json
import os
import sys
import time
import types


def load(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main() -> None:
    if len(sys.argv) < 2:
        sys.exit(__doc__)
    root = os.path.abspath(sys.argv[1])
    kernels = sys.argv[2:] or ["fused_class", "fused_class_v2",
                               "expand_pieces", "expand_pieces_flat"]
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, root)  # DIR's nsparse_tpu_torch
    import torch

    if not torch.cuda.is_available():
        sys.exit("compare_trees: torch.cuda.is_available() is false")
    tree = load(os.path.join(root, "chip_smoke.py"), "tree_smoke")
    this = load(os.path.join(here, "chip_smoke.py"), "this_smoke")
    t_start = time.perf_counter()
    card = tree.card_line()
    print(f"tree {root}: {card}", flush=True)
    s = tree.Smoke(torch, card)
    # this tree's bounds on the other tree's calls (K9's f32 bound is the
    # 3xTF32 one), so that both trees' rows are read against the same, and
    # its library calls (K10's clamps indices outside the window, which
    # torch.gather would assert on)
    s.bound_ms = types.MethodType(this.Smoke.bound_ms, s)
    s.library_call = types.MethodType(this.Smoke.library_call, s)
    s.cuda_lib.KERNELS.get()
    # the paths each kernel runs on (K10 runs alone, in its own phase)
    window = {"fused_class", "fused_class_v2", "expand_pieces",
              "expand_pieces_flat"}
    spgemm_only, spmv_only = window | {"runcopy"}, {"spmv_dia", "spmv_bsr"}
    on_paths = set(kernels) - {"windowed_gather"}
    phases = []
    if on_paths - spmv_only:
        phases += [tree.spgemm_phase, tree.esc_layout_phases]
    if on_paths - spgemm_only:
        phases.append(tree.spmv_phases)
    if on_paths - spgemm_only - spmv_only:
        phases.append(tree.bsr_spgemm_phases)
    if "spgemm_bsr_blocks" in kernels:
        # the other tree's K9 may predate the tensor cores
        phases.append(functools.partial(this.k9_phase, sass=False))
    if "gather" in kernels:
        phases.append(this.k1_phase)
    if {"build_bank", "gather_subset"} & set(kernels):
        phases.append(this.bank_subset_phase)
    if window & set(kernels):
        phases.append(this.k3_k2_phase)
    if "windowed_gather" in kernels:
        phases.append(this.windowed_gather_phase)
    if on_paths - window:
        phases.append(this.launch_cost_phase)
    for phase in phases:
        t0 = time.perf_counter()
        phase(s)
        name = getattr(phase, "__name__", None) or phase.func.__name__
        print(f"phase {name}: {time.perf_counter() - t0:.1f} s host time",
              flush=True)
    table = this.Smoke.kernel_table(s, kernels)
    print(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"tree": root, "kernels": table}))


if __name__ == "__main__":
    main()

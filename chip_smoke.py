#!/usr/bin/env python3
"""Drive the PyTorch port's SpGEMM, SpMV, block SpGEMM and distributed paths
once on one CUDA card.

    python3 chip_smoke.py          # from the repository root, one card

Phases (any failure exits non-zero before the final line):
  1. the card's name and power limit (nvidia-smi) and the toolchain;
  2. build the Hopper kernels (K1-K14, K2 in its run, piece and flat
     modes, K3 v1 and v2, K4 fixed and K-fold, the hash path) from the
     sources of ``nsparse_tpu_torch/csrc``;
  3. SpGEMM: C = A @ A on R-MAT-14 (edge factor 8, seed 1, float32) —
     ``choose_spgemm_path`` must answer esc; ``spgemm_plan`` on the host
     must build the v2 form (the 1,344-row bank fits the budget), then
     ``spgemm_numeric`` on cuda:0 (K11 bank, K1 A values, K3 v2 per
     class into its slice of one merge buffer, the fallback pool through
     one K2 piece-mode launch and K12, K1, K4; no run-form K2, no v1 K3);
     C is checked against the scipy oracle with
     the |A||B| bound, then re-run with new values on the same plan, in
     float32 and in float64; then the same matrix in the v1 form
     (``FUSED_BANK_BUDGET = 0``: K2, K3 v1, K1, K4), whose C must equal
     v2's (``torch.equal``) and scipy's; both numeric phases timed with the
     kernels, with the plain versions and as one cuSPARSE CSR SpGEMM, the
     v2 phase split into its four stages (delivery, classes, fallback,
     merge), and both under torch.profiler;
  3b. the other ESC layouts, each C checked against scipy and re-run with
     new values in float32 and float64 on its plan, launch counts exact:
       spgemm-global            R-MAT-14, ``layout="global"``: K11 bank,
                                K1 x3, K2 piece mode once over every
                                class, K12; C equal in structure to the
                                window C;
       spgemm-global-unaligned  R-MAT-16 (edge factor 4, seed 1), whose
                                3,136-row bank exceeds BANK_ROWS_MAX: K11
                                flat table, K1 x3, K2 flat mode once, K12;
       spgemm-sort              R-MAT-14, ``shuffle=False``: the K5/K1/K6
                                launches of its two gather plans (K5 once
                                per plan), two runs equal;
       spgemm-oneshot           ``nt.spgemm(a, a)`` without a plan, the
                                hash path (``hash_phase``), on R-MAT-14
                                and a Graph500 scale-15 graph, f32 and
                                f64: ``rpt`` and ``col`` equal to
                                ``planner="device"``'s, values within 1e-5
                                / 1e-8 of |A||B|, a launch per route with
                                rows, two host reads, rows per route and
                                peak memory, timed beside the ESC path,
                                cuSPARSE and its bound; then empty rows, a
                                row covering all N columns, every row in
                                the tail route (dense in three passes;
                                device-memory tables), exact cancellation
                                kept in C, M * N = 2^32, and HPCG's
                                Galerkin product at 64^3 in f64 (``rap``
                                and its two products: rectangular, the
                                first's C the second's B; routes pwarp
                                and warp, then pwarp; four host reads);
  3c. the plan cache: the five host plans above (window v2 and v1,
     global and sort on R-MAT-14, global unaligned on R-MAT-16) saved
     (file MB, host s) and loaded (host s, index tables checked), run on
     cuda:0 with C equal to the unsaved plan's (``torch.equal``) and the
     launch counts of its path; ``spgemm_plan_cached`` twice on
     ``data/circuit_zipf.mtx`` (f32): a miss, then a hit, both Cs checked
     on the card (``check_spgemm_answer_device``), K5/K1/K6 counted;
  3d. the CLI in subprocesses: ``spgemm --plan-cache`` twice on
     circuit_zipf (only the second a ``[cache hit]``, both pass), ``spmv
     --profile`` on the stencil as DIA (a Chrome trace holding a CUDA
     kernel event), ``spmv-xla`` and ``spgemm-xla`` (cuSPARSE through
     ``torch.sparse_csr_tensor``); ``time_chained`` and ``time_marginal``
     of the stencil DIA SpMV beside ``time_cuda``;
  3e. K4's K-fold mode alone on 2^24 output values, equal to its plain
     version bit for bit;
  4. SpMV, float32 unless marked, each path checked against scipy (rtol
     1e-5, or 1e-8 in float64, scaled by |A||x|); every ``plus_times``
     ELL SpMV on the card is K14 (two launches, no K5, K1 or K6):
       irregular  R-MAT-20 (edge factor 16, seed 2), ELL (min_width 2,
                  max_slabs 10, sigma 1024) with and without x-shuffle;
       banded     5-point stencil 2048 x 2048: DIA, and ELL with sigma 0;
       FEM        16-dof blocks on 4096 nodes: BSR (128, 128); then, with
                  TF32 allowed, ``spmm`` and the plain BSR SpMV against
                  K8 (they must stay full float32);
       f64        DIA and x-shuffle ELL again in float64;
       tuner      ``autotune_spmv`` in model mode on the stencil;
       HPCG       the ``hpcg-256.spmv-dia`` cell's shape: HPCG's 27
                  diagonals on a 256^3 grid in float64, built on the
                  card, one K7 launch held to its plain version within
                  32 eps of |A||x| (27 terms summed in two orders), timed
                  beside its bound;
       Graph500   the ``g500-s21.spmv`` cell's shape (``ell_cell_case``):
                  scale 21 from the benchmark's generator on the card,
                  the cell's ELL geometry, f32; K14's two launches by
                  entry point, y equal to K14's plain version and on a
                  second call bit for bit, within the cell's ``y_gap``
                  limit of the float64 CSR product, timed beside its
                  bound (the L2 and L1 hit rates where Nsight Compute
                  runs);
     the x-shuffle ELL SpMV under torch.profiler;
  5. block SpGEMM, C = A @ A through dense 256 x 256 tiles (K9):
       FEM f32    the FEM matrix above: ``choose_spgemm_path`` must answer
                  bsr; ``plan_spgemm_bsr`` on the host, ``spgemm_bsr`` on
                  cuda:0, then new values through ``spgemm_bsr_numeric``
                  (re-blockified on the card by K5, K1 and K6); each C
                  checked against scipy; under torch.profiler; the plain
                  tile products, with TF32 allowed, held to the float64
                  products (K9's error beside them);
       FEM f64    the bench's 512-node FEM matrix in float64;
     each timed with the kernels, the plain versions and cuSPARSE CSR;
  6. windowed gather (K10) on 262,144 rows for windows 32, 128 and 1024 in
     float32, 1024 in float64, 100 (not a divisor of 128) with a quarter
     of its indices outside the window, 512 in float32, 128 and 384 in
     float64, and 128 with misaligned indices in rows of 130 values in
     both dtypes (every route and branch of the kernel): equal to its
     plain version bit for bit and to ``torch.gather`` on the in-window
     slots (0 on the others), its route (direct or a thread per output)
     and its 32- and 64-byte sector floors printed beside its bound (no
     path of the library calls it: it stands alone, as on the TPU);
  7. the tile copies: K6's scalar and vector branches against its plain
     version (``torch.equal``, f32 and f64); K6 on the FEM value re-run
     and K12 on R-MAT-14, by CUDA events, by the profiler's device time
     and queued behind a device sleep, beside their bounds, and K6's
     scalar branch on the same values;
  7b. the bank and the subset gather: K11's and K5's vector and scalar
     branches against their plain versions (``torch.equal``, f32 and
     f64; a 16-copy bank whose tails wrap, one copy, a misaligned
     ``b8_idx``; an ``other`` shorter than the slots, a misaligned
     ``out``); K11 on the v2 path's call, K5 on the FEM value re-run,
     the same three ways, beside their bounds and ``b_val[idx]`` /
     ``src[idx]``;
  7c. K9 on tensor cores: the HMMA and DMMA counts of its built library
     (``cuobjdump --dump-sass``; fails if either is 0); synthetic tiles
     at bs 64, 128, 192 and 256 (both sub-tile branches), f32 and f64,
     held to the plain version at rtol 1e-5 / 1e-8 of |A_tile||B_tile|;
     K9's and the plain version's largest errors against the float64
     products; K9 on each block path's call by events, profiler and
     queued time beside its bound, and one ``torch.bmm`` of the
     pre-gathered pairs (the cuBLAS rate on these tiles);
  7d. K1: its vector branch (a length not a multiple of 4, the tail
     alone) and scalar branch (misaligned ``idx`` and ``out`` views) equal
     to ``gather_plain`` (``torch.equal``, f32 and f64, indices negative
     and past the end among them);
  7e. K3 and K2's piece modes: K3 per class of both window forms (width,
     windows, blocks per window, threads, shared memory, blocks per SM
     and global scratch, in f32 and f64), equal to its plain version in
     f64 (``torch.equal``), by CUDA events, the profiler's device time and
     queued behind a device sleep, beside its bound and the bound of the
     earlier design's tables, and each form summed; K2's one piece-mode
     launch on the v2 and global paths and its one flat-mode launch on
     R-MAT-16 the same way;
  8. launch cost: host µs per call of each step of the ctypes launch
     path (``cuda_lib.launch``) alone, of K12, K6, K11, K5, K1, K4, K7 and
     K8 through it and of the PyTorch calls that compute the same
     functions, at 1 tile (1 unit; K7 and K8 on a 32 x 32 stencil) and at
     the main path's own calls: the median of LAUNCH_ROUNDS rounds of
     LAUNCH_REPS back-to-back calls, every step in each round;
  9. the distributed layer (``nsparse_tpu_torch.parallel``) on a
     virtual mesh of DIST_SHARDS shards on cuda:0, f32 with value re-runs
     in f64, each y and C checked against scipy (rtol 1e-5 / 1e-8 of
     |A||x|, |A||B| or |R||A||P|, structure exact):
       dist-spmv-rmat20   ``spmv_dist`` on the R-MAT-20 above, x
                          replicated (plain local SpMVs: no port kernel);
       dist-spmv-halo     ``spmv_halo`` on the DIST_STENCIL² stencil, x
                          sharded, halos copied between shards;
       spgemm-dist        ``spgemm_dist`` on R-MAT-14, a sort-layout plan
                          per shard: K5/K1/K6 launches equal to the sum
                          over the shards' gather plans; new values;
       spgemm-dist-window ``spgemm_plan_dist_window`` and
                          ``spgemm_numeric_dist_window``, v2 per shard:
                          K11, K1, K3 v2, K2 piece mode, K12, K4 equal to
                          the shards' summed single-card counts; both
                          Cs equal in structure to the single-card C and
                          within 1e-5 of |A||B| of it;
       spgemm-halo,       ``spgemm_halo`` (A·P) and the R·(A·P) chain on
       rap-halo           the stencil with P the 4:1 aggregation, launch
                          counts by the shard plans' layouts; ``rap_halo``
                          equal to the planned chain;
       rap-dist-*         ``rap_dist`` esc on the same operands and window
                          (on R-MAT-14 when the v2 rule refuses the
                          stencil), ``gather_partitioned`` called once
                          (the final gather, none inside
                          ``rap_dist_parts``), the planned chain counted;
     each timed beside the single-card call of the same product, with its
     device-busy share; then the CLI's ``rap --devices 4 --n 65536``;
  10. each kernel against its plain PyTorch version on the card, on the
     inputs its paths gave it, timed with CUDA events beside the plain
     version, one PyTorch call that computes the same function (where
     there is one) and the least time the card could take (its bound).
Every path sets the launch counts to 0 just before it runs and reads them
just after, and fails if a kernel of that path never launched; K5 must
launch exactly once per ``flat_gather`` whose plan has class units.  The
second-to-last line is the kernel table as JSON; the last line is
``{"ok": true, "device": {...}}``.
"""

import contextlib
import ctypes
import dataclasses
import glob
import itertools
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

SCALE, EDGE_FACTOR, SEED = 14, 8, 1
# structural counts of the headline product (device independent): P,
# nnz(C), the v2 bank's rows and the fallback pool's products
N_PRODUCTS, NNZ_C = 17_075_504, 8_935_048
BANK_ROWS, FB_PRODUCTS = 1344, 1_029_640
# the global slab layout's unaligned (flat) piece mode: R-MAT-16, edge
# factor 4, seed 1, whose 8-aligned B table needs more bank rows than
# BANK_ROWS_MAX (structural counts: nnz(A), P, 8-aligned slots, bank rows)
UNALIGNED = dict(scale=16, edge_factor=4, seed=1)
UNALIGNED_COUNTS = (253_066, 35_482_345, 394_296, 3136)
# K4's K-fold phase: at least 2^24 output values in runs of 1-4,096
# values, a quarter of them at each fold factor K in (1, 2, 4, 8)
KFOLD_OUT, KFOLD_RUN_MAX = 1 << 24, 4096
TRIALS = 20
# the hash SpGEMM phase: a Graph500 graph at the one-shot cell's scale,
# and the width of its full-row case
HASH_G500 = dict(scale=15, edge_factor=16, seed=1)
HASH_WIDE = 40_000  # the dense route in two passes (f32), three (f64)
GALERKIN_GRID = 64  # HPCG's Galerkin product, on a 64^3 grid
HPCG_DIA_GRID = 256  # K7 at the hpcg-256.spmv-dia cell's grid
RMAT_SCALE, RMAT_EF, RMAT_SEED = 20, 16, 2
STENCIL = 2048
FEM = dict(n_nodes=4096, dof=16, neighbors=6, bandwidth=24, seed=3)
FEM_F64 = dict(FEM, n_nodes=512)  # the bench's FEM stage (bench.py:501)
# structural counts of the block products at bs 256 (device independent):
# (A tiles, pairs, C tiles, intermediate products P, nnz(C))
FEM_BSR = (1274, 6350, 2284, 2_395_136_000, 66_215_936)
FEM_F64_BSR = (None, 750, 268, None, 8_004_096)
# K10's phase, WG_ROWS rows a case: (window, dtype, a quarter of the
# indices outside the window, misaligned: idx 4 bytes off 16-byte
# alignment in rows of window + 2 values).  The cases take every route
# and branch of csrc/windowed_gather.cu: the direct route below a 4 KB
# span (f32 32-512, f64 128 and 384) with 16-byte index vectors, and
# with one index at a time (misaligned), and a thread per output from
# 4 KB (1024).
WG_ROWS = 262_144
WG_CASES = ((32, np.float32, False, False), (128, np.float32, False, False),
            (1024, np.float32, False, False),
            (1024, np.float64, False, False), (100, np.float32, True, False),
            (512, np.float32, False, False), (128, np.float64, False, False),
            (384, np.float64, False, False), (128, np.float32, True, True),
            (128, np.float64, True, True))
LAUNCH_REPS = 1000  # back-to-back calls per step of the launch-cost phase
LAUNCH_ROUNDS = 5   # rounds of the launch-cost phase, every step in each
CHECK_TILES = 16_384  # K6's vector-branch check: tiles of 1024 moved
SLEEP_CYCLES = 50_000_000  # a device sleep of about 25 ms at 2 GHz
# peak rates outside the tensor cores (NVIDIA H100 SXM data sheet), for
# the operation bound of the two SpMV kernels
PEAK_FLOPS = {4: 67e12, 8: 34e12}
# peak rates for dense tile products at full precision (the same data
# sheet), for the operation bound of K9.  Float32: the TPU kernel runs at
# Precision.HIGHEST, and one TF32 pass keeps about three digits, so K9
# splits each operand in two and takes three TF32 products per float32
# product (3xTF32), the least work that keeps float32 accuracy on the
# tensor cores: a third of the 495 TFLOP/s TF32 peak.  Float64: DMMA.
TILE_PEAK_FLOPS = {4: 495e12 / 3, 8: 67e12}
# the FFMA bound K9's float32 rows were measured against before (67
# TFLOP/s outside the tensor cores), printed beside the restated one
FFMA_PEAK = 67e12
# K9's synthetic checks, (bs, A and B tiles, C tiles): bs 64 and 192 take
# the 64 x 64 sub-tile branch, 128 and 256 the 128 x 128 one
K9_SYNTH = ((64, 5, 7), (128, 4, 6), (192, 4, 5), (256, 3, 4))
# K1's branch checks: outputs (one not a multiple of 4) and source length
K1_CHECK = (1_000_003, 300_000)
# K14 at the g500-s21.spmv cell's shape: its configuration and traffic
# (bench_torch/configs, bench_torch/traffic) and a seed for the labels
CELL_CONFIG, CELL_TRAFFIC, CELL_SEED = "g500-s21", "spmv", 2147483659
# the launches of a plus_times ELL SpMV on the card: K14's two, no gather
ELL_KERNELS = ["spmv_ell"]
ELL_LAUNCHES = {"spmv_ell": 2, "gather_subset": 0, "gather": 0,
                "scatter_tiles": 0}

# name: (route, source, the TPU kernel it replaces)
KERNELS = {
    "gather": ("cuda", "nsparse_tpu_torch/csrc/gather.cu",
               "nsparse_tpu/ops/kernels/shuffle_pallas.py:399"),
    "expand": ("cuda", "nsparse_tpu_torch/csrc/expand.cu",
               "nsparse_tpu/ops/kernels/piecewise.py:492"),
    "fused_class": ("cuda", "nsparse_tpu_torch/csrc/fused_class.cu",
                    "nsparse_tpu/ops/kernels/window_fused.py:463"),
    "runcopy": ("cuda", "nsparse_tpu_torch/csrc/runcopy.cu",
                "nsparse_tpu/ops/kernels/runcopy.py:1035"),
    "gather_subset": ("cuda", "nsparse_tpu_torch/csrc/gather_subset.cu",
                      "nsparse_tpu/ops/kernels/gather_pallas.py:233"),
    "scatter_tiles": ("cuda", "nsparse_tpu_torch/csrc/scatter_tiles.cu",
                      "nsparse_tpu/ops/kernels/gather_pallas.py:356"),
    "spmv_dia": ("cuda", "nsparse_tpu_torch/csrc/spmv_dia.cu",
                 "nsparse_tpu/ops/kernels/dia_pallas.py:60"),
    "spmv_bsr": ("cuda", "nsparse_tpu_torch/csrc/spmv_bsr.cu",
                 "nsparse_tpu/ops/kernels/spmv_pallas.py:70"),
    "spgemm_bsr_blocks": ("cuda", "nsparse_tpu_torch/csrc/spgemm_bsr.cu",
                          "nsparse_tpu/ops/spgemm_bsr.py:311"),
    "windowed_gather": ("cuda", "nsparse_tpu_torch/csrc/windowed_gather.cu",
                        "nsparse_tpu/ops/kernels/gather_pallas.py:452"),
    "build_bank": ("cuda", "nsparse_tpu_torch/csrc/build_bank.cu",
                   "nsparse_tpu/ops/kernels/piecewise.py:440"),
    "gather_tiles8": ("cuda", "nsparse_tpu_torch/csrc/gather_tiles8.cu",
                      "nsparse_tpu/ops/kernels/gather_pallas.py:309"),
    "expand_pieces": ("cuda", "nsparse_tpu_torch/csrc/expand.cu",
                      "nsparse_tpu/ops/kernels/piecewise.py:492"),
    "fused_class_v2": ("cuda", "nsparse_tpu_torch/csrc/fused_class.cu",
                       "nsparse_tpu/ops/kernels/window_fused.py:463"),
    "expand_pieces_flat": ("cuda", "nsparse_tpu_torch/csrc/expand.cu",
                           "nsparse_tpu/ops/kernels/piecewise.py:492"),
    "runcopy_kfold": ("cuda", "nsparse_tpu_torch/csrc/runcopy.cu",
                      "nsparse_tpu/ops/kernels/runcopy.py:1035"),
    # no TPU kernel: slab_class_reduce's XLA adds around planned_shuffle
    "fallback_sum": ("cuda", "nsparse_tpu_torch/csrc/fallback_sum.cu",
                     "nsparse_tpu/ops/spgemm.py:792"),
    # no TPU kernel: the ELL SpMV's planned gathers and XLA's multiply and
    # sums
    "spmv_ell": ("cuda", "nsparse_tpu_torch/csrc/spmv_ell.cu",
                 "nsparse_tpu/ops/spmv.py:92"),
}
# how each kernel is held against its plain version
TOLERANCE = {
    "spmv_dia": "rtol 1e-6 (f32) / 1e-12 (f64) of |A||x|",
    "spmv_bsr": "rtol 1e-6 (f32) / 1e-12 (f64) of |A||x|",
    "spgemm_bsr_blocks": "rtol 1e-5 (f32) / 1e-8 (f64) of |A_tile||B_tile|",
}
SPGEMM_FIELDS = {"gather": "gather", "expand": "expand",
                 "fused": "fused_class", "runcopy": "runcopy",
                 "bank": "build_bank", "fused_v2": "fused_class_v2",
                 "pieces": "expand_pieces", "tiles8": "gather_tiles8",
                 "pieces_flat": "expand_pieces_flat",
                 "scatter": "scatter_tiles", "fallback": "fallback_sum"}
# the kernels each form of the window numeric phase must launch on
# R-MAT-14 (its fallback pool is not empty); spgemm_phase checks their
# exact counts against the plan
SPGEMM_V2 = ["build_bank", "gather", "fused_class_v2", "expand_pieces",
             "gather_tiles8", "fallback_sum", "runcopy"]
SPGEMM_V1 = ["expand", "fused_class", "fallback_sum", "runcopy"]


def host_timed(what, fn):
    """``fn()``, printing its host time."""
    t0 = time.perf_counter()
    out = fn()
    print(f"host: {what} {time.perf_counter() - t0:.1f} s", flush=True)
    return out


def fmt_ms(v) -> str:
    return "null" if v is None else f"{v:.4f}"


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


def profile_calls(torch, fn, what: str, calls: int = 10) -> None:
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
        print(f"profile {what}: torch.profiler recorded no device events "
              "(device breakdown not measured)")
        return
    busy_ms = sum(us for us, _ in by_name.values()) / calls / 1e3
    n_ops = sum(n for _, n in by_name.values()) / calls
    print(f"profile ({calls} {what} calls, profiler on): device busy "
          f"{busy_ms:.4f} ms per call of {wall_ms:.4f} ms wall "
          f"({100 * busy_ms / wall_ms:.1f}%), {n_ops:g} device ops per call")
    if any(n % calls for _, n in by_name.values()):
        print("  (a count per call that is not whole: the profiler dropped "
              "device events, so busy time and shares cover only those it "
              "kept)")
    for name, (us, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0]):
        print(f"  {100 * us / calls / 1e3 / busy_ms:5.1f}%  "
              f"{us / calls / 1e3:.4f} ms  {n / calls:g}/call  {name}")


class Smoke:
    """The run's state: the card, the kernel modules, the calls each
    kernel received on the main paths and their launch counts."""

    def __init__(self, torch, card: str):
        import nsparse_tpu_torch as nt
        from nsparse_tpu_torch.ops.kernels import (
            bsr_blocks, cuda_lib, dia, fallback, flat_gather, gather_tiles,
            piecewise, runcopy, shuffle, spmv_bsr, spmv_ell, window_fused)
        from nsparse_tpu_torch.utils.roofline import chip_specs
        from nsparse_tpu_torch.utils.timing import time_cuda

        self.torch, self.nt, self.card = torch, nt, card
        self.cuda_lib, self.time_cuda = cuda_lib, time_cuda
        self.dev = torch.device("cuda:0")
        self.name = torch.cuda.get_device_name(0)
        self.bw = chip_specs(self.name).hbm_gbps * 1e9
        self.wrappers = {
            "gather": shuffle.gather, "expand": piecewise.piecewise_expand,
            "fused_class": window_fused.fused_class_apply,
            "runcopy": runcopy.runcopy,
            "gather_subset": gather_tiles.gather_subset,
            "scatter_tiles": gather_tiles.scatter_tiles,
            "spmv_dia": dia.spmv_dia, "spmv_bsr": spmv_bsr.spmv_bsr,
            "spgemm_bsr_blocks": bsr_blocks.spgemm_bsr_blocks,
            "windowed_gather": gather_tiles.windowed_gather,
            "build_bank": piecewise.build_bank,
            "gather_tiles8": gather_tiles.gather_tiles8,
            "expand_pieces": piecewise.expand_pieces,
            "fused_class_v2": window_fused.fused_class_expand,
            "expand_pieces_flat": piecewise.expand_pieces_flat,
            "runcopy_kfold": runcopy.runcopy_kfold,
            "fallback_sum": fallback.fallback_sum,
            "spmv_ell": spmv_ell.spmv_ell,
        }
        self.plain = {
            "gather": shuffle.gather_plain,
            "expand": piecewise.expand_plain,
            "fused_class": window_fused.fused_class_plain,
            "runcopy": runcopy.runcopy_plain,
            "gather_subset": gather_tiles.gather_subset_plain,
            "scatter_tiles": gather_tiles.scatter_tiles_plain,
            "spmv_dia": (lambda vals, offs, x, m, off_t=None:
                         dia.spmv_dia_plain(vals, offs, x, m)),
            "spmv_bsr": spmv_bsr.spmv_bsr_plain,
            "spgemm_bsr_blocks": bsr_blocks.spgemm_bsr_blocks_plain,
            "windowed_gather": gather_tiles.windowed_gather_plain,
            "build_bank": piecewise.build_bank_plain,
            "gather_tiles8": gather_tiles.gather_tiles8_plain,
            "expand_pieces": piecewise.expand_pieces_plain,
            "fused_class_v2": window_fused.fused_class_expand_plain,
            "expand_pieces_flat": piecewise.expand_pieces_flat_plain,
            "runcopy_kfold": runcopy.runcopy_kfold_plain,
            "fallback_sum": fallback.fallback_sum_plain,
            "spmv_ell": spmv_ell.spmv_ell_plain,
        }
        self.piecewise, self.window_fused = piecewise, window_fused
        # where the SpMV and block SpGEMM paths look each wrapper up
        # (module, attribute)
        self.sites = {
            "gather_subset": [(flat_gather, "gather_subset")],
            "scatter_tiles": [(flat_gather, "scatter_tiles")],
            "gather": [(flat_gather, "gather"), (shuffle, "gather")],
            "spmv_dia": [(dia, "spmv_dia")],
            "spmv_bsr": [(spmv_bsr, "spmv_bsr")],
            "spgemm_bsr_blocks": [(bsr_blocks, "spgemm_bsr_blocks")],
            "windowed_gather": [(gather_tiles, "windowed_gather")],
            "spmv_ell": [(spmv_ell, "spmv_ell")],
        }
        self.calls = {k: [] for k in KERNELS}     # [(path, args)]
        self.launches = {k: 0 for k in KERNELS}
        self.path_launches = {}                   # path: {kernel: count}
        # the hash SpGEMM's timings, for the closing table
        self.hash_rows = []
        # the host plans of the SpGEMM paths, for the plan cache phase:
        # name: (A, plan, the path whose launch counts it must repeat)
        self.host_plans = {}

    # -- launch counts ------------------------------------------------------

    def counted(self, fn, expect, path: str, exact=None):
        """Run ``fn`` with every launch count at 0 and fail unless each
        kernel in ``expect`` launched, and each kernel in ``exact`` (a
        dict) launched exactly that often; returns fn's result."""
        for w in self.wrappers.values():
            w.launches = 0
        out = fn()
        self.torch.cuda.synchronize()
        got = {k: w.launches for k, w in self.wrappers.items() if w.launches}
        print(f"{path}: launches {got}", flush=True)
        missing = [k for k in expect if not got.get(k)]
        if missing:
            fail(f"{path}: kernel(s) {missing} never launched: {got}")
        wrong = {k: n for k, n in (exact or {}).items() if got.get(k, 0) != n}
        if wrong:
            fail(f"{path}: launches {got}, expected {wrong}")
        for k, n in got.items():
            self.launches[k] += n
        self.path_launches[path] = got
        return out

    # -- recording and swapping wrappers ------------------------------------

    @contextlib.contextmanager
    def patched(self, make):
        """Replace each wrapper where its path looks it up by
        ``make(kernel name, wrapper)``."""
        saved = []
        for k, sites in self.sites.items():
            for mod, attr in sites:
                saved.append((mod, attr, getattr(mod, attr)))
                setattr(mod, attr, make(k, self.wrappers[k]))
        try:
            yield
        finally:
            for mod, attr, fn in saved:
                setattr(mod, attr, fn)

    def record(self, fn, path: str):
        """Run ``fn`` once, keeping every patched kernel call's inputs (the
        in-place outputs as they were before the call)."""
        clone_arg = {"gather_subset": 4, "scatter_tiles": 0}

        def make(k, w):
            def call(*args):
                kept = list(args)
                if k in clone_arg:
                    kept[clone_arg[k]] = args[clone_arg[k]].clone()
                self.calls[k].append((path, tuple(kept)))
                return w(*args)
            # a wrapper counts through its module's global name, which is
            # this recorder while it is patched in: give it a count to
            # bump (the counts are read only in unpatched runs)
            call.launches = 0
            return call

        with self.patched(make):
            fn()
        self.torch.cuda.synchronize()

    def plain_mode(self):
        """Every patched kernel replaced by its plain version."""
        return self.patched(lambda k, w: self.plain[k])

    def turns(self, fn):
        """Device ms of ``fn`` with the kernels and with their plain
        versions, in the order plain, kernels, kernels, plain."""
        t = {"kernels": [], "plain": []}
        for mode in ("plain", "kernels", "kernels", "plain"):
            ctx = self.plain_mode() if mode == "plain" \
                else contextlib.nullcontext()
            with ctx:
                t[mode].append(self.time_cuda(fn, trials=TRIALS))
        return t

    # -- the SpMV paths -----------------------------------------------------

    def spmv_path(self, path, a, fmt, x, expect, check_dtype,
                  exact=None) -> None:
        """One SpMV path: counted run (launch counts ``exact`` where
        given), scipy check, recorded run, and the whole product timed with
        the kernels, with the plain versions and as one cuSPARSE CSR call
        (the yardstick)."""
        torch, nt = self.torch, self.nt
        x_d = x.to(self.dev)
        y = self.counted(lambda: nt.spmv(fmt, x_d), expect, path, exact)
        ok, nf = nt.ans_check(y, nt.spmv_oracle(a, x), dtype=check_dtype,
                              verbose=True, scale=nt.spmv_abs_oracle(a, x))
        rtol = 1e-5 if check_dtype == np.float32 else 1e-8
        print(f"{path}: y vs scipy (rtol {rtol:g}, "
              f"|A||x| bound): {'pass' if ok else 'FAIL'}  finite "
              f"{bool(torch.isfinite(y).all())}", flush=True)
        if not ok or not torch.isfinite(y).all():
            fail(f"{path}: {nf} entries of y disagree with scipy")
        self.record(lambda: nt.spmv(fmt, x_d), path)
        t = self.turns(lambda: nt.spmv(fmt, x_d))
        a_d = a.to(self.dev)
        csr = torch.sparse_csr_tensor(a_d.rpt.long(), a_d.col.long(),
                                      a_d.val, size=a.shape)
        lib_ms = self.time_cuda(lambda: csr @ x_d, trials=TRIALS)
        ms = float(np.mean(t["kernels"]))
        bytes_csr = self.csr_bytes(a)
        print(f"{path} [{self.name}, {self.card}]: kernels {ms:.4f} ms "
              f"({t['kernels']})  plain {np.mean(t['plain']):.4f} ms "
              f"({t['plain']})  torch.sparse CSR @ x {lib_ms:.4f} ms  "
              f"{2 * a.nnz / (ms * 1e-3) / 1e9:.2f} GFLOPS  CSR bound "
              f"{bytes_csr / self.bw * 1e3:.4f} ms ({bytes_csr} B)",
              flush=True)

    def csr_bytes(self, a) -> int:
        """Least traffic of a CSR SpMV (values, column indices, row
        pointers, x and y once each)."""
        vb = a.val.element_size()
        return a.nnz * (vb + 4) + (a.shape[0] + 1) * 4 + sum(a.shape) * vb

    # -- per-kernel comparison, timing and bounds ---------------------------

    @staticmethod
    def fresh(k, args):
        """A recorded call's arguments with fresh copies of the outputs
        that K5, K6 and K2's piece mode write in place."""
        args = list(args)
        if k == "gather_subset":
            args[4] = args[4].clone()
        elif k == "scatter_tiles":
            args[0] = args[0].clone()
        elif k in ("expand_pieces", "expand_pieces_flat"):
            args[-1] = args[-1].clone()
        return args

    def run(self, k, fn, args):
        """``fn`` on a recorded call, on fresh copies of in-place outputs."""
        return fn(*self.fresh(k, args))

    def tolerance(self, k, args):
        """None for exact kernels; else the per-entry bound rtol * |A||x|
        for the two SpMV kernels, whose sums may differ from the plain
        version by FMA contraction (K7) and summation order (K8), and
        rtol * |A_tile||B_tile| for the tile products (K9: summation
        order)."""
        if k == "spgemm_bsr_blocks":
            a, b, *rest = args
            scale = self.plain[k](a.abs(), b.abs(), *rest)
            return (1e-5 if scale.dtype == self.torch.float32 else 1e-8) \
                * scale
        if k == "spmv_dia":
            vals, offs, x, m = args[:4]
            scale = self.plain[k](vals.abs(), offs, x.abs(), m)
        elif k == "spmv_bsr":
            a, x = args
            scale = self.plain[k](dataclasses.replace(a, data=a.data.abs()),
                                  x.abs())
        else:
            return None
        return (1e-6 if scale.dtype == self.torch.float32 else 1e-12) * scale

    def bound_ms(self, k, args, out):
        """The least time of one call: the larger of its bytes (each input
        read once, each output written once) over device memory bandwidth
        and, for K7/K8/K9, its operations over the peak rate.  A gather (K1,
        K5) reads only the source values its valid indices name, each
        once, and K5 reads ``other`` only where a slot gathers."""
        torch = self.torch
        ops = 0.0

        def gathered(src, slots):
            """(valid-slot mask, distinct source values read)."""
            valid = (slots >= 0) & (slots < src.numel())
            return valid, int(torch.unique(slots[valid]).numel())

        if k == "gather":
            src, idx = args
            _, reads = gathered(src, idx)
            vb = src.element_size()
            nbytes = idx.numel() * 4 + reads * vb + out.numel() * vb
        elif k == "gather_subset":
            src, idx, ids, unit, _, other = (*args, None)[:6]
            pos = (ids.long()[:, None] * unit
                   + torch.arange(unit, device=ids.device)).reshape(-1)
            valid, reads = gathered(src, idx[pos])
            n, vb = pos.numel(), src.element_size()
            n_other = 0 if other is None else \
                int((valid & (pos < other.numel())).sum())
            nbytes = n * 4 + (reads + n_other + n) * vb
        elif k == "scatter_tiles":
            dst, ids, vals, _ = args
            nbytes = 2 * vals.numel() * vals.element_size() + ids.numel() * 4
        elif k == "spgemm_bsr_blocks":
            # two tiles per pair and the C tiles once, the pair tables
            a, _, pair_a, _, _, start = args
            n_pairs, bs = pair_a.numel(), a.shape[-1]
            nbytes = (2 * n_pairs + out.shape[0]) * bs * bs \
                * a.element_size() + 4 * (2 * n_pairs + start.numel())
            ops = 2.0 * n_pairs * bs ** 3
        elif k == "gather_tiles8":
            # the ids, each distinct source tile they name, the output
            src, ids = args
            valid = (ids >= 0) & (ids < src.numel() // 1024)
            reads = int(torch.unique(ids[valid]).numel())
            nbytes = ids.numel() * 4 + (reads * 1024 + out.numel()) \
                * src.element_size()
        elif k in ("expand_pieces", "expand_pieces_flat"):
            # the piece tables (and the class table), each distinct bank
            # (or flat table) value a slot reads, the subtiles written
            rows, n_sub, cuts, boffs, _, bank = piece_call(args)
            reads = piece_reads(torch, rows, n_sub, cuts, boffs,
                                128 if k == "expand_pieces" else 1)
            vb = bank.element_size()
            nbytes = cuts.numel() * (8 + vb) + len(rows) * 12 \
                + (reads + out.numel()) * vb
        elif k in ("fused_class", "fused_class_v2"):
            nbytes = k3_bytes(self, k, args, out)
        elif k == "fallback_sum":
            nbytes = fallback_bytes(args[0], out.element_size())
        elif k == "spmv_ell":
            # the CSR yardstick's: each entry's value and column, the row
            # pointers, x and y once (the benchmark's least work)
            a, x = args
            vb = x.element_size()
            nbytes = a.nnz * (vb + 4) + (a.shape[0] + 1) * 4 \
                + sum(a.shape) * vb
            ops = 2.0 * a.nnz
        elif k == "runcopy_kfold":
            # the run descriptors, the K sub-runs of every run (strides of
            # at least the run's length: no value read twice), the output
            plan, src = args
            vb = src.element_size()
            reads = int((plan.kfac.long() * plan.len.long()).sum())
            nbytes = 5 * plan.n_runs * 4 + (reads + out.numel()) * vb
        elif k == "windowed_gather":
            # the indices, the outputs and each window value they name
            win, idx, window = args
            j = idx.long()
            valid = (j >= 0) & (j < window)
            rows = torch.arange(idx.shape[0], device=idx.device)[:, None]
            reads = int(torch.unique((rows * window + j)[valid]).numel())
            nbytes = idx.numel() * 4 + (reads + out.numel()) \
                * win.element_size()
        else:
            seen, nbytes = set(), 0

            def walk(o):
                nonlocal nbytes
                if isinstance(o, torch.Tensor):
                    key = (o.data_ptr(), o.numel())
                    if key not in seen:
                        seen.add(key)
                        nbytes += o.numel() * o.element_size()
                elif isinstance(o, (tuple, list)):
                    for v in o:
                        walk(v)
                elif dataclasses.is_dataclass(o):
                    for f in dataclasses.fields(o):
                        walk(getattr(o, f.name))

            walk(args)
            nbytes += out.numel() * out.element_size()
            if k == "spmv_dia":
                ops = 2.0 * args[0].shape[0] * args[3]
            elif k == "spmv_bsr":
                ops = 2.0 * args[0].data.numel()
        t_bytes = nbytes / self.bw * 1e3
        peak = TILE_PEAK_FLOPS if k == "spgemm_bsr_blocks" else PEAK_FLOPS
        t_ops = ops / peak[out.element_size()] * 1e3
        return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                     else "operations")

    def library_call(self, k, args):
        """One PyTorch call computing the same function, or None."""
        torch = self.torch
        # the gathers' indices are clamped into the source once, outside
        # the timing: PyTorch's indexing asserts on an index past the end,
        # where the kernels give 0
        if k == "gather":
            x, idx = args
            il = idx.long().clamp(0, max(x.numel() - 1, 0))
            return lambda: x[il]
        if k == "gather_subset":
            src, idx, ids, unit = args[:4]
            il = idx.view(-1, unit)[ids.long()].reshape(-1).long().clamp(
                0, max(src.numel() - 1, 0))
            return lambda: src[il]
        if k == "windowed_gather":
            win, idx, window = args
            il = idx.long().clamp(0, window - 1)
            return lambda: torch.gather(win, 1, il)
        if k == "gather_tiles8":
            src, ids = args
            t2 = src.view(-1, 1024)
            il = ids.long().clamp(0, max(t2.shape[0] - 1, 0))
            return lambda: t2.index_select(0, il)
        if k == "scatter_tiles":
            dst, ids, vals, tile = args
            d2, il, v2 = dst.clone().view(-1, tile), ids.long(), \
                vals.view(-1, tile)
            return lambda: d2.index_copy_(0, il, v2)
        if k == "runcopy":
            # the source slot of every output slot, 0 where no run
            # covers it
            plan, src = args
            il = torch.zeros(plan.n_out, dtype=torch.long, device=src.device)
            lens = plan.len.long()
            total = int(lens.sum())
            if total:
                rid = torch.repeat_interleave(
                    torch.arange(plan.n_runs, device=src.device), lens,
                    output_size=total)
                kin = torch.arange(total, device=src.device) \
                    - (torch.cumsum(lens, 0) - lens)[rid]
                il[plan.dst.long()[rid] + kin] = plan.src_off.long()[rid] + kin
            return lambda: src[il]
        if k == "build_bank":
            # the bank's rolled source index, clamped into b_val
            b8_idx, rows, b_val, *rest = args
            copies = rest[0] if rest else self.piecewise.BANK_K
            n = rows * 128
            j = torch.zeros(n, dtype=torch.long, device=b_val.device)
            bias = self.piecewise.BIAS
            j[bias: bias + b8_idx.numel()] = b8_idx.long().clamp(
                0, max(b_val.numel() - 1, 0))
            roll = (torch.arange(n, device=b_val.device)[None, :]
                    + 8 * torch.arange(copies,
                                       device=b_val.device)[:, None]) % n
            il = j[roll].reshape(-1)
            return lambda: b_val[il]
        if k == "spmv_bsr":
            a, x = args
            br, bc = a.blocksize
            nbc = (a.shape[1] + bc - 1) // bc
            bsr = torch.sparse_bsr_tensor(
                a.block_rpt.long(), a.block_col.long(), a.data,
                size=(a.n_block_rows * br, nbc * bc))
            xp = torch.nn.functional.pad(x, (0, nbc * bc - x.numel()))
            try:
                bsr @ xp
                return lambda: bsr @ xp
            except RuntimeError:  # BSR times a vector may want a matrix
                return lambda: bsr @ xp[:, None]
        return None

    def check_calls(self, k, calls):
        """Every call of kernel ``k`` against its plain version; returns
        (max abs error, bound ms, bound kinds)."""
        err, bound, by = 0.0, 0.0, set()
        for path, args in calls:
            got = self.run(k, self.wrappers[k], args)
            want = self.run(k, self.plain[k], args)
            if got.shape != want.shape:
                fail(f"{k} on {path}: shape {tuple(got.shape)} != "
                     f"{tuple(want.shape)}")
            diff = (got - want).abs()
            err = max(err, float(diff.max()) if diff.numel() else 0.0)
            tol = self.tolerance(k, args)
            if (tol is None and not self.torch.equal(got, want)) or (
                    tol is not None and bool((diff > tol).any())):
                fail(f"{k} on {path} disagrees with its plain version: "
                     f"max abs err {float(diff.max())}")
            b, bb = self.bound_ms(k, args, got)
            bound += b
            by.add(bb)
        return err, bound, by

    def time_calls(self, k, calls):
        """(kernel ms, plain ms, library ms or None) of one pass over
        ``calls``, CUDA events over TRIALS passes."""
        # the in-place outputs are copied once, outside the timing (each
        # timed pass rewrites the same slots)
        arglists = [self.fresh(k, args) for _, args in calls]

        def run_all(fn):
            for args in arglists:
                fn(*args)

        plain_ms = self.time_cuda(lambda: run_all(self.plain[k]),
                                  trials=TRIALS)
        ms = self.time_cuda(lambda: run_all(self.wrappers[k]), trials=TRIALS)
        lib = [self.library_call(k, args) for _, args in calls]
        lib_ms = None
        if all(f is not None for f in lib):
            try:
                def run_lib():
                    for f in lib:
                        f()
                lib_ms = self.time_cuda(run_lib, trials=TRIALS)
            except RuntimeError as e:  # not every library call exists
                print(f"{k}: library call failed ({e}); library_ms null")
        return ms, plain_ms, lib_ms

    def kernel_table(self, names=tuple(KERNELS)):
        """Per kernel of ``names``: a line per path and one aggregate row
        (sums over every path the kernel ran on) for the JSON table."""
        table = []
        for k in names:
            route, src, replaces = KERNELS[k]
            if not self.calls[k]:
                fail(f"{k}: no recorded call on any path")
            tol_txt = TOLERANCE.get(k, "exact")
            tot = dict(err=0.0, bound=0.0, by=set(), ms=0.0, plain=0.0,
                       lib=0.0)
            for path in dict.fromkeys(p for p, _ in self.calls[k]):
                calls = [c for c in self.calls[k] if c[0] == path]
                err, bound, by = self.check_calls(k, calls)
                ms, plain_ms, lib_ms = self.time_calls(k, calls)
                print(f"  {k} on {path}: {len(calls)} call(s)  launches "
                      f"{self.path_launches[path].get(k, 0)}  kernel "
                      f"{ms:.4f} ms  plain {plain_ms:.4f} ms  library "
                      f"{fmt_ms(lib_ms)} ms  bound {bound:.4f} ms "
                      f"({'/'.join(sorted(by))})  max_abs_err {err}",
                      flush=True)
                tot["err"] = max(tot["err"], err)
                tot["bound"] += bound
                tot["by"] |= by
                tot["ms"] += ms
                tot["plain"] += plain_ms
                tot["lib"] = None if lib_ms is None or tot["lib"] is None \
                    else tot["lib"] + lib_ms
            print(f"{k}: {len(self.calls[k])} call(s)  launches "
                  f"{self.launches[k]}  max_abs_err {tot['err']} (tolerance: "
                  f"{tol_txt})  kernel {tot['ms']:.4f} ms  plain "
                  f"{tot['plain']:.4f} ms  library {fmt_ms(tot['lib'])} ms  "
                  f"bound {tot['bound']:.4f} ms  [{self.name}, {self.card}]",
                  flush=True)
            table.append(dict(
                name=k, route=route, source=src, replaces=replaces,
                launches=self.launches[k], max_abs_err=tot["err"],
                ms=tot["ms"], plain_ms=tot["plain"], bound_ms=tot["bound"],
                bound_by="bytes" if tot["by"] == {"bytes"} else "operations",
                library_ms=tot["lib"], calls=len(self.calls[k])))
        return table


def piece_call(args):
    """(class rows, compact subtiles, cuts, boffs, apv, source table) of a
    K2 piece-mode call: ``(PieceTables, apv, table, out)``, one launch
    over every class, or the per-class form of trees before it, ``(J,
    cuts, boffs, apv, table, out)``."""
    if isinstance(args[0], int):
        j, cuts, boffs, apv, src, _ = args
        return ((0, j, 0),), cuts.numel() // j, cuts, boffs, apv, src
    tables, apv, src, _ = args
    return tables.rows, tables.n_sub, tables.cuts, tables.boffs, apv, src


def piece_reads(torch, rows, n_sub, cuts, boffs, row_scale) -> int:
    """Distinct source values the slots of a K2 piece-mode call read (a
    slot takes the last piece of its subtile that starts at or before
    it)."""
    pos = torch.arange(1024, device=cuts.device)
    ends = [r[0] for r in rows[1:]] + [n_sub]
    idx = []
    for (first, j, q0), end in zip(rows, ends):
        n = end - first
        c = cuts[q0: q0 + n * j].view(n, j).long()
        sel = torch.searchsorted(c, pos.expand(n, 1024).contiguous(),
                                 right=True) - 1
        bo = boffs[q0: q0 + n * j].view(n, j).long().gather(
            1, sel.clamp(min=0))
        idx.append((bo * row_scale + pos)[sel >= 0])
    return int(torch.unique(torch.cat(idx)).numel()) if idx else 0


def k3_bytes(s, k, args, out, old_rule=False) -> int:
    """The bytes one K3 call must move: the tables its design reads, its
    products (v1) or the distinct bank values and the A values of the
    pieces it reads (v2), the class arena written.  The extraction is
    ``pyr_dst`` (2 bytes per pyramid value); with ``old_rule``, or on a
    plan that predates it, the ext and entry tables of the earlier design
    (4 bytes a slot each) and every piece-table entry."""
    plan, vb = args[0], out.element_size()
    old = old_rule or not hasattr(plan, "pyr_dst")
    extract = (plan.ext_idx.numel() + plan.entry_idx.numel()) * 4 if old \
        else plan.pyr_dst.numel() * 2
    nbytes = extract + plan.tier_idx.numel() * 4 + out.numel() * vb
    if k == "fused_class":
        # the fold-slot table (tile or tile_inv) and the products
        return nbytes + plan.slots * (4 + vb)
    _, bidx, _ = s.window_fused.class_product_sources(plan)
    reads = int(s.torch.unique(bidx).numel())
    nbytes += plan.tile_inv.numel() * 4 + reads * vb
    if old:
        return nbytes + (plan.etrips.numel() + 3 * plan.ecuts.numel()) * 4 \
            + args[2].numel() * vb
    # the two ends of each window's piece range; the pieces in it (cut,
    # end, bank row, subtile and A value)
    pieces = int((plan.etrips[:, 1] - plan.etrips[:, 0]).sum())
    return nbytes + plan.n_win * 8 + pieces * (16 + vb)


def fallback_bytes(plan, vb: int) -> int:
    """The bytes one K13 call must move: each product once with its
    4-byte source, each segment slot written once with its 4-byte slot
    (the slab's pads and chunk members and the warp table are the
    design's, not the work's)."""
    return (plan.n_products + plan.n_out) * (4 + vb)


def fallback_case(s: Smoke, label: str, a, plan) -> None:
    """K13 on one window plan's fallback pool: the segment against its
    plain twin (every slot, bit for bit) and against the parent's stage
    (K1 into the slabs, ``slab_class_reduce``'s adds, pad, K1, the copy
    into the merge buffer) at every entry's slot, bit for bit; the gaps
    +0.0; C through both stages bit for bit; one launch; each timed by
    CUDA events back to back and queued behind a device sleep, beside the
    bound (``fallback_bytes`` at the card's bandwidth)."""
    torch, nt = s.torch, s.nt
    from nsparse_tpu_torch.ops import spgemm_window as sw
    from nsparse_tpu_torch.ops.kernels import piecewise, shuffle
    from nsparse_tpu_torch.ops.spgemm import slab_class_reduce

    plan_d, a_d = plan.to(s.dev), a.to(s.dev)
    w, wd = plan.win, plan_d.win
    if wd.fused_expand:
        bank, apv = sw.v2_delivery(wd, a_d.val, a_d.val)
        prod = piecewise.expand_from_bank(wd.pw, a_d.val, bank)
    else:
        prod = piecewise.piecewise_expand(wd.expand, a_d.val, a_d.val)
    # the parent's stage, from the host plan's slab tables
    shuf, perm = w.fb_shuffle.idx.to(s.dev), w.fb_perm.idx.to(s.dev)
    lvl = tuple(i.to(s.dev) for i in w.fb_lvl_idx)

    def slab_stage(res):
        r = slab_class_reduce(
            shuffle.gather(prod[wd.fb_off : wd.fb_off + wd.fb_len], shuf),
            w.fb_levels, lvl)
        r = torch.nn.functional.pad(r, (0, max(wd.fb.n_out - r.numel(), 0)))
        res[wd.n_compact :].copy_(shuffle.gather(r, perm))

    res_old, res_new, res_twin = (sw.merge_buffer(wd, a_d.val)
                                  for _ in range(3))
    slab_stage(res_old)
    s.counted(lambda: sw.fallback_segment(wd, prod, res_new),
              ["fallback_sum"], f"fallback {label}",
              exact={"fallback_sum": 1, "gather": 0})
    sw.fallback_segment(wd, prod, res_twin, sw.PLAIN_OPS)
    bits = torch.int32 if a.val.dtype == torch.float32 else torch.int64
    seg = [r[wd.n_compact :].view(bits) for r in (res_old, res_new, res_twin)]
    m = wd.merge
    tail = m.src_off.long() >= wd.n_compact
    at = torch.zeros(wd.fb.n_out, dtype=torch.bool, device=s.dev)
    for s0, n in zip((m.src_off.long()[tail] - wd.n_compact).tolist(),
                     m.len.long()[tail].tolist()):
        at[s0 : s0 + n] = True
    twin_ok = torch.equal(seg[1], seg[2])
    old_ok = torch.equal(seg[1][at], seg[0][at])
    gaps_ok = bool((seg[1][~at] == 0).all())
    # C through both stages: the class arenas into the parent's buffer too
    if wd.fused_expand:
        sw.v2_classes(wd, bank, apv, res_old)
    else:
        for (fp, out), (base, slots, _, _) in zip(
                sw._class_slices(wd, res_old), wd.class_geom):
            sw.KERNEL_OPS.fused(fp, prod[base : base + slots], out=out)
    c_old = sw.merge_segments(plan_d, res_old).view(bits)
    c_ok = torch.equal(nt.spgemm_numeric(plan_d, a_d, a_d).val.view(bits),
                       c_old)
    fb = wd.fb
    bound = fallback_bytes(fb, a.val.element_size()) / s.bw * 1e3
    ms = {
        "K13": s.time_cuda(lambda: sw.fallback_segment(wd, prod, res_new),
                           trials=TRIALS),
        "slab stage": s.time_cuda(lambda: slab_stage(res_old),
                                  trials=TRIALS),
        "plain twin": s.time_cuda(
            lambda: sw.fallback_segment(wd, prod, res_twin, sw.PLAIN_OPS),
            trials=TRIALS),
    }
    queued = {
        "K13": queued_device_ms(
            torch, lambda: sw.fallback_segment(wd, prod, res_new)),
        "slab stage": queued_device_ms(torch, lambda: slab_stage(res_old)),
    }
    dev_ms, _ = profiled_device_ms(
        torch, lambda: sw.fallback_segment(wd, prod, res_new),
        "fallback_kernel")
    print(f"K13 on {label} [{s.name}, {s.card}]: {a.val.dtype}, "
          f"{'v2' if wd.fused_expand else 'v1'}, {int(at.sum())} entries in "
          f"a {fb.n_out}-slot segment, {fb.n_products} products in "
          f"{fb.src.numel()} level-0 slots (levels "
          f"{[len(lv) for lv in w.fb_levels]}), {fb.warps.numel() // 2} "
          f"warps, (width, members) {[c[:3:2] for c in fb.classes]}; bit "
          f"for bit: "
          f"plain twin {twin_ok}, slab stage at the entries {old_ok}, gaps "
          f"+0.0 {gaps_ok}, C {c_ok}; "
          + "  ".join(f"{k} {v:.4f} ms" for k, v in ms.items())
          + "  queued " + "  ".join(f"{k} {fmt_ms(v)} ms"
                                    for k, v in queued.items())
          + f"  profiler {fmt_ms(dev_ms)} ms  bound {bound:.4f} ms "
          f"({fallback_bytes(fb, a.val.element_size())} B)", flush=True)
    if not (twin_ok and old_ok and gaps_ok and c_ok):
        fail(f"K13 on {label}: the segment or C differs")


def fallback_phase(s: Smoke) -> None:
    """K13 on Graph500 scale 13 in float32 (the re-run cell's shape, v1)
    and on R-MAT-14 in v1 and v2, float32 and float64 (the window phase's
    host plans: run ``spgemm_phase`` first)."""
    nt = s.nt
    a13 = g500_graph(nt, 13, 16, SEED)
    plan13 = host_timed("Graph500 scale-13 plan",
                        lambda: nt.spgemm_plan(a13, a13))
    fallback_case(s, "Graph500-13", a13, plan13)
    for name in ("window-v1", "window-v2"):
        a, plan, _ = s.host_plans[name]
        for dt in (np.float32, np.float64):
            fallback_case(s, f"R-MAT-{SCALE} {name} {np.dtype(dt).name}",
                          with_dtype_values(a, dt), plan)


def cusparse_spgemm_ms(s: Smoke, a, what: str):
    """Device ms of one cuSPARSE CSR SpGEMM C = A @ A
    (``torch.sparse_csr_tensor @ torch.sparse_csr_tensor``, the
    reference's ``csrgemm`` role) on the card, or None with the error
    printed when the library call fails."""
    torch = s.torch
    a_d = a.to(s.dev)
    try:
        csr = torch.sparse_csr_tensor(a_d.rpt, a_d.col[: a.nnz],
                                      a_d.val[: a.nnz], size=a.shape)
        return s.time_cuda(lambda: csr @ csr, trials=5)
    except RuntimeError as e:
        print(f"{what}: cuSPARSE CSR SpGEMM failed ({e}); library ms null",
              flush=True)
        torch.cuda.empty_cache()
        return None


def check_c(s: Smoke, c, a, what: str) -> None:
    """C against the scipy oracle (rtol 1e-5 f32 / 1e-8 f64 of |A||B|) and
    finite; fails the run otherwise."""
    torch, nt = s.torch, s.nt
    ok = nt.check_spgemm_answer(c, nt.spgemm_oracle(a, a), verbose=True,
                                abs_ref=nt.spgemm_abs_oracle(a, a))
    finite = bool(torch.isfinite(c.val[: c.nnz]).all())
    rtol = 1e-5 if a.val.dtype == torch.float32 else 1e-8
    print(f"{what} vs scipy (rtol {rtol:g}, |A||B| bound): "
          f"{'pass' if ok else 'FAIL'}  finite {finite}", flush=True)
    if not ok or not finite:
        fail(f"{what} does not match the scipy oracle")


def spgemm_phase(s: Smoke) -> None:
    """C = A @ A on R-MAT-14 in the v2 form, then in the v1 form: checks,
    the two forms against each other, timings, the v2 stage split and a
    profile, their kernel calls added to the record."""
    torch, nt = s.torch, s.nt
    from nsparse_tpu_torch.ops import spgemm_window as sw

    a = nt.rmat_csr(SCALE, EDGE_FACTOR, dtype=np.float32, seed=SEED)
    path = nt.choose_spgemm_path(a, a)
    print(f"R-MAT-{SCALE}: choose_spgemm_path -> {path} (block stats "
          f"{nt.block_stats(a, a)})", flush=True)
    if path != "esc":
        fail(f"choose_spgemm_path chose {path} on R-MAT-{SCALE}, not esc")
    t0 = time.perf_counter()
    plan = nt.spgemm_plan(a, a)
    w = plan.win
    print(f"R-MAT-{SCALE} C = A^2 f32: nnz(A) {a.nnz}  intermediate products "
          f"{plan.n_products}  nnz(C) {plan.c_nnz}  host plan "
          f"{time.perf_counter() - t0:.1f} s ({plan.planner} planner)",
          flush=True)
    if (plan.n_products, plan.c_nnz) != (N_PRODUCTS, NNZ_C):
        fail(f"funnel {plan.n_products}/{plan.c_nnz}, "
             f"expected {N_PRODUCTS}/{NNZ_C}")
    print(f"v2 form {w.fused_expand}: aligned B table {w.b8_idx.numel()} "
          f"slots, bank {w.bank_rows} rows "
          f"({16 * w.bank_rows * 128 * 4} B in f32), classes "
          f"{[(g[2], g[1], f.j2_cap) for g, f in zip(w.class_geom, w.fused)]} "
          f"(width, slots, pieces per step), {w.apv_idx.numel()} class "
          f"pieces; fallback pool {w.fb_len} slots, piece classes "
          f"{[int(i.numel()) for i in w.pw.ids] if w.pw else None} subtiles",
          flush=True)
    if not w.fused_expand or w.bank_rows != BANK_ROWS or w.pw is None \
            or w.fb_len != FB_PRODUCTS:
        fail(f"expected the v2 form with a {BANK_ROWS}-row bank and a "
             f"{FB_PRODUCTS}-slot fallback pool")
    plan_d, a_d = plan.to(s.dev), a.to(s.dev)

    def v2_run():
        return nt.spgemm_numeric(plan_d, a_d, a_d)

    c = s.counted(v2_run, SPGEMM_V2, "spgemm")
    # K1: the class A values, the fallback pieces' A values; K2 piece mode
    # once over every piece class; K13 once for the fallback segment
    want = {"build_bank": 1, "gather": 2, "fused_class_v2": len(w.fused),
            "expand_pieces": 1, "gather_tiles8": 1, "fallback_sum": 1,
            "runcopy": 1}
    if s.path_launches["spgemm"] != want:
        fail(f"v2 launches {s.path_launches['spgemm']}, expected {want}")
    check_c(s, c, a, "C (v2)")
    s.rmat14 = (a, a_d, c)  # the other R-MAT-14 layouts reuse the matrix
    s.host_plans["window-v2"] = (a, plan, "spgemm")

    v2 = np.random.default_rng(SEED + 1).standard_normal(a.nnz)
    a2 = a.with_values(torch.from_numpy(v2.astype(np.float32)))
    c2 = nt.spgemm_numeric(plan_d, a2.to(s.dev), a2.to(s.dev))
    check_c(s, c2, a2, "value re-run on the same plan")
    a64 = a2.with_values(torch.from_numpy(v2))
    a64_d = a64.to(s.dev)
    c64 = nt.spgemm_numeric(plan_d, a64_d, a64_d)
    check_c(s, c64, a64, "float64 values on the same plan")

    # the same matrix in the v1 form
    budget, sw.FUSED_BANK_BUDGET = sw.FUSED_BANK_BUDGET, 0
    try:
        plan1 = host_timed("v1 plan (FUSED_BANK_BUDGET = 0)",
                           lambda: nt.spgemm_plan(a, a))
    finally:
        sw.FUSED_BANK_BUDGET = budget
    if plan1.win.fused_expand:
        fail("FUSED_BANK_BUDGET = 0 did not pin the v1 form")
    s.host_plans["window-v1"] = (a, plan1, "spgemm-v1")
    plan1_d = plan1.to(s.dev)

    def v1_run():
        return nt.spgemm_numeric(plan1_d, a_d, a_d)

    c1 = s.counted(v1_run, SPGEMM_V1, "spgemm-v1")
    want = {"expand": 1, "fused_class": len(plan1.win.fused),
            "fallback_sum": 1, "runcopy": 1}
    if s.path_launches["spgemm-v1"] != want:
        fail(f"v1 launches {s.path_launches['spgemm-v1']}, expected {want}")
    check_c(s, c1, a, "C (v1)")
    c64_1 = nt.spgemm_numeric(plan1_d, a64_d, a64_d)
    same = torch.equal(c.val, c1.val) and torch.equal(c64.val, c64_1.val)
    print(f"C v2 == C v1 (torch.equal, f32 and f64): {same}", flush=True)
    if not same:
        fail("the v2 and v1 numeric phases give different C")

    # each form's own kernel calls, for the per-kernel comparison
    ops_type = type(sw.KERNEL_OPS)

    def recorder(field, where):
        # K3 writes into its slice of the merge buffer (out=): the record
        # keeps the inputs only, so each replay writes a fresh arena
        def call(*args, **kw):
            s.calls[SPGEMM_FIELDS[field]].append((where, args))
            return getattr(sw.KERNEL_OPS, field)(*args, **kw)
        return call

    for where, pl in (("spgemm", plan_d), ("spgemm-v1", plan1_d)):
        sw.spgemm_numeric_window(pl, a_d, a_d, ops=ops_type(
            *(recorder(f, where) for f in ops_type._fields)))

    lib_ms = cusparse_spgemm_ms(s, a, "spgemm")
    for where, pl in (("v2", plan_d), ("v1", plan1_d)):
        times = {"plain": [], "kernels": []}
        for mode in ("plain", "kernels", "kernels", "plain"):
            ops = sw.PLAIN_OPS if mode == "plain" else sw.KERNEL_OPS
            times[mode].append(s.time_cuda(
                lambda: sw.spgemm_numeric_window(pl, a_d, a_d, ops=ops),
                trials=TRIALS))
        ms_k = float(np.mean(times["kernels"]))
        print(f"numeric phase {where} [{s.name}, {s.card}]: kernels "
              f"{ms_k:.4f} ms ({times['kernels']})  plain "
              f"{np.mean(times['plain']):.4f} ms ({times['plain']})  "
              f"cuSPARSE CSR A @ A {fmt_ms(lib_ms)} ms  "
              f"{2 * plan.n_products / (ms_k * 1e-3) / 1e9:.2f} GFLOPS",
              flush=True)

    # the v2 stage split (bench.py's headline breakdown), each stage
    # timed alone on the same plan
    w_d = plan_d.win
    bank, apv = sw.v2_delivery(w_d, a_d.val, a_d.val)
    res = sw.merge_buffer(w_d, a_d.val)
    sw.v2_classes(w_d, bank, apv, res)
    sw.v2_fallback(w_d, a_d.val, bank, res)
    stage_ms = {
        "delivery": s.time_cuda(
            lambda: sw.v2_delivery(w_d, a_d.val, a_d.val), trials=TRIALS),
        "classes": s.time_cuda(lambda: sw.v2_classes(w_d, bank, apv, res),
                               trials=TRIALS),
        "fallback": s.time_cuda(
            lambda: sw.v2_fallback(w_d, a_d.val, bank, res), trials=TRIALS),
        "merge": s.time_cuda(lambda: sw.merge_segments(plan_d, res),
                             trials=TRIALS),
    }
    print(f"v2 stages [{s.name}, {s.card}]: "
          + "  ".join(f"{k} {v:.4f} ms" for k, v in stage_ms.items())
          + f"  (sum {sum(stage_ms.values()):.4f} ms)", flush=True)
    profile_calls(torch, v2_run, "v2 numeric")
    profile_calls(torch, v1_run, "v1 numeric")


def layout_path(s: Smoke, path: str, a, plan, run, ops_run, want) -> None:
    """One R-MAT C = A @ A path in a host-plan layout: the counted run of
    ``run()`` with its launches held to ``want`` exactly, the scipy check,
    new values on the same plan in float32 and float64, the kernel calls
    recorded through ``ops_run(ops)``, and the numeric phase timed with
    the kernels, with their plain versions and as one cuSPARSE CSR
    SpGEMM.  ``ops_run`` None: the path's kernels sit behind
    ``flat_gather``, recorded and swapped there.  Returns C."""
    torch, nt = s.torch, s.nt
    from nsparse_tpu_torch.ops import spgemm_window as sw

    c = s.counted(run, list(want), path)
    if s.path_launches[path] != want:
        fail(f"{path}: launches {s.path_launches[path]}, expected {want}")
    check_c(s, c, a, f"{path}: C")
    v2 = np.random.default_rng(SEED + 2).standard_normal(a.nnz)
    for dt in (np.float32, np.float64):
        a2 = a.with_values(torch.from_numpy(v2.astype(dt)))
        a2_d = a2.to(s.dev)
        check_c(s, nt.spgemm_numeric(plan, a2_d, a2_d), a2,
                f"{path}: new {np.dtype(dt).name} values on the same plan")
    if ops_run is None:
        s.record(run, path)
        t = s.turns(run)
    else:
        ops_type = type(sw.KERNEL_OPS)

        def recorder(field):
            def call(*args, **kw):
                s.calls[SPGEMM_FIELDS[field]].append((path, args))
                return getattr(sw.KERNEL_OPS, field)(*args, **kw)
            return call

        ops_run(ops_type(*(recorder(f) for f in ops_type._fields)))
        t = {"plain": [], "kernels": []}
        for mode in ("plain", "kernels", "kernels", "plain"):
            ops = sw.PLAIN_OPS if mode == "plain" else sw.KERNEL_OPS
            t[mode].append(s.time_cuda(lambda: ops_run(ops), trials=TRIALS))
    lib_ms = cusparse_spgemm_ms(s, a, path)
    ms = float(np.mean(t["kernels"]))
    print(f"{path} numeric phase [{s.name}, {s.card}]: kernels {ms:.4f} ms "
          f"({t['kernels']})  plain {np.mean(t['plain']):.4f} ms "
          f"({t['plain']})  cuSPARSE CSR A @ A {fmt_ms(lib_ms)} ms  "
          f"{2 * plan.n_products / (ms * 1e-3) / 1e9:.2f} GFLOPS", flush=True)
    return c


def global_launches(pw) -> dict:
    """The launches of the global slab layout's numeric phase: K11 (the
    bank, or the flat table), K1 three times (the pieces' A values, the
    slab shuffle, the assembly), K2 once over every piece class in the
    plan's mode, K12."""
    mode = "expand_pieces" if pw.aligned else "expand_pieces_flat"
    return {"build_bank": 1, "gather": 3, mode: 1, "gather_tiles8": 1}


def global_phase(s: Smoke, path: str, a, plan) -> object:
    from nsparse_tpu_torch.ops.spgemm import spgemm_numeric_slab

    pw = plan.glob.pw
    print(f"{path}: {'aligned' if pw.aligned else 'unaligned'} pieces, "
          f"8-aligned B table {pw.nnz_b} slots, table {pw.table_rows} rows, "
          f"arena {pw.n_pad} slots in {[int(i.numel()) for i in pw.ids]} "
          f"piece subtiles, slab levels "
          f"{[len(lv) for lv in plan.glob.slab_levels]}", flush=True)
    plan_d, a_d = plan.to(s.dev), a.to(s.dev)
    return layout_path(
        s, path, a, plan_d, lambda: s.nt.spgemm_numeric(plan_d, a_d, a_d),
        lambda ops: spgemm_numeric_slab(plan_d, a_d, a_d, ops),
        global_launches(pw))


def sort_launches(srt) -> dict:
    """The launches of a host sort plan's numeric phase: per gather plan
    (the B fill without ``other``, the A values with it) K5 once where it
    has class units, and K1 (twice with ``other``) and K6 once where it
    has fallback tiles."""
    want = {}
    for gp, with_other in ((srt.bv_gp, False), (srt.av_gp, True)):
        n5 = k5_launches([gp])
        fb = int(bool(gp.fb_ids.numel()))
        for k, n in (("gather_subset", n5), ("gather", (1 + with_other) * fb),
                     ("scatter_tiles", fb)):
            if n:
                want[k] = want.get(k, 0) + n
    return want


def esc_layout_phases(s: Smoke) -> None:
    """The host plan's other layouts.
    spgemm-global: R-MAT-14 in the global slab layout (aligned pieces),
    C equal in structure to the window C and its values within 1e-5 of
    |A||B| of it; spgemm-global-unaligned: R-MAT-16 (edge factor 4), whose
    B table exceeds the bank, in the flat piece mode; spgemm-sort:
    R-MAT-14 below the routed layouts (``shuffle=False``), two runs
    equal.  The one-shot ``nt.spgemm`` is ``hash_phase``'s."""
    torch, nt = s.torch, s.nt
    from nsparse_tpu_torch.ops.kernels.piecewise import (
        BANK_ROWS_MAX,
        bank_rows_for,
    )
    from nsparse_tpu_torch.utils.checking import spgemm_abs_oracle

    a, a_d, c_win = s.rmat14
    plan = host_timed("global plan R-MAT-14", lambda: nt.spgemm_plan(
        a, a, layout="global"))
    if plan.layout != "global" or not plan.glob.pw.aligned \
            or plan.glob.pw.table_rows != BANK_ROWS:
        fail(f"R-MAT-14 global: layout {plan.layout}, expected aligned "
             f"pieces on a {BANK_ROWS}-row bank")
    c = global_phase(s, "spgemm-global", a, plan)
    scale = torch.from_numpy(spgemm_abs_oracle(a, a).data).to(s.dev)
    diff = (c.val[: c.nnz].double() - c_win.val[: c.nnz].double()).abs()
    same = torch.equal(c.rpt, c_win.rpt) and torch.equal(c.col, c_win.col)
    rel = float((diff / scale).max())
    print(f"spgemm-global: C structure equal to the window C (torch.equal): "
          f"{same}; max |C_global - C_window| / (|A||B|) {rel:.3g} "
          f"(within 1e-5: {rel <= 1e-5})", flush=True)
    if not same or rel > 1e-5:
        fail("the global and window layouts give different C")
    s.host_plans["global"] = (a, plan, "spgemm-global")
    del plan, c

    a16 = host_timed("generate R-MAT-16 (edge factor 4)", lambda: nt.rmat_csr(
        UNALIGNED["scale"], UNALIGNED["edge_factor"], dtype=np.float32,
        seed=UNALIGNED["seed"]))
    plan = host_timed("global plan R-MAT-16", lambda: nt.spgemm_plan(
        a16, a16, layout="global"))
    pw = plan.glob.pw
    got = (a16.nnz, plan.n_products, pw.nnz_b, bank_rows_for(pw.nnz_b))
    print(f"R-MAT-16: nnz(A), P, 8-aligned slots, bank rows {got} (bank "
          f"limit {BANK_ROWS_MAX} rows); nnz(C) {plan.c_nnz}", flush=True)
    if got != UNALIGNED_COUNTS or pw.aligned or plan.layout != "global":
        fail(f"R-MAT-16: counts {got}, expected {UNALIGNED_COUNTS} and the "
             "unaligned mode")
    global_phase(s, "spgemm-global-unaligned", a16, plan)
    s.host_plans["global-unaligned"] = (a16, plan, "spgemm-global-unaligned")
    del plan, a16

    plan = host_timed("sort plan R-MAT-14", lambda: nt.spgemm_plan(
        a, a, shuffle=False))
    if plan.layout != "sort":
        fail(f"R-MAT-14 shuffle=False: layout {plan.layout}, not sort")
    srt = plan.srt
    want = sort_launches(srt)
    if set(want) != gather_kernels([srt.av_gp, srt.bv_gp]):
        fail(f"sort plan launches {want} disagree with gather_kernels")
    s.host_plans["sort"] = (a, plan, "spgemm-sort")
    print(f"spgemm-sort: gather plans av {srt.av_gp.class_fracs}, bv "
          f"{srt.bv_gp.class_fracs}", flush=True)
    plan_d = plan.to(s.dev)

    def sort_run():
        return nt.spgemm_numeric(plan_d, a_d, a_d)

    c = layout_path(s, "spgemm-sort", a, plan_d, sort_run, None, want)
    again = sort_run()
    print(f"spgemm-sort: two runs equal (torch.equal): "
          f"{torch.equal(c.val, again.val)}", flush=True)
    if not torch.equal(c.val, again.val):
        fail("the sort layout's numeric phase is not deterministic")
    profile_calls(torch, sort_run, "sort-layout numeric", calls=3)
    del plan, plan_d, c, again


def g500_graph(nt, scale: int, edge_factor: int, seed: int):
    """A Graph500 Kronecker graph (A = 0.57, B = C = 0.19) in kernel 1's
    undirected form (each edge both ways, duplicates merged), weights
    uniform in [0, 1), float32."""
    m = nt.rmat_csr(scale, edge_factor, seed=seed).to_scipy()
    m.data[:] = 1.0
    u = (m + m.T).tocsr()
    u.sum_duplicates()
    u.data = np.random.default_rng(seed).random(u.nnz).astype(np.float32)
    return nt.CSR.from_scipy(u)


def with_dtype_values(a, dtype):
    """``a`` with its values cast to ``dtype`` (numpy)."""
    import torch

    return a.with_values(torch.from_numpy(a.val.numpy().astype(dtype)))


def hash_call(s: Smoke, a_d, b_d):
    """One ``nt.spgemm(a_d, b_d)`` (the hash path) under the recorder:
    (C, the recorder's counters, peak device bytes above the inputs)."""
    torch, nt = s.torch, s.nt
    from nsparse_tpu_torch.utils import profiling

    profiling.reset()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    with profiling.recording():
        c = nt.spgemm(a_d, b_d)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    counters = profiling.snapshot()["counters"]
    profiling.reset()
    if not any(k.startswith("launch.nsp_hash_") for k in counters):
        fail("hash path: no launch of csrc/spgemm_hash.cu recorded")
    return c, counters, peak


def route_lines(counters) -> str:
    """The rows a route took and the launches, from the recorder."""
    rows = {k[len("spgemm_hash.rows."):]: v for k, v in counters.items()
            if k.startswith("spgemm_hash.rows.") and v}
    launches = {k[len("launch."):]: v for k, v in counters.items()
                if k.startswith("launch.nsp_hash_")}
    return (f"rows by route {rows}; global rows "
            f"{counters.get('spgemm_hash.global_rows', 0)}; launches "
            f"{launches}; host reads {counters.get('sync', 0)}")


def check_routes(counters, what: str, a, b, c) -> dict:
    """One symbolic and one numeric launch per route that took rows, two
    host reads, and the rows of each route those the host computes from
    the sizes (symbolic: a row's products capped at N; numeric: its nnz)
    by ``hash_routes``' limits.  Returns {phase: [routes with rows]}."""
    from nsparse_tpu_torch.ops.binning import flops_per_row
    from nsparse_tpu_torch.ops.kernels import spgemm_hash as sh

    n = b.shape[1]
    sizes = {"symbolic": flops_per_row(a, b).clamp(max=n).numpy(),
             "numeric": np.diff(c.rpt.cpu().numpy())}
    used = {}
    for phase, entry in (("symbolic", "nsp_hash_symbolic"),
                         ("numeric", "nsp_hash_numeric")):
        routes = sh.hash_routes(phase, n, a.val.element_size())
        bins = sh.route_of(sizes[phase], routes)
        want = {r.name: int((bins == k).sum()) for k, r in enumerate(routes)}
        got = {r.name: counters.get(f"spgemm_hash.rows.{phase}.{r.name}", 0)
               for r in routes}
        if got != want:
            fail(f"{what}: {phase} rows by route {got}, the host's {want}")
        used[phase] = [name for name, v in got.items() if v]
        if counters.get(f"launch.{entry}", 0) != len(used[phase]):
            fail(f"{what}: {counters.get(f'launch.{entry}', 0)} {phase} "
                 f"launches for {len(used[phase])} routes with rows")
    if counters.get("sync", 0) != 2:
        fail(f"{what}: {counters.get('sync', 0)} host reads, not 2")
    return used


def hash_against_esc(s: Smoke, what: str, a, a_d, b=None, b_d=None,
                     scipy_check=True, routes=None, every_route=False):
    """The hash path's C against the ESC path's (``planner="device"``;
    skipped where M * N >= 2^31, which it refuses): ``rpt`` and ``col``
    equal (``torch.equal``), values within 1e-5 (f32) or 1e-8 (f64) of
    |A||B|; against scipy too where asked; rows by route as
    ``check_routes`` holds them.  ``routes``: the tail route every row
    must take in both phases; ``every_route``: every route of both phases
    must take rows.  Returns (C, counters, peak bytes)."""
    torch, nt = s.torch, s.nt
    from nsparse_tpu_torch.ops.kernels import spgemm_hash as sh

    b, b_d = (a, a_d) if b is None else (b, b_d)
    c, counters, peak = hash_call(s, a_d, b_d)
    used = check_routes(counters, what, a, b, c)
    if every_route:
        for phase in sh.PHASES:
            names = [r.name for r in sh.hash_routes(
                phase, b.shape[1], a.val.element_size())]
            if used[phase] != names:
                fail(f"{what}: {phase} routes with rows {used[phase]}, "
                     f"not every one of {names}")
    print(f"{what}: nnz(C) {c.nnz}; {route_lines(counters)}; peak "
          f"{peak / 1e9:.3f} GB above the inputs", flush=True)
    tail = bool((c.val[c.nnz:] == 0).all()) and bool((c.col[c.nnz:] == 0)
                                                     .all())
    if not tail:
        fail(f"{what}: C's padded tail is not zero")
    if a.shape[0] * b.shape[1] < 2**31:
        ref = nt.spgemm(a_d, b_d, planner="device")
        same = c.nnz == ref.nnz and torch.equal(c.rpt, ref.rpt) \
            and torch.equal(c.col, ref.col)
        scale = nt.spgemm(
            a_d.with_values(a_d.val.abs()), b_d.with_values(b_d.val.abs()),
            planner="device").val[: c.nnz].double()
        gap = float(((c.val[: c.nnz].double() - ref.val[: c.nnz].double())
                     .abs() / scale.clamp_min(1e-300)).max()) \
            if c.nnz else 0.0
        tol = 1e-5 if a.val.dtype == torch.float32 else 1e-8
        print(f"{what}: rpt and col equal to the ESC path's (torch.equal) "
              f"{same}; max |C_hash - C_esc| / (|A||B|) {gap:.3g} (within "
              f"{tol:g}: {gap <= tol}); zero tail {tail}", flush=True)
        if not same or gap > tol:
            fail(f"{what}: the hash path's C differs from the ESC path's")
        del ref, scale
    if routes is not None:
        for phase, name in routes.items():
            got = {k: v for k, v in counters.items()
                   if k.startswith(f"spgemm_hash.rows.{phase}.") and v}
            if list(got) != [f"spgemm_hash.rows.{phase}.{name}"]:
                fail(f"{what}: {phase} rows {got}, expected all in {name}")
    if scipy_check and b is a:
        check_c(s, c, a, f"{what}: C")
    return c, counters, peak


def hash_bound_ms(s: Smoke, a, b, c) -> float:
    """The least time of C = A @ B: A and B read once (once if they are
    one matrix), C written once, at the card's memory bandwidth."""
    vb = a.val.element_size()

    def csr_bytes(m, nnz):
        return (m + 1) * 4 + nnz * (4 + vb)

    nbytes = csr_bytes(a.shape[0], a.nnz) + csr_bytes(c.shape[0], c.nnz)
    if b is not a:
        nbytes += csr_bytes(b.shape[0], b.nnz)
    return nbytes / s.bw * 1e3


# products a row of ``route_ladder``'s C: one size inside each bin of both
# phases where the hash blocks apply (pwarp, warp, the blocks of 2,048 to
# 32,768 slots, two sizes past the largest numeric table)
LADDER = (16, 300, 800, 1500, 3000, 6000, 12000, 30000)
# (N, dtype) of the ladder: the routes past the warp route in the symbolic
# and the numeric phase (hash_routes)
LADDER_CASES = (
    (1 << 22, np.float32),  # dense (5 passes); blocks, then dense (150)
    (1 << 23, np.float64),  # dense (10); blocks, then device tables (591)
    (1 << 25, np.float32),  # blocks, then device tables in both phases
)


def route_ladder(nt, n: int, dtype, rng, per_b: int = 8, reps: int = 4):
    """(A, B) for C = A @ B of N = ``n`` columns whose rows span every
    route: B is 8,192 x n with ``per_b`` random columns a row, A holds
    ``reps`` rows for each size of ``LADDER``, each naming distinct rows of
    B, so a row's products are about that size."""
    import scipy.sparse as sp

    k = 8192
    lens = np.repeat(np.asarray(LADDER) // per_b, reps)
    a_ptr = np.concatenate([[0], np.cumsum(lens)])
    a_col = np.concatenate([np.sort(rng.choice(k, size=r, replace=False))
                            for r in lens])
    a = sp.csr_matrix((rng.random(a_ptr[-1]) + 0.5, a_col, a_ptr),
                      shape=(len(lens), k))
    b = sp.coo_matrix((rng.random(k * per_b) + 0.5,
                       (np.repeat(np.arange(k), per_b),
                        rng.integers(0, n, k * per_b))), shape=(k, n)).tocsr()
    b.sum_duplicates()
    return (nt.CSR.from_scipy(a, dtype=dtype),
            nt.CSR.from_scipy(b, dtype=dtype))


def hash_geometry(s: Smoke) -> None:
    """Each hash route's kernel as launched on this card (resident blocks
    an SM, registers and spilled bytes a thread, shared memory), at the
    one-shot cell's N = 32768 and at N = 2^22 and 2^25 (every kernel of
    both phases; ``LADDER_CASES``); the dense route must hold
    two blocks an SM, as ``dense_route`` sizes it."""
    from nsparse_tpu_torch.ops.kernels import spgemm_hash as sh

    for n in (32768, 1 << 22, 1 << 25):
        for vb in (4, 8):
            for phase in sh.PHASES:
                if phase == "symbolic" and vb == 8:
                    continue  # the symbolic phase keeps no values
                for r in sh.hash_routes(phase, n, vb):
                    g = sh.route_geometry(phase, r, vb)
                    print(f"hash route {phase} {r.name} N={n} "
                          f"{'f32' if vb == 4 else 'f64'} [{s.card}]: "
                          f"{r.threads} threads, {g['smem']} B shared, "
                          f"{g['blocks_per_sm']} blocks an SM, "
                          f"{g['registers']} registers, {g['spill_bytes']} "
                          f"B spilled a thread", flush=True)
                    if r.kind == sh.DENSE and g["blocks_per_sm"] < 2:
                        fail(f"dense route {phase} N={n}: "
                             f"{g['blocks_per_sm']} blocks an SM, not 2")


def hash_phase(s: Smoke) -> None:
    """spgemm-oneshot: ``nt.spgemm(a, a)`` without a plan takes the hash
    path (``csrc/spgemm_hash.cu``): on R-MAT-14 and a Graph500 scale-15
    graph, in f32 and f64, C's ``rpt`` and ``col`` equal to the ESC
    path's (``planner="device"``) and its values within tolerance, the
    rows per route (as the host bins them), launches per route and peak
    memory from the recorder, timed beside the ESC path, cuSPARSE and the
    bound; then the edge cases: empty rows, a row whose products cover all
    N columns, every row in the tail route (dense), every route of both
    phases (``route_ladder`` at N = 2^22 to 2^25: the dense route, the
    hash blocks, device-memory tables),
    products that cancel to exactly 0 (the entries stay), M * N >= 2^31
    (the ESC path refuses it).  First each route's kernel geometry."""
    torch, nt = s.torch, s.nt
    import scipy.sparse as sp

    hash_geometry(s)

    a14 = nt.rmat_csr(SCALE, EDGE_FACTOR, dtype=np.float32, seed=SEED)
    g15 = host_timed("generate Graph500 scale 15", lambda: g500_graph(
        nt, **HASH_G500))
    for name, base in ((f"R-MAT-{SCALE}", a14),
                       (f"Graph500-{HASH_G500['scale']}", g15)):
        for dt in (np.float32, np.float64):
            a = with_dtype_values(base, dt)
            a_d = a.to(s.dev)
            what = f"spgemm-oneshot {name} {np.dtype(dt).name}"
            small = base is a14
            c, counters, peak = hash_against_esc(s, what, a, a_d,
                                                 scipy_check=small)
            trials = TRIALS if small else 5
            ms = s.time_cuda(lambda: nt.spgemm(a_d, a_d), trials=trials)
            t0 = time.perf_counter()
            nt.spgemm(a_d, a_d)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
            esc_ms = s.time_cuda(
                lambda: nt.spgemm(a_d, a_d, planner="device"), trials=3)
            lib_ms = cusparse_spgemm_ms(s, a, what)
            bound = hash_bound_ms(s, a, a, c)
            flops = nt.spgemm_flops(a, a)
            print(f"{what} [{s.name}, {s.card}]: hash {ms:.4f} ms by CUDA "
                  f"events ({flops / ms / 1e6:.2f} GFLOP/s), {wall:.4f} ms "
                  f"host wall of one call; ESC (planner='device') "
                  f"{esc_ms:.4f} ms; cuSPARSE CSR A @ A {fmt_ms(lib_ms)} ms; "
                  f"bound {bound:.4f} ms (bytes); peak {peak / 1e9:.3f} GB",
                  flush=True)
            s.hash_rows.append(dict(
                what=what, ms=ms, plain_ms=esc_ms, library_ms=lib_ms,
                bound_ms=bound, peak_gb=peak / 1e9, nnz=c.nnz,
                routes=route_lines(counters)))
            if small and dt == np.float32:
                profile_calls(torch, lambda: nt.spgemm(a_d, a_d),
                              "one-shot hash SpGEMM", calls=3)
            del c, a_d
            torch.cuda.empty_cache()

    rng = np.random.default_rng(SEED + 5)

    def case(what, a, b=None, routes=None, scipy_check=True,
             every_route=False):
        b = a if b is None else b
        a_d, b_d = a.to(s.dev), b.to(s.dev)
        c, _, _ = hash_against_esc(s, what, a, a_d, b, b_d,
                                   scipy_check=False, routes=routes,
                                   every_route=every_route)
        if scipy_check:
            ok = nt.check_spgemm_answer(
                c, nt.spgemm_oracle(a, b), verbose=True,
                abs_ref=nt.spgemm_abs_oracle(a, b))
            print(f"{what}: C vs scipy {'pass' if ok else 'FAIL'}",
                  flush=True)
            if not ok:
                fail(f"{what}: C does not match scipy")
        return c

    for dt in (np.float32, np.float64):
        tag = np.dtype(dt).name
        # every third row of R-MAT-14 emptied
        keep = (np.arange(a14.shape[0]) % 3 != 0).astype(np.float64)
        m = (sp.diags(keep) @ a14.to_scipy()).tocsr()
        m.eliminate_zeros()
        case(f"hash-empty-rows {tag}", nt.CSR.from_scipy(m, dtype=dt))
        # row 0 of A dense: with B = I + a random matrix, C's row 0 covers
        # every column (the dense route)
        n = HASH_WIDE
        r = sp.random(n, n, density=4 / n, random_state=rng, format="csr")
        r = r.tolil()
        r[0, :] = 1.0
        a = nt.CSR.from_scipy(r.tocsr(), dtype=dt)
        b = nt.CSR.from_scipy(
            (sp.identity(n) + sp.random(n, n, density=4 / n,
                                        random_state=rng)).tocsr(), dtype=dt)
        c = case(f"hash-full-row {tag}", a, b)
        if int(c.rpt[1]) != n:
            fail(f"hash-full-row {tag}: row 0 holds {int(c.rpt[1])} of {n}")
        # every row in the tail route of both phases: the dense route in
        # one pass (symbolic), three (f32) or five (f64)
        n_tail = 65536
        a = nt.CSR.from_scipy(sp.random(512, n_tail, density=300 / n_tail,
                                        random_state=rng, format="csr"),
                              dtype=dt)
        b = nt.CSR.from_scipy(sp.random(n_tail, n_tail, density=100 / n_tail,
                                        random_state=rng, format="csr"),
                              dtype=dt)
        case(f"hash-tail-route {tag}", a, b,
             routes={"symbolic": "dense", "numeric": "dense"})
        # A = [X X], B = [Y; -Y] with small integers: C's entries are sums
        # of exact terms that cancel, 0 in every order, and stay in C
        x = sp.random(2048, 1024, density=0.01, random_state=rng,
                      data_rvs=lambda k: rng.integers(1, 5, k))
        y = sp.random(1024, 2048, density=0.01, random_state=rng,
                      data_rvs=lambda k: rng.choice([-4, -3, -2, -1, 1, 2,
                                                     3, 4], k))
        a = nt.CSR.from_scipy(sp.hstack([x, x]).tocsr(), dtype=dt)
        b = nt.CSR.from_scipy(sp.vstack([y, -y]).tocsr(), dtype=dt)
        c = case(f"hash-cancel {tag}", a, b, scipy_check=False)
        if not c.nnz or bool(c.val[: c.nnz].any()):
            fail(f"hash-cancel {tag}: nnz {c.nnz}, nonzero values left")
        print(f"hash-cancel {tag}: {c.nnz} entries, every one exactly 0",
              flush=True)
        # every route of both phases takes rows (LADDER_CASES)
        for n_ladder, dt_ladder in LADDER_CASES:
            if dt_ladder == dt:
                a, b = route_ladder(nt, n_ladder, dt, rng)
                case(f"hash-every-route N={n_ladder} {tag}", a, b,
                     every_route=True)
        # M * N >= 2^31: the hash path has no packed key
        n = 1 << 16
        big = nt.CSR.from_scipy(sp.random(n, n, density=4 / n,
                                          random_state=rng, format="csr"),
                                dtype=dt)
        big_d = big.to(s.dev)
        try:
            nt.spgemm(big_d, big_d, planner="device")
            fail("the ESC path accepted M * N >= 2^31")
        except ValueError as e:
            print(f"hash-wide-key {tag}: the ESC path refuses it ({e})",
                  flush=True)
        c, counters, _ = hash_call(s, big_d, big_d)
        check_routes(counters, f"hash-wide-key {tag}", big, big, c)
        ok = nt.check_spgemm_answer(c, nt.spgemm_oracle(big, big),
                                    verbose=True,
                                    abs_ref=nt.spgemm_abs_oracle(big, big))
        print(f"hash-wide-key {tag}: M * N = 2^32, nnz(C) {c.nnz}, C vs "
              f"scipy {'pass' if ok else 'FAIL'}; {route_lines(counters)}",
              flush=True)
        if not ok:
            fail(f"hash-wide-key {tag}: C does not match scipy")
    galerkin_case(s, rng)


def hpcg_level(nt, n: int, rng):
    """(R, A, P) of one level of HPCG's multigrid set-up on an n³ grid
    (n even), float64, built with scipy: A the 27-point stencil (x
    fastest), diagonal 26, each off-diagonal pair -f with f uniform in
    [0.5, 1.5); P trilinear interpolation from the points (2i, 2j, 2k)
    (1-D weights 1 and 1/2, the last odd point of a line taking its one
    coarse neighbour at 1/2); R = P^T."""
    import scipy.sparse as sp

    def kron3(m):
        k = sp.kron(sp.kron(m, m), m).tocsr()
        k.eliminate_zeros()  # kron may store whole blocks, zeros too
        return k

    pattern = kron3(sp.diags([1.0, 1.0, 1.0], [-1, 0, 1], shape=(n, n)))
    up = sp.triu(pattern, 1).tocsr()
    up.data = rng.uniform(0.5, 1.5, up.nnz)
    a = (26.0 * sp.identity(n ** 3) - up - up.T).tocsr()
    i = np.arange(n)
    p1 = sp.csr_matrix((np.where(i % 2, 0.5, 1.0), (i, i // 2)),
                       shape=(n, n // 2)) + sp.csr_matrix(
        (np.full(n // 2 - 1, 0.5), (i[1:-1:2], i[1:-1:2] // 2 + 1)),
        shape=(n, n // 2))
    p = kron3(p1.tocsr())
    return tuple(nt.CSR.from_scipy(m.tocsr()) for m in (p.T, a, p))


def galerkin_case(s: Smoke, rng) -> None:
    """HPCG's Galerkin product R·(A·P) at ``GALERKIN_GRID``³ in f64, the
    hash path on rectangular operands with the first product's C as the
    second's B: A·P against scipy (M·N is past the ESC path's key), R·(A·P)
    against the ESC path, each product's rows by route the host's binning
    (``check_routes``: symbolic pwarp and warp, numeric pwarp), then
    ``nt.rap`` against scipy's R @ A @ P within 1e-8 of |R||A||P|, equal
    in structure to the two products, four host reads and ``rap.ap_nnz``
    from the recorder."""
    torch, nt = s.torch, s.nt
    from nsparse_tpu_torch.utils import profiling

    n = GALERKIN_GRID
    what = f"hash-galerkin {n}^3 f64"
    r, a, p = host_timed(f"{what}: build R, A, P",
                         lambda: hpcg_level(nt, n, rng))
    r_d, a_d, p_d = (m.to(s.dev) for m in (r, a, p))
    ap_d, counters, _ = hash_against_esc(s, f"{what} A·P", a, a_d, p, p_d,
                                         scipy_check=False)
    check_chain(s, ap_d, (a, p), f"{what} A·P")
    used = [check_routes(counters, f"{what} A·P", a, p, ap_d)]
    ap = ap_d.to("cpu")
    c_d, counters, _ = hash_against_esc(s, f"{what} R·(A·P)", r, r_d, ap,
                                        ap_d, scipy_check=False)
    used.append(check_routes(counters, f"{what} R·(A·P)", r, ap, c_d))
    for u in used:
        if not set(u["symbolic"]) <= {"pwarp", "warp"} or \
                u["numeric"] != ["pwarp"]:
            fail(f"{what}: routes with rows {u}, expected symbolic pwarp "
                 "and warp, numeric pwarp")
    profiling.reset()
    with profiling.recording():
        c = nt.rap(r_d, a_d, p_d)
        torch.cuda.synchronize()
    snap = profiling.snapshot()
    profiling.reset()
    check_chain(s, c, (r, a, p), f"{what} rap")
    same = torch.equal(c.rpt, c_d.rpt) and torch.equal(c.col, c_d.col)
    reads = snap["counters"].get("sync", 0)
    ap_nnz = snap["counters"].get("rap.ap_nnz")
    ms = s.time_cuda(lambda: nt.rap(r_d, a_d, p_d), trials=5)
    flops = 2 * (nt.spgemm_flops(a, p) + nt.spgemm_flops(r, ap))
    print(f"{what} rap [{s.card}]: nnz(A·P) {ap.nnz}, nnz(C) {c.nnz}; "
          f"structure equal to the two products' {same}; host reads "
          f"{reads}; rap.ap_nnz {ap_nnz}; {ms:.4f} ms by CUDA events "
          f"({flops / ms / 1e6:.2f} GFLOP/s)", flush=True)
    if not same or reads != 4 or ap_nnz != ap.nnz:
        fail(f"{what}: rap's C, host reads or counter differ from its "
             "two products'")


ROOT = os.path.dirname(os.path.abspath(__file__))
CIRCUIT = os.path.join(ROOT, "data", "circuit_zipf.mtx")


def plan_cache_phase(s: Smoke) -> None:
    """The SpGEMM paths' host plans through the plan cache: each saved
    (file MB, host s), loaded (host s, its index tables checked), moved to
    the card and run; C equal to the unsaved plan's (``torch.equal``) and
    the launch counts equal to its path's.  Then ``spgemm_plan_cached``
    twice on ``data/circuit_zipf.mtx`` (f32) into one directory: a miss,
    then a hit, both Cs checked on the card against scipy (|A||B| bound),
    the numeric phase's K5, K1 and K6 launches counted."""
    torch, nt = s.torch, s.nt
    from nsparse_tpu_torch.tune import spgemm_cache as sc
    from nsparse_tpu_torch.utils.checking import (
        check_spgemm_answer_device,
        spgemm_abs_oracle,
    )

    with tempfile.TemporaryDirectory() as d:
        for name, (a, plan, orig) in s.host_plans.items():
            path = os.path.join(d, f"{name}.npz")
            t0 = time.perf_counter()
            sc.save_spgemm_plan(plan, path)
            t_save = time.perf_counter() - t0
            t0 = time.perf_counter()
            loaded = sc.load_spgemm_plan(path)
            t_load = time.perf_counter() - t0
            mb = os.path.getsize(path) / 1e6
            os.remove(path)
            a_d, want = a.to(s.dev), s.path_launches[orig]
            c_ref = nt.spgemm_numeric(plan.to(s.dev), a_d, a_d)
            loaded_d = loaded.to(s.dev)
            c = s.counted(lambda: nt.spgemm_numeric(loaded_d, a_d, a_d),
                          list(want), f"cache-{name}", exact=want)
            same = all(torch.equal(getattr(c, f), getattr(c_ref, f))
                       for f in ("rpt", "col", "val"))
            counts = s.path_launches[f"cache-{name}"] == want
            print(f"plan cache {name}: {plan.layout} layout, {mb:.1f} MB, "
                  f"save {t_save:.2f} s, load {t_load:.2f} s (host, tables "
                  f"checked); C equal to the unsaved plan's (torch.equal): "
                  f"{same}; launches equal to {orig}'s: {counts}",
                  flush=True)
            if not same or not counts:
                fail(f"plan cache {name}: the loaded plan differs")
            del loaded, loaded_d, c, c_ref
        s.host_plans = {}

        a = nt.read_mtx(CIRCUIT, dtype=np.float32)
        a_d = a.to(s.dev)
        ref, scale = nt.spgemm_oracle(a, a), spgemm_abs_oracle(a, a)
        cdir = os.path.join(d, "circuit")
        for want_hit in (False, True):
            t0 = time.perf_counter()
            plan, hit = sc.spgemm_plan_cached(a, a, cdir)
            t_plan = time.perf_counter() - t0
            what = "cache-circuit-" + ("hit" if hit else "miss")
            if hit != want_hit or plan.layout != "sort":
                fail(f"circuit_zipf: hit {hit}, layout {plan.layout}")
            want = sort_launches(plan.srt)
            plan_d = plan.to(s.dev)
            c = s.counted(lambda: nt.spgemm_numeric(plan_d, a_d, a_d),
                          list(want), what, exact=want)
            ok = check_spgemm_answer_device(c, ref, abs_ref=scale)
            print(f"{what}: {os.listdir(cdir)}, plan {t_plan:.3f} s host, "
                  f"P {plan.n_products}, nnz(C) {plan.c_nnz}, launches "
                  f"{s.path_launches[what]}; C vs scipy on the card (rtol "
                  f"1e-5, |A||B| bound): {'pass' if ok else 'FAIL'}",
                  flush=True)
            if not ok or s.path_launches[what] != want:
                fail(f"{what}: C or launches wrong")


def cli_lines(argv) -> str:
    """Run the port's CLI in a subprocess on the card; its output, printed
    indented (fails the run on a non-zero exit)."""
    t0 = time.perf_counter()
    r = subprocess.run(
        [sys.executable, "-m", "nsparse_tpu_torch", "--precision", "single",
         *argv], cwd=ROOT, capture_output=True, text=True, timeout=600)
    print(f"cli: {' '.join(argv)} (rc {r.returncode}, "
          f"{time.perf_counter() - t0:.1f} s host)")
    for line in r.stdout.splitlines():
        print(f"  {line}")
    if r.returncode:
        print(r.stderr[-4000:], file=sys.stderr)
        fail(f"cli {argv[0]} exited {r.returncode}")
    return r.stdout


def cli_phase(s: Smoke) -> None:
    """The CLI on the card: ``spgemm --plan-cache`` twice on circuit_zipf
    (a miss, then ``[cache hit]``, both pass), ``spmv --profile`` on the
    2048 x 2048 stencil as DIA (a trace with a CUDA kernel event),
    ``spmv-xla`` and ``spgemm-xla`` (the library yardsticks); then
    ``time_chained`` and ``time_marginal`` of the stencil DIA SpMV beside
    ``time_cuda``."""
    torch, nt = s.torch, s.nt
    from nsparse_tpu_torch.utils.timing import time_chained, time_marginal

    with tempfile.TemporaryDirectory() as d:
        outs = [cli_lines(["spgemm", CIRCUIT, "--plan-cache", d, "--trials",
                           "5"]) for _ in range(2)]
        hits = ["[cache hit]" in o for o in outs]
        passed = [o.rstrip().endswith("pass") for o in outs]
        print(f"cli spgemm --plan-cache: cache hit {hits}, pass {passed}",
              flush=True)
        if hits != [False, True] or not all(passed):
            fail("cli spgemm --plan-cache: expected a miss, then a hit")
        tdir = os.path.join(d, "trace")
        cli_lines(["spmv", f"gen:stencil:{STENCIL}:{STENCIL}", "--format",
                   "dia", "--profile", tdir, "--trials", "21"])
        kernels = 0
        for path in glob.glob(os.path.join(tdir, "*.json")):
            with open(path) as f:
                kernels += sum(e.get("cat") == "kernel"
                               for e in json.load(f)["traceEvents"])
        print(f"cli spmv --profile: {kernels} CUDA kernel events in the "
              "trace", flush=True)
        if not kernels:
            fail("cli spmv --profile: no CUDA kernel event in the trace")
    cli_lines(["spmv-xla", CIRCUIT, "--trials", "21"])
    cli_lines(["spgemm-xla", CIRCUIT, "--trials", "5"])

    a = nt.stencil_csr(STENCIL, STENCIL, dtype=np.float32)
    dia = nt.DIA.from_csr(a)
    # scaled by 1/8: the chained products stay bounded
    dia = dataclasses.replace(dia, vals=dia.vals / 8).to(s.dev)
    x = torch.ones(a.shape[1], dtype=torch.float32, device=s.dev)
    ms = {
        "time_cuda": s.time_cuda(lambda: nt.spmv(dia, x), trials=TRIALS),
        "time_chained": time_chained(lambda c, i: nt.spmv(dia, c), x),
        "time_marginal": time_marginal(lambda c, i: nt.spmv(dia, c), x),
    }
    print(f"stencil DIA SpMV [{s.name}, {s.card}]: "
          + "  ".join(f"{k} {v:.4f} ms" for k, v in ms.items()), flush=True)
    if not all(np.isfinite(v) and v >= 0 for v in ms.values()):
        fail(f"timing helpers: {ms}")


def kfold_phase(s: Smoke) -> None:
    """K4's K-fold mode alone (no path of either package calls it): runs
    of 1-KFOLD_RUN_MAX values, grouped by K = 1, 2, 4, 8, sub-run strides
    of the run length plus 0-8, at least KFOLD_OUT output values; equal to
    its plain version bit for bit; float64 values refused."""
    torch = s.torch
    from nsparse_tpu_torch.ops.kernels import runcopy

    rng = np.random.default_rng(SEED)
    src_off, lens, kfac, stride = [], [], [], []
    cursor = 0
    for k in (1, 2, 4, 8):
        out = 0
        while out < KFOLD_OUT // 4:
            ln = int(rng.integers(1, KFOLD_RUN_MAX + 1))
            st = ln + int(rng.integers(0, 9))
            src_off.append(cursor)
            lens.append(ln)
            kfac.append(k)
            stride.append(st)
            cursor += st * k + int(rng.integers(0, 33))
            out += ln
    plan, _ = host_timed("K-fold plan", lambda: runcopy.build_runcopy_plan(
        src_off, lens, cursor, kfac=kfac, stride=stride))
    gen = torch.Generator(device=s.dev).manual_seed(SEED)
    src = torch.randn(cursor, generator=gen, device=s.dev)
    plan_d = plan.to(s.dev)
    print(f"runcopy-kfold: {plan.n_runs} runs, {sum(lens)} values out of "
          f"{plan.n_out} slots, source {cursor} values", flush=True)
    out = s.counted(lambda: runcopy.runcopy(plan_d, src), ["runcopy_kfold"],
                    "runcopy-kfold")
    if s.path_launches["runcopy-kfold"] != {"runcopy_kfold": 1}:
        fail(f"runcopy-kfold launches {s.path_launches['runcopy-kfold']}")
    ok = torch.equal(out, runcopy.runcopy_kfold_plain(plan_d, src))
    print(f"runcopy-kfold: equal to its plain version (torch.equal): "
          f"{'pass' if ok else 'FAIL'}", flush=True)
    if not ok:
        fail("K4's K-fold mode differs from its plain version")
    try:
        runcopy.runcopy(plan_d, src.double())
        fail("K4's K-fold mode took float64 values")
    except NotImplementedError as e:
        print(f"runcopy-kfold: float64 refused, as in JAX ({e})", flush=True)
    s.calls["runcopy_kfold"].append(("runcopy-kfold", (plan_d, src)))


def gather_kernels(plans) -> set:
    """The kernels ``flat_gather`` must launch for these plans: K5 for
    class subsets, K1 and K6 for fallback tiles."""
    need = set()
    if k5_launches(plans):
        need.add("gather_subset")
    if any(p.fb_ids.numel() for p in plans):
        need |= {"gather", "scatter_tiles"}
    return need


def k5_launches(plans) -> int:
    """K5's launches in one ``flat_gather`` per plan: one for each plan
    with class units, whatever its number of classes."""
    return sum(1 for p in plans if p.units.numel())


def spmv_phases(s: Smoke) -> None:
    torch, nt = s.torch, s.nt
    from nsparse_tpu_torch.tune.plan import Plan

    def x_for(n, dtype):
        return torch.from_numpy(
            np.random.default_rng(0).standard_normal(n).astype(dtype))

    # irregular: Graph500-style R-MAT, the bench's ELL geometry
    a = host_timed(f"generate R-MAT-{RMAT_SCALE}", lambda: nt.rmat_csr(
        RMAT_SCALE, RMAT_EF, dtype=np.float32, seed=RMAT_SEED))
    deg = a.rpt.diff()
    print(f"R-MAT-{RMAT_SCALE}: {a.shape[0]} rows, nnz {a.nnz}, max degree "
          f"{int(deg.max())}, empty rows {int((deg == 0).sum())}")
    geom = dict(min_width=2, max_slabs=10, sigma=1024)
    ell_x = host_timed("ELL with x-shuffle", lambda: nt.ELL.from_csr(
        a, xshuffle=True, **geom))
    ell_d = host_timed("ELL direct", lambda: nt.ELL.from_csr(
        a, xshuffle=False, **geom))
    fb = sum(g.class_fracs["fallback"] * v.numel()
             for g, v in zip(ell_d.cols_gp, ell_d.vals)) / ell_d.padded_nnz
    print(f"ELL: widths {ell_d.widths}, {ell_d.padded_nnz} slots, "
          f"fallback share of x tiles {fb:.4f}; x-shuffle plans: uniq "
          f"{ell_x.uniq_cols_gp.class_fracs}, fill "
          f"{ell_x.xfill_gp.class_fracs}, pos {ell_x.pos_gp.class_fracs}")
    x = x_for(a.shape[1], np.float32)
    ell_x_d = host_timed("ELL x-shuffle to the card", lambda: ell_x.to(s.dev))
    s.spmv_path(f"rmat{RMAT_SCALE}-ell-xshuffle", a, ell_x_d, x,
                ELL_KERNELS, np.float32, ELL_LAUNCHES)
    s.spmv_path(f"rmat{RMAT_SCALE}-ell-direct", a, ell_d.to(s.dev), x,
                ELL_KERNELS, np.float32, ELL_LAUNCHES)
    del ell_d
    x_d = x.to(s.dev)
    profile_calls(torch, lambda: nt.spmv(ell_x_d, x_d), "ELL x-shuffle SpMV")

    # f64 re-run of the x-shuffle ELL (same plans, values in f64)
    a64 = a.with_values(a.val.double())
    ell64 = dataclasses.replace(
        ell_x_d, vals=tuple(v.double() for v in ell_x_d.vals))
    s.spmv_path(f"rmat{RMAT_SCALE}-ell-xshuffle-f64", a64, ell64,
                x_for(a.shape[1], np.float64), ELL_KERNELS, np.float64,
                ELL_LAUNCHES)
    del ell_x, ell_x_d, ell64, a64, a

    # banded: 5-point stencil as DIA and as row-ordered ELL
    a = host_timed(f"generate stencil {STENCIL}x{STENCIL}",
              lambda: nt.stencil_csr(STENCIL, STENCIL, dtype=np.float32))
    dia = host_timed("DIA", lambda: nt.DIA.from_csr(a))
    print(f"stencil: {a.shape[0]} rows, nnz {a.nnz}, offsets {dia.offsets}")
    x = x_for(a.shape[1], np.float32)
    s.spmv_path("stencil-dia", a, dia.to(s.dev), x, ["spmv_dia"], np.float32)
    ell = host_timed("ELL sigma 0", lambda: nt.ELL.from_csr(a, sigma=0))
    s.spmv_path("stencil-ell-sigma0", a, ell.to(s.dev), x, ELL_KERNELS,
                np.float32, ELL_LAUNCHES)
    del ell
    a64 = a.with_values(a.val.double())
    s.spmv_path("stencil-dia-f64", a64,
                dataclasses.replace(dia, vals=dia.vals.double()).to(s.dev),
                x_for(a.shape[1], np.float64), ["spmv_dia"], np.float64)

    # the --format auto path: the tuner in model mode, with the bench's
    # banded candidate list (bench.py's banded stage)
    cands = [Plan(format="dia"), Plan(format="ell", sigma=0),
             Plan(format="csr")]
    fmt, plan = host_timed("autotune (model mode)", lambda: nt.autotune_spmv(
        a, x, candidates=cands, measure=False, device=s.dev))
    print(f"tuner chose {plan.format} ({plan.memory_bytes} B)")
    y = s.counted(lambda: nt.spmv(fmt, x.to(s.dev)),
                  ["spmv_dia"] if plan.format == "dia" else [], "tuner")
    ok, nf = nt.ans_check(y, nt.spmv_oracle(a, x), dtype=np.float32,
                          scale=nt.spmv_abs_oracle(a, x))
    print(f"tuner: y vs scipy {'pass' if ok else 'FAIL'}")
    if not ok or plan.format != "dia":
        fail(f"tuner: format {plan.format}, {nf} mismatches")
    del a, a64, dia, fmt
    hpcg_dia_case(s)
    ell_cell_case(s)

    # FEM: dense 16-dof blocks as (128, 128) BSR tiles
    a = host_timed("generate FEM", lambda: nt.fem_block_csr(
        FEM["n_nodes"], dof=FEM["dof"], neighbors=FEM["neighbors"],
        bandwidth=FEM["bandwidth"], dtype=np.float32, seed=FEM["seed"]))
    bsr = host_timed("BSR (128, 128)", lambda: nt.BSR.from_csr(a, (128, 128)))
    print(f"FEM: {a.shape[0]} rows, nnz {a.nnz}, {bsr.nblocks} tiles, fill "
          f"{bsr.fill_ratio:.2f}, {bsr.data.numel() * 4} B of tiles")
    bsr_d = bsr.to(s.dev)
    s.spmv_path("fem-bsr128", a, bsr_d, x_for(a.shape[1], np.float32),
                ["spmv_bsr"], np.float32)
    precision_check(s, bsr_d)


def cell_graph(s: Smoke, config: str, seed: int):
    """Pattern 0 of a benchmark configuration (``bench_torch/configs``),
    made on the card by the benchmark's generator from ``seed``, as the
    port's CSR on the host (as the benchmark's entries hand it over)."""
    nt = s.nt
    bench = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "bench_torch")
    if bench not in sys.path:
        sys.path.insert(0, bench)
    import importlib

    with open(os.path.join(bench, "configs", f"{config}.json")) as f:
        cfg = json.load(f)
    gen = importlib.import_module(f"generators.{cfg['generator']}")
    g = gen.generate(cfg, 0, seed, s.dev)
    return nt.CSR(rpt=g.rpt.cpu(), col=g.col.cpu(), val=g.val.cpu(),
                  shape=g.shape, nnz=int(g.col.numel()))


def cell_traffic(name: str) -> dict:
    with open(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "bench_torch", "traffic", f"{name}.json")) as f:
        return json.load(f)


def _ncu_rates(ncu: str, kernel: str, script: str) -> tuple:
    """(rates, why not) of ``kernel`` in ``python3 -c script`` under
    Nsight Compute."""
    try:
        r = subprocess.run(
            [ncu, "--kernel-name", f"regex:{kernel}", "--launch-count", "1",
             "--metrics", "lts__t_sector_hit_rate.pct,"
             "l1tex__t_sector_hit_rate.pct", sys.executable, "-c", script],
            capture_output=True, text=True, timeout=300)
    except subprocess.TimeoutExpired:
        return [], "ncu ran past 300 s"
    rates = [ln.strip() for ln in r.stdout.splitlines()
             if "hit_rate" in ln]
    tail = (r.stdout + r.stderr).strip().splitlines()[-3:]
    return rates, f"ncu exit {r.returncode}, no rates: {tail}"


def hit_rates(kernel: str, script: str) -> str:
    """The L2 and L1 sector hit rates of ``kernel`` in ``python3 -c
    script`` by Nsight Compute, or why there are none.  A one-launch probe
    runs first, so that a machine where ncu cannot profile does not pay
    for ``script``."""
    ncu = shutil.which("ncu") or "/usr/local/cuda/bin/ncu"
    if not os.path.exists(ncu):
        return "Nsight Compute (ncu) is not on this machine: not measured"
    probe = "import torch; torch.ones(8, device='cuda').add_(1)"
    rates, why = _ncu_rates(ncu, ".", probe)
    if rates:
        rates, why = _ncu_rates(ncu, kernel, script)
    return "; ".join(rates) if rates else f"{why}: not measured"


def ell_cell_case(s: Smoke) -> None:
    """K14 at the ``g500-s21.spmv`` cell's shape: the cell's graph from
    the benchmark's generator (pattern 0, labels and weights from
    CELL_SEED) as an ELL of the cell's geometry (its x-shuffle plans left
    out: K14 reads none of them), float32.  One ``nt.spmv`` must make
    K14's two launches (``launch.nsp_spmv_ell_slabs`` and ``_rows`` 1
    each) and nothing else; y must equal K14's plain version and a second
    call's y bit for bit, and lie within the cell's ``y_gap`` limit of
    the float64 CSR product (|y - ref| / |A||x|).  Then timed by CUDA
    events, queued behind a sleep and by the profiler per launch, beside
    the CSR yardstick's bound and cuSPARSE's CSR SpMV (``torch.sparse``),
    and the L2 and L1 hit rates where Nsight Compute runs."""
    torch, nt = s.torch, s.nt
    from nsparse_tpu_torch.ops.kernels import spmv_ell as k14
    from nsparse_tpu_torch.utils import profiling

    tr = cell_traffic(CELL_TRAFFIC)
    what = f"{CELL_CONFIG}.{CELL_TRAFFIC} shape"
    a = host_timed(f"{what}: graph on the card",
                   lambda: cell_graph(s, CELL_CONFIG, CELL_SEED))
    geom = {k: v for k, v in tr["ell"].items() if k != "xshuffle"}
    ell = host_timed(f"{what}: ELL without x-shuffle plans", lambda:
                     nt.ELL.from_csr(a, xshuffle=False, **geom)).to(s.dev)
    rows = [v.shape[1] for v in ell.vals]
    live = [int(ln.sum()) for ln in ell.lens]
    n_split = 0 if ell.split_rows is None else ell.split_rows.numel()
    chunks = 0 if ell.split_slots is None else \
        int((ell.split_slots >= 0).sum())
    print(f"{what}: {a.shape[0]} rows, nnz {a.nnz}, {ell.padded_nnz} slots "
          f"({ell.padded_nnz / max(a.nnz, 1):.3f} a stored entry); slabs "
          f"(width, rows, entries): {list(zip(ell.widths, rows, live))}"
          f"; {n_split} split rows, {chunks} extra chunks", flush=True)
    x = torch.randn(a.shape[1], device=s.dev,
                    generator=torch.Generator(s.dev).manual_seed(CELL_SEED))
    profiling.reset()
    with profiling.recording():
        y = s.counted(lambda: nt.spmv(ell, x), ELL_KERNELS, what,
                      exact=ELL_LAUNCHES)
    counters = profiling.snapshot()["counters"]
    profiling.reset()
    want_c = {"launch.nsp_spmv_ell_slabs": 1, "launch.nsp_spmv_ell_rows": 1,
              "spmv.ell.k14": 1, "spmv.ell.k14.slots": ell.padded_nnz}
    launches = {k: v for k, v in counters.items() if k.startswith("launch.")}
    ok_c = all(counters.get(k) == v for k, v in want_c.items()) \
        and sum(launches.values()) == 2
    print(f"{what}: counters {counters}: {'pass' if ok_c else 'FAIL'}",
          flush=True)
    y2 = nt.spmv(ell, x)
    plain = k14.spmv_ell_plain(ell, x)
    same = torch.equal(y.view(torch.int32), y2.view(torch.int32))
    eq_plain = torch.equal(y, plain)
    del y2, plain
    a_d = a.to(s.dev)
    a64 = a_d.with_values(a_d.val.double())
    ref = nt.spmv_csr(a64, x.double())
    scale = nt.spmv_csr(a64.with_values(a64.val.abs()), x.double().abs())
    gap = float(((y.double() - ref).abs() / scale.clamp(min=1e-30)).max())
    limit = tr["limits"]["y_gap"]
    del ref, scale, a64
    ok = ok_c and same and eq_plain and gap <= limit \
        and bool(torch.isfinite(y).all())
    print(f"{what}: two calls equal bit for bit {same}; equal to the plain "
          f"version {eq_plain}; y_gap {gap:.3g} against the f64 CSR "
          f"(limit {limit:g}): {'pass' if ok else 'FAIL'}", flush=True)
    if not ok:
        fail(f"{what}: K14 counters, repeat, plain or y_gap check failed")

    def run():
        return nt.spmv(ell, x)

    ms = s.time_cuda(run, trials=TRIALS)
    queued = queued_device_ms(torch, run)
    dev = {k: profiled_device_ms(torch, run, k)
           for k in ("ell_slabs_kernel", "ell_rows_kernel")}
    nbytes = a.nnz * 8 + (a.shape[0] + 1) * 4 + sum(a.shape) * 4
    bound = nbytes / s.bw * 1e3
    dev_txt = ", ".join(f"{k} {fmt_ms(m)} ms ({n} recorded)"
                        for k, (m, n) in dev.items())
    csr = torch.sparse_csr_tensor(a_d.rpt.long(), a_d.col.long(), a_d.val,
                                  size=a.shape)
    lib_ms = s.time_cuda(lambda: csr @ x, trials=TRIALS)
    del csr
    print(f"{what} [{s.name}, {s.card}]: K14 {ms:.4f} ms a call by CUDA "
          f"events ({2 * a.nnz / ms / 1e6:.2f} GFLOP/s), {fmt_ms(queued)} "
          f"ms queued behind a sleep; by the profiler {dev_txt}; CSR bound "
          f"{bound:.4f} ms ({nbytes} B): {100 * bound / ms:.1f}% of it; "
          f"torch.sparse CSR @ x {lib_ms:.4f} ms", flush=True)
    s.record(run, what)
    here = os.path.dirname(os.path.abspath(__file__))
    script = (f"import sys; sys.path.insert(0, {here!r}); import torch, "
              "chip_smoke as cs; s = cs.Smoke(torch, ''); "
              "s.cuda_lib.KERNELS.get(); cs.ell_cell_hot(s)")
    print(f"{what}: K14 slabs kernel hit rates: "
          f"{hit_rates('ell_slabs_kernel', script)}", flush=True)


def ell_cell_hot(s: Smoke) -> None:
    """The cell-shape K14 call alone, for a profiler that starts this
    process (``hit_rates``)."""
    tr = cell_traffic(CELL_TRAFFIC)
    a = cell_graph(s, CELL_CONFIG, CELL_SEED)
    geom = {k: v for k, v in tr["ell"].items() if k != "xshuffle"}
    ell = s.nt.ELL.from_csr(a, xshuffle=False, **geom).to(s.dev)
    x = s.torch.randn(a.shape[1], device=s.dev)
    s.nt.spmv(ell, x)
    s.torch.cuda.synchronize()


def hpcg_diagonals(torch, n: int, dev):
    """(offsets, vals) of HPCG's 27-point operator on an n³ grid (x
    fastest) as the port's DIA holds it, in float64: 26 on the diagonal,
    -1 for each neighbour on the grid, 0 off it; rows padded to 128."""
    m = n ** 3
    vals = torch.zeros(27, -(-m // 128) * 128, dtype=torch.float64,
                       device=dev)
    i = torch.arange(n, device=dev)
    offsets = []
    for d, (dz, dy, dx) in enumerate(
            itertools.product((-1, 0, 1), repeat=3)):
        offsets.append(dx + n * dy + n * n * dz)
        oz, oy, ox = (((i + t) >= 0) & ((i + t) < n) for t in (dz, dy, dx))
        on = (oz[:, None, None] & oy[None, :, None] & ox[None, None, :])
        vals[d, :m] = on.reshape(-1) * (26.0 if d == 13 else -1.0)
    return tuple(offsets), vals


def hpcg_dia_case(s: Smoke) -> None:
    """K7 at the ``hpcg-256.spmv-dia`` cell's shape: ``nt.spmv`` on a DIA
    of HPCG's 27 diagonals at ``HPCG_DIA_GRID``³ in f64, one launch, held
    to ``spmv_dia_plain`` on the same x within 32 eps of |A||x| (each sum
    of 27 terms within about 27 u of it, in either order), then timed
    beside the bound of the stored diagonals, x and y."""
    torch, nt = s.torch, s.nt
    from nsparse_tpu_torch.ops.kernels.dia import spmv_dia_plain

    n = HPCG_DIA_GRID
    m = n ** 3
    what = f"hpcg-dia {n}^3 f64"
    offsets, vals = host_timed(f"{what}: diagonals on the card",
                               lambda: hpcg_diagonals(torch, n, s.dev))
    dia = nt.DIA(vals=vals, offsets=offsets, shape=(m, m),
                 nnz=int((vals != 0).sum()),
                 off_t=torch.tensor(offsets, dtype=torch.int32,
                                    device=s.dev))
    x = torch.randn(m, dtype=torch.float64, device=s.dev,
                    generator=torch.Generator(s.dev).manual_seed(0))
    y = s.counted(lambda: nt.spmv(dia, x), ["spmv_dia"], what,
                  exact={"spmv_dia": 1})
    want = spmv_dia_plain(vals, offsets, x, m)
    scale = spmv_dia_plain(vals.abs(), offsets, x.abs(), m)
    eps = torch.finfo(torch.float64).eps
    gap = float(((y - want).abs() / scale.clamp(min=1e-300)).max()) / eps
    ok = gap <= 32 and bool(torch.isfinite(y).all())
    del want, scale
    ms = s.time_cuda(lambda: nt.spmv(dia, x), trials=TRIALS)
    nbytes = (vals.numel() + 2 * m) * 8
    print(f"{what} [{s.name}, {s.card}]: nnz {dia.nnz}, K7 vs plain "
          f"{gap:.2f} eps of |A||x| (limit 32): {'pass' if ok else 'FAIL'}; "
          f"{ms:.4f} ms by CUDA events, {2 * dia.nnz / ms / 1e6:.2f} "
          f"GFLOP/s, bound {nbytes / s.bw * 1e3:.4f} ms ({nbytes} B)",
          flush=True)
    if not ok:
        fail(f"{what}: K7 differs from its plain version by {gap:.2f} eps "
             "of |A||x|")


def precision_check(s: Smoke, bsr_d) -> None:
    """With TF32 turned on by the caller, ``spmm`` and the plain BSR SpMV
    must still compute in full float32: both held against K8 at rtol 1e-6
    of |A||x| per column.  The unguarded einsum is shown beside them, to
    show what TF32 would have cost."""
    torch, nt = s.torch, s.nt
    from nsparse_tpu_torch.ops.kernels import spmv_bsr as k8

    cols = 4
    xs = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (bsr_d.shape[1], cols)).astype(np.float32)).to(s.dev)
    xcol = [xs[:, j].contiguous() for j in range(cols)]
    want = torch.stack([k8.spmv_bsr(bsr_d, xj) for xj in xcol], 1)
    abs_a = dataclasses.replace(bsr_d, data=bsr_d.data.abs())
    scale = torch.stack([k8.spmv_bsr_plain(abs_a, xj.abs()) for xj in xcol],
                        1).clamp(min=1e-30)
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        y_mm = nt.spmm(bsr_d, xs)
        y_pl = torch.stack([k8.spmv_bsr_plain(bsr_d, xj) for xj in xcol], 1)
        kept = torch.backends.cuda.matmul.allow_tf32
        br, bc = bsr_d.blocksize
        xp = torch.nn.functional.pad(xs, (0, 0, 0, -xs.shape[0] % bc))
        xg = xp.reshape(-1, bc, cols)[bsr_d.block_col.long()]
        y_raw = torch.zeros(bsr_d.n_block_rows, br, cols, device=s.dev)
        y_raw.index_add_(0, bsr_d.block_row.long(),
                         torch.einsum("krc,kcj->krj", bsr_d.data, xg))
        y_raw = y_raw.reshape(-1, cols)[: bsr_d.shape[0]]
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved
    rel = {name: float(((y - want).abs() / scale).max())
           for name, y in (("spmm", y_mm), ("plain spmv", y_pl),
                           ("unguarded einsum", y_raw))}
    ok = rel["spmm"] <= 1e-6 and rel["plain spmv"] <= 1e-6 and kept
    print(f"fem-bsr128 with TF32 allowed: max |err| / (|A||x|) vs K8 "
          f"{rel}; caller's setting kept {kept}: {'pass' if ok else 'FAIL'}",
          flush=True)
    if not ok:
        fail("BSR products lost full float32 precision under TF32")


def bsr_path(s: Smoke, path: str, a, plan_d, fn, expect,
             exact=None) -> None:
    """One block SpGEMM path: the counted run of ``fn`` (C as CSR; launch
    counts ``exact`` where given), the scipy check, a recorded run, and
    timings with the kernels, with the plain versions and as one cuSPARSE
    CSR SpGEMM."""
    torch, nt = s.torch, s.nt
    c = s.counted(fn, expect, path, exact)
    ok = nt.check_spgemm_answer(c, nt.spgemm_oracle(a, a), verbose=True,
                                abs_ref=nt.spgemm_abs_oracle(a, a))
    vals = c.val[: c.nnz]
    finite = bool(torch.isfinite(vals).all())
    rtol = 1e-5 if a.val.dtype == torch.float32 else 1e-8
    print(f"{path}: C vs scipy (rtol {rtol:g}, |A||B| bound): "
          f"{'pass' if ok else 'FAIL'}  finite {finite}", flush=True)
    if not ok or not finite:
        fail(f"{path}: C does not match the scipy oracle")
    s.record(fn, path)
    t = s.turns(fn)
    lib_ms = cusparse_spgemm_ms(s, a, path)
    ms = float(np.mean(t["kernels"]))
    tile_flops = 2 * plan_d.n_pairs * plan_d.bs ** 3
    vb = a.val.element_size()
    op_bound = tile_flops / TILE_PEAK_FLOPS[vb] * 1e3
    ffma = f"; {tile_flops / FFMA_PEAK * 1e3:.4f} ms at the FFMA peak" \
        if vb == 4 else ""
    print(f"{path} [{s.name}, {s.card}]: kernels {ms:.4f} ms "
          f"({t['kernels']})  plain {np.mean(t['plain']):.4f} ms "
          f"({t['plain']})  cuSPARSE CSR A @ A {fmt_ms(lib_ms)} ms  "
          f"{plan_d.flops / (ms * 1e-3) / 1e9:.2f} GFLOPS useful  "
          f"{tile_flops / (ms * 1e-3) / 1e12:.2f} TFLOP/s of tile products "
          f"(operation bound of the tile products {op_bound:.4f} ms"
          f"{' as 3xTF32' if vb == 4 else ' on DMMA'}{ffma})", flush=True)


def bsr_spgemm_phases(s: Smoke) -> None:
    """C = A @ A through dense tiles: FEM f32 (``spgemm_bsr``, then a
    value re-run through ``spgemm_bsr_numeric``), the TF32 check and a
    profile, then the bench's FEM in f64."""
    torch, nt = s.torch, s.nt
    from nsparse_tpu_torch.ops.spgemm_bsr import tile_products

    def plan_for(what, cfg, dtype, counts):
        a = host_timed(f"generate {what}", lambda: nt.fem_block_csr(
            cfg["n_nodes"], dof=cfg["dof"], neighbors=cfg["neighbors"],
            bandwidth=cfg["bandwidth"], dtype=dtype, seed=cfg["seed"]))
        path = nt.choose_spgemm_path(a, a)
        print(f"{what}: {a.shape[0]} rows, nnz {a.nnz}; choose_spgemm_path "
              f"-> {path} (block stats {nt.block_stats(a, a)})", flush=True)
        if path != "bsr":
            fail(f"choose_spgemm_path chose {path} on {what}, not bsr")
        plan = host_timed(f"plan_spgemm_bsr {what}",
                          lambda: nt.plan_spgemm_bsr(a, a))
        got = (len(plan.a_blocks) - 1, plan.n_pairs, plan.n_c_blocks,
               plan.flops // 2, plan.c_nnz)
        tile_mb = plan.bs ** 2 * plan.a_blocks.element_size() / 1e6
        print(f"{what}: A tiles {got[0]} ({got[0] * tile_mb:.0f} MB), block "
              f"pairs {got[1]}, C tiles {got[2]} ({got[2] * tile_mb:.0f} "
              f"MB), products P {got[3]}, nnz(C) {got[4]}, fill "
              f"{plan.fill:.2f}, "
              f"{2 * got[1] * plan.bs ** 3 / 1e9:.2f} GFLOP of tile "
              f"products; fill gather {plan.a_fill_gp.class_fracs}",
              flush=True)
        if any(w is not None and g != w for g, w in zip(got, counts)):
            fail(f"{what}: block plan counts {got}, expected {counts}")
        return a, plan

    a, plan = plan_for("FEM f32", FEM, np.float32, FEM_BSR)
    plan_d, a_d = plan.to(s.dev), a.to(s.dev)
    bsr_path(s, "fem-bsr-spgemm", a, plan_d,
             lambda: nt.spgemm_bsr(a_d, a_d, plan_d), ["spgemm_bsr_blocks"])

    # new values on the same plan: re-blockified on the card
    v2 = np.random.default_rng(FEM["seed"] + 1).standard_normal(a.nnz)
    a2 = a.with_values(torch.from_numpy(v2.astype(np.float32)))
    a2_d = a2.to(s.dev)

    def rerun():
        blocks = nt.spgemm_bsr_numeric(plan_d, a2_d, a2_d)
        return nt.CSR(rpt=plan_d.c_rpt, col=plan_d.c_col,
                      val=blocks.reshape(-1).index_select(0, plan_d.c_slot),
                      shape=plan_d.shape, nnz=plan_d.c_nnz)

    fills = [plan.a_fill_gp, plan.b_fill_gp]
    bsr_path(s, "fem-bsr-rerun", a2, plan_d, rerun,
             ["spgemm_bsr_blocks", *sorted(gather_kernels(fills))],
             {"gather_subset": k5_launches(fills)})
    bsr_precision_check(s, plan_d, tile_products)
    profile_calls(torch, lambda: nt.spgemm_bsr(a_d, a_d, plan_d),
                  "FEM block SpGEMM f32")
    del a2_d

    a64, plan64 = plan_for("FEM-512 f64", FEM_F64, np.float64, FEM_F64_BSR)
    p64_d, a64_d = plan64.to(s.dev), a64.to(s.dev)
    bsr_path(s, "fem512-bsr-spgemm-f64", a64, p64_d,
             lambda: nt.spgemm_bsr(a64_d, a64_d, p64_d),
             ["spgemm_bsr_blocks"])


def bsr_precision_check(s: Smoke, plan_d, tile_products) -> None:
    """With TF32 turned on by the caller, the plain tile products must
    still compute in full float32: held against the float64 products of
    the same tiles at 1e-6 of |A_tile||B_tile|.  K9 (``tile_products``)
    and the unguarded batched product are shown beside it, the latter to
    show what TF32 would have cost."""
    torch = s.torch
    from nsparse_tpu_torch.ops.kernels import bsr_blocks

    args = (plan_d.a_blocks, plan_d.b_blocks, plan_d.pair_a, plan_d.pair_b,
            plan_d.pair_c, plan_d.c_pair_start)
    plain_fn = bsr_blocks.spgemm_bsr_blocks_plain
    exact = plain_fn(args[0].double(), args[1].double(), *args[2:])
    scale = plain_fn(args[0].abs(), args[1].abs(), *args[2:]).clamp(
        min=1e-30)
    k9 = tile_products(plan_d)
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        plain = plain_fn(*args)
        kept = torch.backends.cuda.matmul.allow_tf32
        raw = torch.zeros_like(k9).index_add_(
            0, plan_d.pair_c.long(),
            torch.bmm(args[0][plan_d.pair_a.long()],
                      args[1][plan_d.pair_b.long()]))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved
    rel = {name: float(((y.double() - exact).abs() / scale).max())
           for name, y in (("plain tile products", plain),
                           ("K9 (3xTF32)", k9), ("unguarded bmm", raw))}
    del exact
    ok = rel["plain tile products"] <= 1e-6 and kept
    print(f"fem-bsr-spgemm with TF32 allowed: max |err| / (|A||B|) vs the "
          f"float64 tile products {rel}; caller's setting kept {kept}: "
          f"{'pass' if ok else 'FAIL'}", flush=True)
    if not ok:
        fail("block tile products lost full float32 precision under TF32")


def sector_floor_ms(s: Smoke, win, idx, window: int, piece: int) -> float:
    """The least time of a K10 call at the card's access granularity: the
    indices and outputs once each, and every distinct ``piece``-byte
    aligned piece of ``win`` (a 32-byte sector, a 64-byte burst) that a
    valid index names."""
    torch = s.torch
    j = idx.long()
    valid = (j >= 0) & (j < window)
    vb = win.element_size()
    rows = torch.arange(idx.shape[0], device=idx.device)[:, None]
    at = (rows * win.shape[1] + j) * vb + win.data_ptr() % piece
    pieces = int(torch.unique((at // piece)[valid]).numel())
    return (idx.numel() * (4 + vb) + pieces * piece) / s.bw * 1e3


def windowed_gather_phase(s: Smoke) -> None:
    """K10 alone, at WG_ROWS rows per case of WG_CASES: equal to its plain
    version bit for bit and to torch.gather on the in-window slots (the
    others 0), its route and its sector floors beside its bound, timed
    both ways."""
    torch = s.torch
    from nsparse_tpu_torch.ops.kernels import gather_tiles

    # trees before the route rule have one route, a thread per output
    route_of = getattr(gather_tiles, "windowed_gather_route", None)
    names = ("direct", "thread per output")
    for w, dtype, outside, misaligned in WG_CASES:
        rng = np.random.default_rng(w)
        win = torch.from_numpy(rng.standard_normal(
            (WG_ROWS, max(w, 128) + 2 * misaligned), dtype=dtype)).to(s.dev)
        lo, hi = (-(w // 4), w + w // 4) if outside else (0, w)
        flat = torch.from_numpy(rng.integers(
            lo, hi, WG_ROWS * 128 + misaligned).astype(np.int32)).to(s.dev)
        idx = flat[int(misaligned):].view(WG_ROWS, 128)
        if misaligned != bool(idx.data_ptr() % 16):
            fail(f"windowed gather w{w}: idx alignment is not the case's")
        path = (f"windowed-gather-w{w}"
                + ("-f64" if dtype == np.float64 else "")
                + ("-outside" if outside else "")
                + ("-misaligned" if misaligned else ""))

        def fn():
            return gather_tiles.windowed_gather(win, idx, w)

        out = s.counted(fn, ["windowed_gather"], path)
        j = idx.long()
        inside = (j >= 0) & (j < w)
        lib = torch.gather(win, 1, j.clamp(0, w - 1))
        ok = (torch.equal(out, gather_tiles.windowed_gather_plain(win, idx, w))
              and torch.equal(out[inside], lib[inside])
              and not bool(out[~inside].any()))
        route = "one (a thread per output)" if route_of is None else \
            names[route_of(w, win.element_size())]
        bound, _ = s.bound_ms("windowed_gather", (win, idx, w), out)
        print(f"{path}: route {route}; equal to its plain version and, on "
              f"the {int(inside.sum())} in-window slots, to torch.gather "
              f"(the {int((~inside).sum())} slots outside the window 0): "
              f"{'pass' if ok else 'FAIL'}; bound {bound:.4f} ms, 32-byte "
              f"sector floor {sector_floor_ms(s, win, idx, w, 32):.4f} ms, "
              f"64-byte {sector_floor_ms(s, win, idx, w, 64):.4f} ms",
              flush=True)
        if not ok:
            fail(f"{path}: K10 differs from its plain version or "
                 "torch.gather")
        s.record(fn, path)
        t = s.turns(fn)
        print(f"{path} [{s.name}, {s.card}]: kernels "
              f"{np.mean(t['kernels']):.4f} ms ({t['kernels']})  plain "
              f"{np.mean(t['plain']):.4f} ms ({t['plain']})", flush=True)


def profiled_device_ms(torch, fn, kernel: str, calls: int = 10):
    """(mean device ms of one launch of the kernel named ``kernel...``,
    launches recorded) as torch.profiler records ``calls`` calls of
    ``fn``, each of which launches it once, behind a device sleep; (None,
    0) when it records none in three windows (it drops device events on
    this card's machine, some windows all of them)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):  # a window in which it recorded none is retried
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            torch.cuda._sleep(SLEEP_CYCLES)
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        us = [e.time_range.elapsed_us() for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and short_name(e.name).startswith(kernel)]
        if us:
            return sum(us) / len(us) / 1e3, len(us)
    return None, 0


def queued_device_ms(torch, fn, calls: int = 20):
    """Device ms per call of ``fn``: CUDA events around ``calls`` calls
    queued behind a device sleep, so that the host has issued them all
    before the first one runs and the events time the device alone;
    None when the host took longer than the sleep."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    torch.cuda._sleep(SLEEP_CYCLES)
    stop.record()
    stop.synchronize()
    sleep_ms = start.elapsed_time(stop)
    torch.cuda._sleep(SLEEP_CYCLES)
    t0 = time.perf_counter()
    start.record()
    for _ in range(calls):
        fn()
    stop.record()
    host_ms = (time.perf_counter() - t0) * 1e3
    stop.synchronize()
    return start.elapsed_time(stop) / calls if host_ms < sleep_ms else None


def tile_copy_phase(s: Smoke) -> None:
    """K6 and K12, the two tile copies.  K6's scalar branch (a tile of
    1001 values, not whole 16-byte vectors; a ``dst`` view one element
    past its allocation, not 16-byte aligned) and its vector branch
    (CHECK_TILES tiles of 1024) held against its plain version with
    ``torch.equal`` in f32 and f64.  Then, where the paths have run, K6
    on the FEM value re-run's calls, the vector branch timed by CUDA
    events, by the profiler's device time and queued behind a device
    sleep, beside its bound, and the scalar branch on the same values
    (``vals`` one element past an aligned allocation); and K12 on
    R-MAT-14's call, the same three ways."""
    torch = s.torch
    from nsparse_tpu_torch.ops.kernels import gather_tiles as gt

    rng = np.random.default_rng(SEED)
    for dtype in (torch.float32, torch.float64):
        for what, tile, n_dst, shift in (
                ("scalar branch, tile 1001", 1001, 40, 0),
                ("scalar branch, dst one element off", 1024, 40, 1),
                ("vector branch", 1024, 2 * CHECK_TILES, 0)):
            n_ids = n_dst // 2
            ids = torch.from_numpy(rng.permutation(n_dst)[:n_ids].astype(
                np.int32)).to(s.dev)
            vals = torch.randn(n_ids * tile, dtype=dtype, device=s.dev)
            dst = torch.randn(n_dst * tile + shift, dtype=dtype,
                              device=s.dev)[shift:]
            want = gt.scatter_tiles_plain(dst.clone(), ids, vals, tile)
            ok = torch.equal(gt.scatter_tiles(dst, ids, vals, tile), want)
            print(f"K6 {what}, {n_ids} tiles, {dtype}: equal to its plain "
                  f"version: {'pass' if ok else 'FAIL'}", flush=True)
            if not ok:
                fail(f"K6 {what} ({dtype}) differs from its plain version")

    calls = [s.fresh("scatter_tiles", a) for p, a in s.calls["scatter_tiles"]
             if p == "fem-bsr-rerun"]
    if calls:
        shifted = []
        for dst, ids, vals, tile in calls:
            v = torch.empty(vals.numel() + 1, dtype=vals.dtype,
                            device=s.dev)[1:]
            v.copy_(vals)
            shifted.append((dst, ids, v, tile))

        def run(arglists):
            for args in arglists:
                gt.scatter_tiles(*args)

        bound = sum(s.bound_ms("scatter_tiles", a, a[0])[0] for a in calls)
        t = {"vector": [], "scalar": []}
        for mode in ("scalar", "vector", "vector", "scalar"):
            lists = calls if mode == "vector" else shifted
            t[mode].append(s.time_cuda(lambda: run(lists), trials=TRIALS))
        vec_ms, sc_ms = float(np.mean(t["vector"])), float(np.mean(t["scalar"]))

        def device_ms(arglists, kernel):
            """Device ms of one pass (the per-launch means of each call,
            summed) and the launches the profiler recorded per call."""
            got = [profiled_device_ms(torch, lambda a=a: gt.scatter_tiles(*a),
                                      kernel) for a in arglists]
            ms = None if any(m is None for m, _ in got) \
                else sum(m for m, _ in got)
            return ms, [n for _, n in got]

        dev_ms, rec = device_ms(calls, "scatter_tiles_vec_kernel")
        dev_sc, rec_sc = device_ms(shifted, "scatter_tiles_kernel")
        queued = queued_device_ms(torch, lambda: run(calls))

        def share(ms):
            return "not measured" if ms is None else f"{100 * bound / ms:.1f}%"

        print(f"K6 on fem-bsr-rerun [{s.name}, {s.card}]: vector branch "
              f"{vec_ms:.4f} ms by CUDA events ({t['vector']}), "
              f"{fmt_ms(dev_ms)} ms device time by torch.profiler "
              f"(launches recorded per call, of 10: {rec}), "
              f"{fmt_ms(queued)} ms queued behind a sleep; bound "
              f"{bound:.4f} ms: {share(vec_ms)} of it by events, "
              f"{share(dev_ms)} by the profiler's device time, "
              f"{share(queued)} queued; scalar branch on the same values "
              f"{sc_ms:.4f} ms by events ({t['scalar']}), {fmt_ms(dev_sc)} "
              f"ms device time (recorded {rec_sc})", flush=True)

    calls = [a for p, a in s.calls["gather_tiles8"] if p == "spgemm"]
    if calls:
        src, ids = calls[0]
        ev_ms = s.time_cuda(lambda: gt.gather_tiles8(src, ids), trials=TRIALS)
        dev_ms, rec = profiled_device_ms(
            torch, lambda: gt.gather_tiles8(src, ids), "gather_tiles8_kernel")
        queued = queued_device_ms(torch, lambda: gt.gather_tiles8(src, ids))
        bound = s.bound_ms("gather_tiles8", (src, ids),
                           gt.gather_tiles8_plain(src, ids))[0]
        print(f"K12 on spgemm [{s.name}, {s.card}]: {ev_ms:.4f} ms by CUDA "
              f"events, {fmt_ms(dev_ms)} ms device time by torch.profiler "
              f"(launches recorded, of 10: {rec}), {fmt_ms(queued)} ms "
              f"queued behind a sleep; bound {bound:.4f} ms", flush=True)


def measure_calls(s: Smoke, k: str, label: str, calls, kernel: str,
                  lib_name=None) -> None:
    """One pass over ``calls`` of kernel ``k`` (each launches the device
    kernel named ``kernel...`` once): CUDA events, the profiler's device
    time (per-launch means, summed), queued behind a sleep; its bound and
    the share of it each reaches, and its library call by events and
    queued (``lib_name``; None: no library call).  Returns (events ms,
    profiler ms or None, queued ms or None, bound ms)."""
    torch = s.torch
    arglists = [s.fresh(k, a) for a in calls]
    w = s.wrappers[k]

    def run():
        for a in arglists:
            w(*a)

    ev_ms = s.time_cuda(run, trials=TRIALS)
    got = [profiled_device_ms(torch, lambda a=a: w(*a), kernel)
           for a in arglists]
    dev_ms = None if any(m is None for m, _ in got) \
        else sum(m for m, _ in got)
    queued = queued_device_ms(torch, run)
    bound = sum(s.bound_ms(k, a, s.run(k, s.plain[k], a))[0] for a in calls)

    def share(ms):
        return "not measured" if ms is None else f"{100 * bound / ms:.1f}%"

    lib_txt = ""
    if lib_name:
        lib = [s.library_call(k, a) for a in calls]

        def run_lib():
            for f in lib:
                f()

        lib_txt = (f"; {lib_name} {s.time_cuda(run_lib, trials=TRIALS):.4f} "
                   f"ms by CUDA events, "
                   f"{fmt_ms(queued_device_ms(torch, run_lib))} ms queued")
    print(f"{label} [{s.name}, {s.card}]: {len(calls)} call(s), "
          f"{ev_ms:.4f} ms by CUDA events, {fmt_ms(dev_ms)} ms device "
          f"time by torch.profiler (launches recorded per call, of 10: "
          f"{[m for _, m in got]}), {fmt_ms(queued)} ms queued behind a "
          f"sleep; bound {bound:.4f} ms: {share(ev_ms)} by events, "
          f"{share(dev_ms)} by the profiler, {share(queued)} queued"
          f"{lib_txt}", flush=True)
    return ev_ms, dev_ms, queued, bound


def bank_subset_phase(s: Smoke) -> None:
    """K11 build_bank and K5 gather_subset.  Each branch held against its
    plain version with ``torch.equal`` in f32 and f64: K11's vector branch
    on a 16-copy bank whose table runs to the bank's end (the copies'
    tails wrap into the BIAS zeros) and on one copy (the flat table), its
    scalar branch (``b8_idx`` one element off 16-byte alignment), and a
    table that ends inside a vector; K5's vector branch with an ``other``
    shorter than the slots and without one, and its scalar branch (an
    ``out`` view one element off, a unit of 1001 slots).  Then, where the
    paths have run, K11 on the v2 path's call and K5 on the FEM value
    re-run's calls, by CUDA events, by the profiler's device time and
    queued behind a device sleep, beside their bounds and library
    calls."""
    torch = s.torch
    from nsparse_tpu_torch.ops.kernels import gather_tiles as gt
    from nsparse_tpu_torch.ops.kernels import piecewise as pw

    def check(what, got, want):
        ok = torch.equal(got, want)
        print(f"{what}: equal to its plain version: "
              f"{'pass' if ok else 'FAIL'}", flush=True)
        if not ok:
            fail(f"{what} differs from its plain version")

    rng = np.random.default_rng(SEED)
    rows, n_b = 64, 5000
    n = rows * 128
    for dtype in (torch.float32, torch.float64):
        b_val = torch.randn(n_b, dtype=dtype, device=s.dev)
        for what, length, copies, shift in (
                ("vector branch, 16 copies, table to the bank's end",
                 n - pw.BIAS, pw.BANK_K, 0),
                ("vector branch, 1 copy (the flat table)", n - pw.BIAS, 1, 0),
                ("scalar branch, b8_idx one element off", n - pw.BIAS,
                 pw.BANK_K, 1),
                ("a table ending inside a vector", n - pw.BIAS - 3,
                 pw.BANK_K, 0)):
            # -1 and indices past b_val read 0
            b8 = torch.from_numpy(rng.integers(
                -1, n_b + 8, length + shift).astype(np.int32)).to(
                    s.dev)[shift:]
            check(f"K11 {what}, {dtype}",
                  pw.build_bank(b8, rows, b_val, copies),
                  pw.build_bank_plain(b8, rows, b_val, copies))

    n_units, n_src = 12, 100_000
    for dtype in (torch.float32, torch.float64):
        src = torch.randn(n_src, dtype=dtype, device=s.dev)
        # the last unit is listed: `other` ends inside it
        ids = torch.from_numpy(np.append(
            rng.permutation(n_units - 1)[:6], n_units - 1).astype(
                np.int32)).to(s.dev)
        for what, unit, shift, with_other in (
                ("vector branch, other shorter than the slots", 8192, 0, True),
                ("vector branch, no other", 8192, 0, False),
                ("scalar branch, out one element off", 8192, 1, True),
                ("scalar branch, a unit of 1001 slots", 1001, 0, True)):
            slots = unit * n_units
            idx = torch.from_numpy(rng.integers(
                -3, n_src + 3, slots).astype(np.int32)).to(s.dev)
            other = torch.randn(slots - unit // 2 - 1, dtype=dtype,
                                device=s.dev) if with_other else None
            out = torch.randn(slots + shift, dtype=dtype, device=s.dev)
            got, want = out.clone()[shift:], out.clone()[shift:]
            gt.gather_subset(src, idx, ids, unit, got, other)
            gt.gather_subset_plain(src, idx, ids, unit, want, other)
            check(f"K5 {what}, {dtype}", got, want)

    calls = [a for p, a in s.calls["build_bank"] if p == "spgemm"]
    if calls:
        measure_calls(s, "build_bank", "K11 on spgemm", calls,
                      "build_bank_kernel", "b_val[idx]")
    calls = [a for p, a in s.calls["gather_subset"] if p == "fem-bsr-rerun"]
    if calls:
        measure_calls(s, "gather_subset", "K5 on fem-bsr-rerun", calls,
                      "gather_subset", "src[idx]")


def sass_counts(source: str) -> dict:
    """How many HMMA and DMMA (tensor-core) instructions the built library
    of ``csrc/<source>.cu`` holds, from ``cuobjdump --dump-sass``."""
    from nsparse_tpu_torch.buildlib import BUILD_DIR
    from nsparse_tpu_torch.ops.kernels.cuda_lib import nvcc

    lib = glob.glob(os.path.join(BUILD_DIR, f"libnsparse_{source}-*.so"))
    tool = os.path.join(os.path.dirname(nvcc()), "cuobjdump")
    if not lib or not os.path.exists(tool):
        fail(f"no built {source} library or no cuobjdump ({lib}, {tool})")
    sass = subprocess.run([tool, "--dump-sass", lib[0]], capture_output=True,
                          text=True, timeout=120, check=True).stdout
    return {n: len(re.findall(rf"\b{n}\.", sass)) for n in ("HMMA", "DMMA")}


def k9_phase(s: Smoke, sass: bool = True) -> None:
    """K9 spgemm_bsr_blocks.  The HMMA and DMMA instructions of its built
    library (``sass``: fail if either is missing).  Synthetic tiles at bs
    64, 128, 192 and 256 (both sub-tile branches; C tiles without pairs
    among them), f32 and f64, held against the plain version at rtol 1e-5
    (f32) / 1e-8 (f64) of |A_tile||B_tile|, with K9's and the plain
    version's largest errors against the float64 products.  Then, where
    the block paths have run, each of their K9 calls: the same errors, its
    device time by CUDA events, by the profiler and queued behind a sleep
    beside its bound, the plain version, and one ``torch.bmm`` of the
    pre-gathered pairs (cuBLAS on these tile shapes, without the gather and
    the sum: a different function, so no library column)."""
    torch = s.torch
    from nsparse_tpu_torch.ops.kernels import bsr_blocks
    from nsparse_tpu_torch.utils.device import highest_matmul_precision

    k, w, plain = ("spgemm_bsr_blocks", bsr_blocks.spgemm_bsr_blocks,
                   bsr_blocks.spgemm_bsr_blocks_plain)
    got = sass_counts("spgemm_bsr")
    print(f"K9 SASS (cuobjdump of the built library): {got}", flush=True)
    if sass and not all(got.values()):
        fail(f"K9's library lacks tensor-core instructions: {got}")

    def errors(args, out):
        """Max |err| / (|A||B|) of ``out`` and of the plain version against
        the float64 products; the plain version's output."""
        a, b, *rest = args
        want = plain(*args)
        exact = plain(a.double(), b.double(), *rest)
        scale = plain(a.abs(), b.abs(), *rest).double().clamp(min=1e-300)
        rel = [float(((y.double() - exact).abs() / scale).max())
               for y in (out, want)]
        return rel, want

    for dtype in (torch.float32, torch.float64):
        for bs, n_t, n_c in K9_SYNTH:
            rng = np.random.default_rng(bs)
            counts = rng.integers(1, 5, n_c)
            counts[1] = counts[-1] = 0  # C tiles without pairs
            n_p = int(counts.sum())
            tiles = [torch.from_numpy(rng.standard_normal(
                (n_t, bs, bs))).to(s.dev, dtype) for _ in range(2)]
            i32 = [torch.from_numpy(x.astype(np.int32)).to(s.dev) for x in (
                rng.integers(0, n_t, n_p), rng.integers(0, n_t, n_p),
                np.repeat(np.arange(n_c), counts),
                np.concatenate([[0], np.cumsum(counts)]))]
            args = (*tiles, *i32)
            out = w(*args)
            (e_k9, e_pl), want = errors(args, out)
            ok = not bool(((out - want).abs() > s.tolerance(k, args)).any())
            print(f"K9 bs {bs} ({128 if bs % 128 == 0 else 64}-wide "
                  f"sub-tiles), {n_p} pairs on {n_c} C tiles, {dtype}: "
                  f"within rtol of the plain version: "
                  f"{'pass' if ok else 'FAIL'}; max |err| / (|A||B|) vs "
                  f"float64: K9 {e_k9:.3g}, plain {e_pl:.3g}", flush=True)
            if not ok:
                fail(f"K9 at bs {bs} ({dtype}) differs from its plain version")

    seen = set()
    for path, args in s.calls[k]:
        if path in seen:
            continue
        seen.add(path)
        out = w(*args)
        (e_k9, e_pl), _ = errors(args, out)
        a, b, pa, pb = args[:4]
        flops = 2.0 * pa.numel() * a.shape[-1] ** 3
        plain_ms = s.time_cuda(lambda: plain(*args), trials=5)
        ag, bg = a[pa.long()], b[pb.long()]
        with highest_matmul_precision():
            bmm_ms = s.time_cuda(lambda: torch.bmm(ag, bg), trials=5)
        del ag, bg
        print(f"K9 on {path}: {pa.numel()} pairs, {out.dtype}: max |err| / "
              f"(|A||B|) vs float64 K9 {e_k9:.3g}, plain {e_pl:.3g}; plain "
              f"version {plain_ms:.4f} ms; cuBLAS reference [{s.name}, "
              f"{s.card}]: one torch.bmm of the pre-gathered pairs in full "
              f"{out.dtype} (no gather, no sum) {bmm_ms:.4f} ms, "
              f"{flops / (bmm_ms * 1e-3) / 1e12:.2f} TFLOP/s", flush=True)
        torch.cuda.empty_cache()
        measure_calls(s, k, f"K9 on {path}", [args], "spgemm_bsr_kernel")


def k1_phase(s: Smoke) -> None:
    """K1 gather.  Its vector branch (16-byte aligned ``idx`` and ``out``,
    K1_CHECK[0] outputs, not a multiple of 4) and its scalar branch (an
    ``idx`` view and an ``out`` view one element off alignment) held
    against ``gather_plain`` with ``torch.equal`` in f32 and f64, indices
    negative and past the end of x among them."""
    torch, cl = s.torch, s.cuda_lib
    from nsparse_tpu_torch.ops.kernels import shuffle

    def check(what, got, want):
        ok = torch.equal(got, want)
        print(f"K1 {what}: equal to gather_plain: {'pass' if ok else 'FAIL'}",
              flush=True)
        if not ok:
            fail(f"K1 {what} differs from gather_plain")

    n, n_x = K1_CHECK
    rng = np.random.default_rng(SEED)
    for dtype in (torch.float32, torch.float64):
        x = torch.randn(n_x, dtype=dtype, device=s.dev)
        raw = torch.from_numpy(rng.integers(-5, n_x + 5, n + 1).astype(
            np.int32)).to(s.dev)
        idx = raw[:n]
        want = shuffle.gather_plain(x, idx)
        check(f"vector branch, {n} outputs, {dtype}", shuffle.gather(x, idx),
              want)
        check(f"vector branch, 3 outputs (the tail alone), {dtype}",
              shuffle.gather(x, idx[:3]), want[:3])
        # an idx view one element off 16-byte alignment
        check(f"scalar branch, idx one element off, {dtype}",
              shuffle.gather(x, raw[1:]), shuffle.gather_plain(x, raw[1:]))
        # an out view one element off (the wrapper allocates its own out)
        out = torch.full((n + 1,), 7.0, dtype=dtype, device=s.dev)[1:]
        cl.launch("gather", "nsp_gather", x, n_x, idx, out, n)
        check(f"scalar branch, out one element off, {dtype}", out, want)


def to_f64(torch, args):
    """A recorded call's arguments with every float tensor in float64."""
    return [x.double() if isinstance(x, torch.Tensor)
            and x.is_floating_point() else x for x in args]


def k3_geometry(s: Smoke, plan, dtype) -> str:
    """How K3 runs a class on this card: blocks per window (a cluster when
    more than one), threads, shared memory, resident blocks per SM, and
    whether it takes global scratch.  A tree whose K3 predates the query
    (one 512-thread block per window, its pyramid in shared memory or in
    global scratch past the opt-in limit) gets its rule's numbers."""
    torch = s.torch
    geo = getattr(s.window_fused, "launch_geometry", None)
    if geo is not None:
        g = geo(plan, dtype)
        return (f"{g['cluster']} block(s) per window x {g['threads']} "
                f"threads, {g['smem']} B shared, {g['blocks_per_sm']} "
                "blocks per SM, scratch no")
    el = torch.empty(0, dtype=dtype).element_size()
    need = plan.pyr_len * el + (256 * (12 + el) if plan.expand else 0)
    optin = torch.cuda.get_device_properties(0).shared_memory_per_block_optin
    scratch = need > optin
    return (f"1 block(s) per window x 512 threads, "
            f"{0 if scratch else plan.pyr_len * el} B shared, blocks per "
            f"SM not measured, scratch {'yes' if scratch else 'no'}")


def k3_k2_phase(s: Smoke) -> None:
    """K3 (both modes) and K2's piece modes on the calls the SpGEMM paths
    gave them.  K3 per class, v2 on the v2 path and v1 on the v1 path:
    width, windows, its launch geometry in f32 and f64 (blocks per window,
    threads, shared memory, blocks per SM, global scratch), equal to its
    plain version in float64 (``torch.equal``; the kernel table holds the
    float32 calls), and its device time by CUDA events, torch.profiler
    and queued behind a sleep, beside its bound and the bound of the
    earlier design's tables; then each form summed.  K2 per path and mode
    (the v2 fallback pool and the global layout: piece mode; R-MAT-16:
    flat mode) the same way."""
    torch = s.torch

    def equal64(k, args):
        a64 = to_f64(torch, args)
        if not torch.equal(s.run(k, s.wrappers[k], a64),
                           s.run(k, s.plain[k], a64)):
            fail(f"{k} differs from its plain version in float64")

    for k, path in (("fused_class_v2", "spgemm"),
                    ("fused_class", "spgemm-v1")):
        calls = [a for p, a in s.calls[k] if p == path]
        tot = np.zeros(4)
        old = 0.0
        for args in calls:
            plan = args[0]
            equal64(k, args)
            old_ms = k3_bytes(s, k, args, s.plain[k](*args), old_rule=True) \
                / s.bw * 1e3
            old += old_ms
            got = measure_calls(
                s, k, f"K3 on {path}, class W={plan.w}: {plan.n_win} "
                f"windows, {plan.slots} slots, lv {plan.lv}, "
                f"{len(plan.tier_vs)} tiers; f32: "
                f"{k3_geometry(s, plan, torch.float32)}; f64: "
                f"{k3_geometry(s, plan, torch.float64)}; equal to its plain "
                f"version in f64; bound of the earlier tables {old_ms:.4f} ms",
                [args], "fused_class")
            tot += [np.nan if v is None else v for v in got]
        print(f"K3 {k} on {path} [{s.name}, {s.card}]: {len(calls)} "
              f"launches, {tot[0]:.4f} ms by CUDA events, {tot[1]:.4f} ms "
              f"by the profiler, {tot[2]:.4f} ms queued; bound {tot[3]:.4f} "
              f"ms ({100 * tot[3] / tot[0]:.1f}% by events), the earlier "
              f"tables' bound {old:.4f} ms", flush=True)
    for k in ("expand_pieces", "expand_pieces_flat"):
        for path in dict.fromkeys(p for p, _ in s.calls[k]):
            calls = [a for p, a in s.calls[k] if p == path]
            for args in calls:
                equal64(k, args)
            rows = piece_call(calls[0])[0]
            measure_calls(
                s, k, f"K2 on {path} ({k}): {len(calls)} launch(es); "
                f"{len(rows) if len(calls) == 1 else len(calls)} piece "
                f"classes, {sum(piece_call(a)[1] for a in calls)} subtiles; "
                "equal to its plain version in f64", calls, "expand_pieces")


def host_us(torch, fn, reps: int = LAUNCH_REPS) -> float:
    """Host µs per call of ``fn`` over ``reps`` back-to-back calls, the
    host clock around them and a closing ``torch.cuda.synchronize()``
    (after one untimed call)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps * 1e6


def launch_cost_phase(s: Smoke) -> None:
    """Where the host's time per launch goes: each step of the ctypes
    launch path (``cuda_lib.launch``) alone, the whole wrappers, and the
    PyTorch calls that compute the same functions, at 1 tile (K5: 1 unit;
    K11: one 64-row copy; K7 and K8: a 32 x 32 stencil) and at the main
    path's own calls (when the paths have run).
    Each step is timed over LAUNCH_REPS back-to-back calls, in
    LAUNCH_ROUNDS rounds that take every step in turn; the median round is
    printed, with the fastest and slowest."""
    torch, cl, nt = s.torch, s.cuda_lib, s.nt
    from nsparse_tpu_torch.buildlib import BUILD_DIR
    from nsparse_tpu_torch.ops.kernels import (
        dia, gather_tiles, piecewise, runcopy, shuffle, spmv_bsr)

    src = torch.randn(2 * 1024, device=s.dev)
    ids = torch.ones(1, dtype=torch.int32, device=s.dev)
    out = torch.empty(1024, device=s.dev)
    idx = torch.arange(1024, dtype=torch.int32, device=s.dev)
    fn = cl.resolve("nsp_gather_tiles8", torch.float32)
    int_args = (src.data_ptr(), 2, ids.data_ptr(), 1, out.data_ptr(),
                torch.cuda.current_stream(s.dev).cuda_stream)
    # the same entry point loaded through ctypes.PyDLL, which keeps the
    # interpreter lock during the call
    held = getattr(ctypes.PyDLL(glob.glob(os.path.join(
        BUILD_DIR, "libnsparse_gather_tiles8-*.so"))[0]),
        "nsp_gather_tiles8_f32")
    held.argtypes, held.restype = fn.argtypes, fn.restype
    tiles, il, idx_l = src.view(-1, 1024), ids.long(), idx.long()
    # one unit of K5 (8,192 slots) and a one-copy K11 table of as many
    # slots (64 rows: the BIAS zeros and 6,144 table slots)
    unit_args = (torch.randn(8192, device=s.dev),
                 torch.arange(8192, dtype=torch.int32, device=s.dev),
                 torch.zeros(1, dtype=torch.int32, device=s.dev), 8192,
                 torch.empty(8192, device=s.dev))
    bank_args = (torch.arange(64 * 128 - piecewise.BIAS, dtype=torch.int32,
                              device=s.dev), 64,
                 torch.randn(8192, device=s.dev), 1)
    # K4 on one run of one tile; K7 and K8 on a 32 x 32 stencil (1,024
    # rows: DIA, and 8 block rows of (128, 128) BSR tiles)
    rc_plan = runcopy.build_runcopy_plan([0], [1024], src.numel(),
                                         dst=[0]).to(s.dev)
    tiny = nt.stencil_csr(32, 32, dtype=np.float32)
    tiny_dia = nt.DIA.from_csr(tiny).to(s.dev)
    tiny_bsr = nt.BSR.from_csr(tiny, (128, 128)).to(s.dev)
    tiny_x = torch.randn(tiny.shape[1], device=s.dev)
    steps = {
        "bare ctypes call of K12's entry, 1 tile, int arguments":
            lambda: fn(*int_args),
        "bare ctypes call of K12's entry, 1 tile, int arguments, "
        "interpreter lock held (PyDLL)": lambda: held(*int_args),
        "bare ctypes call that launches nothing (nsp_error_string)":
            lambda: cl.KERNELS.get().nsp_error_string(0),
        "new path: cuda_lib.validate, 3 tensors":
            lambda: cl.validate("gather_tiles8", src, 2, ids, 1, out),
        "new path: cuda_lib.resolve":
            lambda: cl.resolve("nsp_gather_tiles8", torch.float32),
        "new path: current device": cl._current_device,
        "new path: raw current stream": lambda: cl._raw_stream(0),
        "new path: cuda_lib.launch of K12, 1 tile": lambda: cl.launch(
            "gather_tiles8", "nsp_gather_tiles8", src, 2, ids, 1, out),
        "torch.empty, 1 tile": lambda: torch.empty(1024, device=s.dev),
        "t.new_empty, 1 tile": lambda: src.new_empty(1024),
        "K12 gather_tiles8 (new path), 1 tile":
            lambda: gather_tiles.gather_tiles8(src, ids),
        "K6 scatter_tiles (new path), 1 tile":
            lambda: gather_tiles.scatter_tiles(src, ids, out, 1024),
        "K11 build_bank, one 64-row copy":
            lambda: piecewise.build_bank(*bank_args),
        "b_val[idx], one 64-row copy": s.library_call("build_bank",
                                                      bank_args),
        "K5 gather_subset, 1 unit":
            lambda: gather_tiles.gather_subset(*unit_args),
        "src[idx], 1 unit": s.library_call("gather_subset", unit_args),
        "K4 runcopy, one run of 1 tile":
            lambda: runcopy.runcopy(rc_plan, src),
        "K7 spmv_dia, 32 x 32 stencil":
            lambda: dia.spmv_dia(tiny_dia.vals, tiny_dia.offsets, tiny_x,
                                 tiny.shape[0], tiny_dia.off_t),
        "K8 spmv_bsr, 32 x 32 stencil": lambda: spmv_bsr.spmv_bsr(
            tiny_bsr, tiny_x),
        "K1 gather, 1 tile": lambda: shuffle.gather(src, idx),
        "index_select, 1 tile": lambda: tiles.index_select(0, il),
        "index_copy_, 1 tile":
            lambda: tiles.index_copy_(0, il, out.view(1, 1024)),
        "x[idx], 1 tile": lambda: src[idx_l],
    }
    # the main path's own calls: K12, K11 and K4 on R-MAT-14's v2 path,
    # K14 on the stencil ELL, K7 on the stencil DIA and K8 on the FEM BSR,
    # each beside its library call where there is one
    for k, path, lib in (("gather_tiles8", "spgemm", "index_select"),
                         ("build_bank", "spgemm", "b_val[idx]"),
                         ("runcopy", "spgemm", "src[idx]"),
                         ("spmv_ell", "stencil-ell-sigma0", None),
                         ("spmv_dia", "stencil-dia", None),
                         ("spmv_bsr", "fem-bsr128", "sparse_bsr_tensor @ x")):
        calls = [a for p, a in s.calls[k] if p == path]
        if calls:
            args = s.fresh(k, calls[0])
            steps[f"{k} on {path}"] = \
                lambda w=s.wrappers[k], a=args: w(*a)
            if lib:
                steps[f"{lib} on {path}"] = s.library_call(k, args)

    us = {what: [] for what in steps}
    for _ in range(LAUNCH_ROUNDS):
        for what, step in steps.items():
            us[what].append(host_us(torch, step))
    for what, t in us.items():
        print(f"launch cost [{s.name}, {s.card}]: {what}: "
              f"{float(np.median(t)):.3f} us per call (median of "
              f"{LAUNCH_ROUNDS} rounds of {LAUNCH_REPS} calls; "
              f"{min(t):.3f} to {max(t):.3f})", flush=True)


# -- the distributed layer ------------------------------------------------------

DIST_SHARDS = 4  # a virtual mesh: every shard on cuda:0
# the halo SpMV and stencil R·A·P grid: 1024², cut from 2048² because the
# phase's host plans passed its budget there (the halo plans of A·P and
# R·(A·P) 40.1 + 11.7 s, rap_halo's own 55.1 s; PERF.md §4)
DIST_STENCIL = 1024
DIST_HOST_S = 150  # the phase's host-time budget


def plan_launches(plan) -> dict:
    """The launches of one single-card ``spgemm_numeric`` on ``plan``, by
    its layout: the sort layout's gather plans (``sort_launches``); the
    global slab layout's (``global_launches``); the window layout's v2
    form (K11, K1 for the class A values, K3 v2 per class, K4) or v1 form
    (K2 run form, K3 per class, K4), each with its fallback pool (v2: the
    piece route's K1, K2 and K12; both: K13 for the segment); K1 twice
    and K6 where a piece plan has run-dense subtiles."""
    want = {}

    def add(k, n=1):
        want[k] = want.get(k, 0) + n

    def pieces(pw):
        for k, n in global_launches(pw).items():
            if k not in ("build_bank", "gather"):
                add(k, n)
        add("gather")  # the pieces' A values
        if pw.fb_ids.numel():
            add("gather", 2)
            add("scatter_tiles")

    if plan.layout == "sort":
        for k, n in sort_launches(plan.srt).items():
            add(k, n)
    elif plan.layout == "global":
        add("build_bank")
        add("gather", 2)  # the slab and assembly shuffles
        pieces(plan.glob.pw)
    else:
        w = plan.win
        add("runcopy")
        if w.fused_expand:
            add("build_bank")
            add("gather")
            add("fused_class_v2", len(w.fused))
            if w.fb is not None:
                pieces(w.pw)
        else:
            add("expand")
            add("fused_class", len(w.fused))
        if w.fb is not None:
            add("fallback_sum")
    return want


def shard_launches(plans) -> dict:
    """The summed single-card launches of every shard's plan."""
    want = {}
    for p in plans:
        for k, n in plan_launches(p).items():
            want[k] = want.get(k, 0) + n
    return want


def layouts(plans) -> str:
    return ", ".join(
        p.layout + (("-v2" if p.win.fused_expand else "-v1")
                    if p.layout == "window" else "") for p in plans)


@contextlib.contextmanager
def numeric_ops(ops):
    """Every routed numeric phase runs ``ops`` inside the block: the
    window phase's default and the ``KERNEL_OPS`` the global slab phase
    reads at call time."""
    from nsparse_tpu_torch.ops import spgemm_window as sw

    saved = sw.spgemm_numeric_window.__defaults__, sw.KERNEL_OPS
    sw.spgemm_numeric_window.__defaults__ = (ops,)
    sw.KERNEL_OPS = ops
    try:
        yield
    finally:
        sw.spgemm_numeric_window.__defaults__, sw.KERNEL_OPS = saved


@contextlib.contextmanager
def all_plain(s: Smoke):
    """Every kernel of every path replaced by its plain version."""
    from nsparse_tpu_torch.ops import spgemm_window as sw

    with s.plain_mode(), numeric_ops(sw.PLAIN_OPS):
        yield


def record_all(s: Smoke, fn, path: str) -> None:
    """``s.record`` with the routed numeric phases' kernel calls kept too."""
    from nsparse_tpu_torch.ops import spgemm_window as sw

    kernels = sw.KERNEL_OPS
    ops_type = type(kernels)

    def recorder(field):
        def call(*args, **kw):
            s.calls[SPGEMM_FIELDS[field]].append((path, args))
            return getattr(kernels, field)(*args, **kw)
        return call

    rec = ops_type(*(recorder(f) for f in ops_type._fields))
    with numeric_ops(rec):
        s.record(fn, path)


def dist_timed(s: Smoke, path: str, fn, single, single_what: str,
               calls: int = 3) -> None:
    """``fn`` by CUDA events with the kernels and with their plain
    versions (plain, kernels, kernels, plain), the single-card call of the
    same product beside it, and its device-busy share under
    torch.profiler."""
    t = {"kernels": [], "plain": []}
    for mode in ("plain", "kernels", "kernels", "plain"):
        ctx = all_plain(s) if mode == "plain" else contextlib.nullcontext()
        with ctx:
            t[mode].append(s.time_cuda(fn, trials=TRIALS))
    one = s.time_cuda(single, trials=TRIALS)
    print(f"{path} [{s.name}, {s.card}]: {DIST_SHARDS} shards: kernels "
          f"{np.mean(t['kernels']):.4f} ms ({t['kernels']})  plain "
          f"{np.mean(t['plain']):.4f} ms ({t['plain']})  single card "
          f"({single_what}) {one:.4f} ms", flush=True)
    profile_calls(s.torch, fn, path, calls=calls)


def check_y(s: Smoke, y, a, x, what: str) -> None:
    """y against scipy (rtol 1e-5 f32 / 1e-8 f64 of |A||x|), finite."""
    nt = s.nt
    dt = np.float32 if y.dtype == s.torch.float32 else np.float64
    ok, nf = nt.ans_check(y, nt.spmv_oracle(a, x), dtype=dt,
                          scale=nt.spmv_abs_oracle(a, x))
    finite = bool(s.torch.isfinite(y).all())
    print(f"{what} vs scipy (rtol {1e-5 if dt == np.float32 else 1e-8:g}, "
          f"|A||x| bound): {'pass' if ok else 'FAIL'}  finite {finite}",
          flush=True)
    if not ok or not finite:
        fail(f"{what}: {nf} entries of y disagree with scipy")


def check_chain(s: Smoke, c, mats, what: str):
    """C against the scipy product of ``mats`` (rtol 1e-5 f32 / 1e-8 f64,
    scaled by the product of their absolute values), structure exact,
    values finite; returns that scale on C's structure."""
    nt = s.nt
    ref = mats[0].to_scipy()
    sa = abs(ref.astype(np.float64))
    for m in mats[1:]:
        ref = ref @ m.to_scipy()
        sa = sa @ abs(m.to_scipy().astype(np.float64))
    ref, sa = ref.tocsr(), sa.tocsr()
    for x in (ref, sa):
        x.sum_duplicates()
        x.sort_indices()
    ok = nt.check_spgemm_answer(c, ref, verbose=True, abs_ref=sa)
    finite = bool(np.isfinite(c.val[: c.nnz].cpu().numpy()).all())
    rtol = 1e-5 if c.val.dtype == s.torch.float32 else 1e-8
    bound = "|R||A||P|" if len(mats) == 3 else "|A||B|"
    print(f"{what} vs scipy (rtol {rtol:g}, {bound} bound): "
          f"{'pass' if ok else 'FAIL'}  finite {finite}", flush=True)
    if not ok or not finite:
        fail(f"{what} does not match the scipy oracle")
    return sa.data


def against_single(s: Smoke, c, c1, scale, what: str) -> None:
    """A gathered dist C against the single-card C of the same product:
    structure equal, values within 1e-5 of ``scale`` (|A||B| or
    |R||A||P|)."""
    torch = s.torch
    same = torch.equal(c.rpt.cpu(), c1.rpt.cpu()) and torch.equal(
        c.col[: c.nnz].cpu(), c1.col[: c1.nnz].cpu())
    diff = (c.val[: c.nnz].double().cpu()
            - c1.val[: c1.nnz].double().cpu()).abs()
    rel = float((diff / torch.from_numpy(scale)).max()) if c.nnz else 0.0
    print(f"{what}: structure equal to the single-card C: {same}; max "
          f"|C_dist - C_single| / bound {rel:.3g} (within 1e-5: "
          f"{rel <= 1e-5})", flush=True)
    if not same or rel > 1e-5:
        fail(f"{what}: the dist and single-card products differ")


def with_dtype(part, dtype):
    """A partition's values cast to ``dtype``."""
    return part.with_values([v.to(dtype) for v in part.vals])


def aggregation(s: Smoke, n: int, dtype=np.float32):
    """(P, R = P^T) of the 4:1 consecutive aggregation of n unknowns."""
    import scipy.sparse as sp

    p = sp.csr_matrix((np.ones(n, dtype), (np.arange(n), np.arange(n) // 4)),
                      shape=(n, n // 4))
    return s.nt.CSR.from_scipy(p), s.nt.CSR.from_scipy(p.T.tocsr())


def single_card_rmat14(s: Smoke) -> None:
    """R-MAT-14's single-card v2 window C (spgemm_phase's, when it ran)
    and its v2 and sort host plans (plan_cache_phase frees them), for
    dist_phase to compare with."""
    nt = s.nt
    if not hasattr(s, "rmat14"):  # dist_phase run alone
        a = nt.rmat_csr(SCALE, EDGE_FACTOR, dtype=np.float32, seed=SEED)
        plan = host_timed(f"window-v2 plan R-MAT-{SCALE}",
                          lambda: nt.spgemm_plan(a, a))
        a_d = a.to(s.dev)
        s.rmat14 = (a, a_d, nt.spgemm_numeric(plan.to(s.dev), a_d, a_d))
        s.host_plans["window-v2"] = (a, plan, "spgemm")
    a = s.rmat14[0]
    for name, kw in (("window-v2", {}), ("sort", {"shuffle": False})):
        if name not in s.host_plans:
            s.host_plans[name] = (a, host_timed(
                f"{name} plan R-MAT-{SCALE}",
                lambda: nt.spgemm_plan(a, a, **kw)), name)


def single_chain(s: Smoke, r, a, p):
    """The single-card R @ (A @ P): host plans of both products (the
    layout rule's choice), built once; returns the numeric chain."""
    nt = s.nt
    plan1 = host_timed("single-card plan A·P", lambda: nt.spgemm_plan(a, p))
    ap = nt.CSR(rpt=plan1.c_rpt, col=plan1.c_col[: plan1.c_nnz],
                val=a.val.new_zeros(plan1.c_nnz), shape=plan1.shape,
                nnz=plan1.c_nnz)
    plan2 = host_timed("single-card plan R·(A·P)",
                       lambda: nt.spgemm_plan(r, ap))
    print(f"single card: A·P {plan1.layout}, R·(A·P) {plan2.layout}",
          flush=True)
    plan1, plan2 = plan1.to(s.dev), plan2.to(s.dev)
    r_d, a_d, p_d = (x.to(s.dev) for x in (r, a, p))

    return lambda: nt.spgemm_numeric(plan2, r_d,
                                     nt.spgemm_numeric(plan1, a_d, p_d))


def dist_spgemm(s: Smoke, path: str, part, a, plan, run) -> object:
    """A dist C = A @ A on R-MAT-14: the counted run (launches equal to the
    shard plans' summed single-card launches), the scipy check, the
    single-card window C's structure and values, new values in f32 and
    f64 on the same plans; the gathered C."""
    torch, nt, par = s.torch, s.nt, s.par
    want = shard_launches(plan.plans)
    print(f"{path}: shard layouts [{layouts(plan.plans)}], products "
          f"{[p.n_products for p in plan.plans]}, nnz(C) {plan.c_nnz}; "
          f"launches expected {want}", flush=True)
    c = par.gather_partitioned(s.counted(lambda: run(part, s.a14_d), list(want),
                                         path, want))
    check_c(s, c, a, f"{path}: C")
    against_single(s, c, s.rmat14[2], nt.spgemm_abs_oracle(a, a).data, path)
    v2 = np.random.default_rng(SEED + 3).standard_normal(a.nnz)
    for dt in (np.float32, np.float64):
        a2 = a.with_values(torch.from_numpy(v2.astype(dt)))
        part2 = par.partition_rows(a2, DIST_SHARDS, mesh=s.mesh)
        c2 = par.gather_partitioned(run(part2, a2.to(s.dev)))
        check_c(s, c2, a2, f"{path}: new {np.dtype(dt).name} values on the "
                "same plans")
    return c


def dist_phase(s: Smoke) -> None:
    """The distributed layer on a virtual mesh of DIST_SHARDS shards on
    cuda:0 (PERF.md §4): spmv_dist on R-MAT-20, spmv_halo on the stencil,
    spgemm_dist (sort layout per shard) and the dist window (v2 per shard)
    on R-MAT-14, spgemm_halo and rap_halo on the stencil with the 4:1
    aggregation, rap_dist esc on the same operands and window (refused on
    the stencil, then on R-MAT-14), and the CLI's ``rap``.  Every y and C
    checked against scipy in f32 and f64, launch counts exact, no host
    gather inside ``rap_dist_parts``, each path timed beside the
    single-card call of the same product."""
    torch, nt = s.torch, s.nt
    from nsparse_tpu_torch import parallel as par
    from nsparse_tpu_torch.parallel import spgemm as ps

    t_phase = time.perf_counter()
    s.par = par
    s.mesh = mesh = par.make_mesh(DIST_SHARDS, device=s.dev)
    print(f"dist: a mesh of {mesh.size} shards, devices {set(map(str, mesh.devices))} "
          "(one card: a virtual mesh)", flush=True)
    rng = np.random.default_rng(SEED + 5)

    # -- spmv_dist: R-MAT-20, x replicated --------------------------------
    a = host_timed(f"generate R-MAT-{RMAT_SCALE}", lambda: nt.rmat_csr(
        RMAT_SCALE, RMAT_EF, dtype=np.float32, seed=RMAT_SEED))
    part = host_timed("partition_rows R-MAT-20", lambda: par.partition_rows(
        a, DIST_SHARDS, mesh=mesh))
    a_d = a.to(s.dev)
    for dt in (np.float32, np.float64):
        path = f"dist-spmv-rmat{RMAT_SCALE}" + ("-f64" if dt == np.float64 else "")
        x = torch.from_numpy(rng.standard_normal(a.shape[1]).astype(dt))
        x_d = x.to(s.dev)
        p_dt = with_dtype(part, x.dtype)
        y = s.counted(lambda: par.spmv_dist(p_dt, x_d, mesh), [], path, {})
        if s.path_launches[path]:
            fail(f"{path}: launched port kernels (its local SpMVs are plain)")
        check_y(s, y, a.with_values(a.val.to(x.dtype)), x, path)
        if dt == np.float32:
            dist_timed(s, path, lambda: par.spmv_dist(p_dt, x_d, mesh),
                       lambda: nt.spmv_csr(a_d, x_d), "spmv_csr")
    del a, part, a_d, p_dt

    # -- spmv_halo: the stencil, x sharded --------------------------------
    st = host_timed(f"generate stencil {DIST_STENCIL}x{DIST_STENCIL}",
                    lambda: nt.stencil_csr(DIST_STENCIL, DIST_STENCIL,
                                           dtype=np.float32))
    bp = host_timed("partition_banded stencil", lambda: par.partition_banded(
        st, DIST_SHARDS, mesh=mesh))
    print(f"stencil: {st.shape[0]} rows, nnz {st.nnz}, halo {bp.halo}, "
          f"m_loc {bp.m_loc}", flush=True)
    st_d = st.to(s.dev)
    for dt in (np.float32, np.float64):
        path = "dist-spmv-halo" + ("-f64" if dt == np.float64 else "")
        x = torch.from_numpy(rng.standard_normal(st.shape[0]).astype(dt))
        xs = par.shard_x(x, DIST_SHARDS, bp.m_loc, mesh)
        bp_dt = with_dtype(bp, x.dtype)

        def halo_run():
            return par.spmv_halo(bp_dt, xs, mesh)

        ys = s.counted(halo_run, [], path, {})
        if s.path_launches[path]:
            fail(f"{path}: launched port kernels (its local SpMVs are plain)")
        check_y(s, torch.cat(ys)[: st.shape[0]],
                st.with_values(st.val.to(x.dtype)), x, path)
        if dt == np.float32:
            x_d = x.to(s.dev)
            dist_timed(s, path, halo_run, lambda: nt.spmv_csr(st_d, x_d),
                       "spmv_csr")
    del bp, bp_dt, xs

    # -- spgemm_dist and the dist window: R-MAT-14, B replicated ----------
    single_card_rmat14(s)
    a14, s.a14_d, c_win = s.rmat14
    part14 = par.partition_rows(a14, DIST_SHARDS, mesh=mesh)
    plan = host_timed(f"spgemm_plan_dist R-MAT-{SCALE} ({DIST_SHARDS} sort-"
                      "layout shard plans)",
                      lambda: par.spgemm_plan_dist(part14, a14))

    def sort_run(p, b):
        return par.spgemm_dist(p, b, mesh, plan=plan)

    dist_spgemm(s, "spgemm-dist", part14, a14, plan, sort_run)
    record_all(s, lambda: sort_run(part14, s.a14_d), "spgemm-dist")
    single = s.host_plans["sort"][1].to(s.dev)
    dist_timed(s, "spgemm-dist", lambda: sort_run(part14, s.a14_d),
               lambda: nt.spgemm_numeric(single, s.a14_d, s.a14_d),
               "the sort-layout host plan")
    del plan, single

    plan = host_timed(f"spgemm_plan_dist_window R-MAT-{SCALE} ("
                      f"{DIST_SHARDS} window shard plans)",
                      lambda: par.spgemm_plan_dist_window(part14, a14))
    if not all(p.win.fused_expand for p in plan.plans):
        fail("spgemm_plan_dist_window returned a shard plan not in v2 form")

    def win_run(p, b):
        return par.spgemm_numeric_dist_window(plan, p, b, mesh)

    dist_spgemm(s, "spgemm-dist-window", part14, a14, plan, win_run)
    record_all(s, lambda: win_run(part14, s.a14_d), "spgemm-dist-window")
    single = s.host_plans["window-v2"][1].to(s.dev)
    dist_timed(s, "spgemm-dist-window", lambda: win_run(part14, s.a14_d),
               lambda: nt.spgemm_numeric(single, s.a14_d, s.a14_d),
               "the v2 window host plan")
    del plan, single

    # -- the stencil R·A·P: halo exchange, then B replicated --------------
    p_st, r_st = aggregation(s, st.shape[0])
    print(f"R·A·P: R({r_st.shape[0]}x{r_st.shape[1]}) @ A({st.shape[0]}x"
          f"{st.shape[1]}, nnz {st.nnz}) @ P({p_st.shape[0]}x"
          f"{p_st.shape[1]})", flush=True)
    r_p, a_p, p_p = (par.partition_rows(x, DIST_SHARDS, mesh=mesh)
                     for x in (r_st, st, p_st))
    plan1 = host_timed("spgemm_halo_plan A·P",
                       lambda: par.spgemm_halo_plan(a_p, p_p))
    want1 = shard_launches(plan1.plans)
    print(f"spgemm-halo: shard layouts [{layouts(plan1.plans)}], products "
          f"{[p.n_products for p in plan1.plans]}; launches expected "
          f"{want1}", flush=True)
    ap = s.counted(lambda: par.spgemm_halo(a_p, p_p, mesh, plan=plan1),
                   list(want1), "spgemm-halo", want1)
    check_chain(s, par.gather_partitioned(ap), [st, p_st], "spgemm-halo: A·P")
    plan2 = host_timed("spgemm_halo_plan R·(A·P)",
                       lambda: par.spgemm_halo_plan(r_p, ap))
    want = shard_launches(plan1.plans + plan2.plans)
    print(f"rap-halo: R·(A·P) shard layouts [{layouts(plan2.plans)}], "
          f"products {[p.n_products for p in plan2.plans]}; launches "
          f"expected {want}", flush=True)

    def rap_run(r_, a_, p_):
        return par.spgemm_halo(r_, par.spgemm_halo(a_, p_, mesh, plan=plan1),
                               mesh, plan=plan2)

    c = s.counted(lambda: rap_run(r_p, a_p, p_p), list(want), "rap-halo",
                  want)
    c_rap = par.gather_partitioned(c)
    scale = check_chain(s, c_rap, [r_st, st, p_st], "rap-halo")
    c_entry = host_timed("rap_halo (plans inside)",
                         lambda: par.rap_halo(r_p, a_p, p_p, mesh))
    same = all(torch.equal(u, v) for u, v in zip(c.vals, c_entry.vals))
    print(f"rap_halo == the planned chain (torch.equal): {same}", flush=True)
    if not same:
        fail("rap_halo and its planned chain give different C")
    del c_entry
    parts64 = [with_dtype(x, torch.float64) for x in (r_p, a_p, p_p)]
    mats64 = [x.with_values(x.val.double()) for x in (r_st, st, p_st)]
    check_chain(s, par.gather_partitioned(rap_run(*parts64)), mats64,
                "rap-halo: float64 values on the same plans")
    del parts64
    record_all(s, lambda: rap_run(r_p, a_p, p_p), "rap-halo")
    single_st = single_chain(s, r_st, st, p_st)
    against_single(s, c_rap, single_st(), scale, "rap-halo")
    dist_timed(s, "rap-halo", lambda: rap_run(r_p, a_p, p_p), single_st,
               "host plans, both numeric phases")

    def rap_dist_path(tag, r, a, p, single):
        """rap_dist on (R, A, P): the entry point with gather_partitioned
        counted (once: the final gather, none inside rap_dist_parts), the
        planned chain counted, checked, re-run in f64, timed."""
        path = f"rap-dist-{tag}"
        numeric = tag.split("-")[0]
        calls = [0]
        orig = ps.gather_partitioned

        def counting(c):
            calls[0] += 1
            return orig(c)

        p_d = p.to(s.dev)
        ps.gather_partitioned = counting
        try:
            got = host_timed(f"{path}: rap_dist (plans inside)",
                             lambda: par.rap_dist(r, a, p_d, mesh,
                                                  numeric=numeric))
        finally:
            ps.gather_partitioned = orig
        print(f"{path}: gather_partitioned calls {calls[0]} (the final "
              "gather only; none inside rap_dist_parts)", flush=True)
        if calls[0] != 1:
            fail(f"{path}: A·P gathered on the host inside rap_dist_parts")
        check_chain(s, got, [r, a, p], f"{path}: rap_dist")
        r_p, a_p = (par.partition_rows(x, DIST_SHARDS, mesh=mesh)
                    for x in (r, a))
        plan = host_timed(f"{path}: rap_dist_plan", lambda: par.rap_dist_plan(
            r_p, a_p, p_d, numeric))
        want = shard_launches(plan.ap.plans + plan.rap.plans)
        print(f"{path}: A·P shard layouts [{layouts(plan.ap.plans)}], "
              f"R·(A·P) [{layouts(plan.rap.plans)}]; launches expected "
              f"{want}", flush=True)

        def run(r_, a_, p_):
            return par.rap_dist_numeric(plan, r_, a_, p_, mesh)

        c = s.counted(lambda: run(r_p, a_p, p_d), list(want), path, want)
        c = par.gather_partitioned(c)
        against_single(s, c, single(), check_chain(s, c, [r, a, p], path),
                       path)
        if not (torch.equal(c.rpt, got.rpt) and torch.equal(c.val, got.val)):
            fail(f"{path}: rap_dist and its planned chain differ")
        check_chain(s, par.gather_partitioned(run(
            with_dtype(r_p, torch.float64),
            with_dtype(a_p, torch.float64),
            p_d.with_values(p_d.val.double()))),
            [x.with_values(x.val.double()) for x in (r, a, p)],
            f"{path}: float64 values on the same plans")
        dist_timed(s, path, lambda: run(r_p, a_p, p_d), single,
                   "host plans, both numeric phases")

    rap_dist_path("esc-stencil", r_st, st, p_st, single_st)
    try:
        host_timed("rap_dist_plan window, stencil", lambda: par.rap_dist_plan(
            r_p, a_p, p_st, "window"))
        refused = None
    except NotImplementedError as e:
        refused = e
    del r_p, a_p, p_p, ap, c, c_rap, plan1, plan2
    if refused is None:
        rap_dist_path("window-stencil", r_st, st, p_st, single_st)
    else:
        print(f"rap-dist window on the stencil refused, as in the JAX "
              f"package: {refused}; the window R·A·P runs on "
              f"R-MAT-{SCALE}", flush=True)
        p14, r14 = aggregation(s, a14.shape[0])
        rap_dist_path(f"window-rmat{SCALE}", r14, a14, p14,
                      single_chain(s, r14, a14, p14))
    del single_st

    cli_lines(["rap", "--devices", str(DIST_SHARDS), "--n", "65536"])
    host_s = time.perf_counter() - t_phase
    print(f"dist phase host time {host_s:.1f} s (budget {DIST_HOST_S} s; "
          f"stencil {DIST_STENCIL}x{DIST_STENCIL})", flush=True)


def main() -> None:
    t_start = time.perf_counter()
    try:
        import torch
    except ImportError as e:
        fail(f"torch is not importable: {e}")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a card")
    try:
        import nsparse_tpu_torch  # noqa: F401
    except ImportError as e:
        fail(f"the port is not importable (run from the repository root): {e}")

    card = card_line()
    print(card)
    s = Smoke(torch, card)
    print(f"device: {s.name}  torch {torch.__version__}  cuda "
          f"{torch.version.cuda}  python {sys.version.split()[0]}")

    t0 = time.perf_counter()
    s.cuda_lib.KERNELS.get()
    print(f"kernels built: {time.perf_counter() - t0:.1f} s "
          f"(nvcc {' '.join(s.cuda_lib.NVCC_FLAGS)})", flush=True)

    for phase in (spgemm_phase, fallback_phase, esc_layout_phases,
                  hash_phase,
                  plan_cache_phase,
                  cli_phase, kfold_phase, spmv_phases,
                  bsr_spgemm_phases, windowed_gather_phase, tile_copy_phase,
                  bank_subset_phase, k9_phase, k1_phase, k3_k2_phase,
                  launch_cost_phase, dist_phase):
        t0 = time.perf_counter()
        phase(s)
        print(f"phase {phase.__name__}: {time.perf_counter() - t0:.1f} s "
              "host time", flush=True)
    table = s.kernel_table()
    print(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": table, "spgemm_hash": s.hash_rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": s.name,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()

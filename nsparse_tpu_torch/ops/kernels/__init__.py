"""The port's Hopper kernels, each beside its plain PyTorch version.

SpGEMM: K1 ``shuffle.gather`` (also the ELL x-shuffle and flat_gather's
fallback tiles), K2 ``piecewise.piecewise_expand`` (run form; piece mode
``expand_pieces`` and flat mode ``expand_pieces_flat``, one launch over
every piece class), K3
``window_fused.fused_class_apply`` (v1; v2 ``fused_class_expand``), K4
``runcopy.runcopy`` (fixed mode; ``runcopy_kfold`` stands alone, as its
TPU counterpart does), K11 ``piecewise.build_bank`` (the pre-rolled bank,
or the flat table), K12 ``gather_tiles.gather_tiles8``, K13
``fallback.fallback_sum`` (the window numeric's fallback segment, in one
launch); the sort layout runs ``flat_gather``.  SpMV: K14
``spmv_ell.spmv_ell`` (every ``plus_times`` ELL SpMV on the card, in two
launches), K5 ``gather_tiles.gather_subset`` and K6
``gather_tiles.scatter_tiles`` (both through ``flat_gather``: the ELL
paths of the other semirings and of the CPU), K7 ``dia.spmv_dia``, K8
``spmv_bsr.spmv_bsr``.  Block SpGEMM: K9
``bsr_blocks.spgemm_bsr_blocks`` (with K5, K1 and K6 on a value re-run's
re-blockification).  K10 ``gather_tiles.windowed_gather`` stands alone,
as its TPU counterpart does.
K9 multiplies on the tensor cores: float32 as three TF32 products per
product (3xTF32, float32 accuracy), float64 on DMMA.
K10 runs a warp per row below a 4 KB window, a thread per output from it.
A wrapper runs the plain version for CPU tensors; for CUDA tensors it
launches its kernel through ``cuda_lib.launch`` (and adds one to its
``launches`` count) or raises.
"""

"""The port's Hopper kernels, each beside its plain PyTorch version.

SpGEMM: K1 ``shuffle.gather`` (also the ELL x-shuffle and flat_gather's
fallback tiles), K2 ``piecewise.piecewise_expand``, K3
``window_fused.fused_class_apply``, K4 ``runcopy.runcopy``.  SpMV: K5
``gather_tiles.gather_subset``, K6 ``gather_tiles.scatter_tiles`` (both
through ``flat_gather``), K7 ``dia.spmv_dia``, K8 ``spmv_bsr.spmv_bsr``.
A wrapper runs the plain version for CPU tensors; for CUDA tensors it
launches its kernel (and adds one to its ``launches`` count) or raises.
"""

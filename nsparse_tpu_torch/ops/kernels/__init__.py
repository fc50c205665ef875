"""The port's four Hopper kernels, each beside its plain PyTorch version.

K1 ``shuffle.gather``, K2 ``piecewise.piecewise_expand``, K3
``window_fused.fused_class_apply``, K4 ``runcopy.runcopy``.  A wrapper
runs the plain version for CPU tensors; for CUDA tensors it launches its
kernel (and adds one to its ``launches`` count) or raises.
"""

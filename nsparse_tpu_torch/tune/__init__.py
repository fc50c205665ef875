"""Tuning: SpMV plans and the tuner, the kernel constants, the SpGEMM
plan cache.  The exports load on first use (``__getattr__``): the kernel
modules import ``tune.kernelgen``, and the tuner imports the kernels."""

__all__ = ["Plan", "autotune_spmv"]


def __getattr__(name):
    if name == "Plan":
        from nsparse_tpu_torch.tune.plan import Plan

        return Plan
    if name == "autotune_spmv":
        from nsparse_tpu_torch.tune.autotune import autotune_spmv

        return autotune_spmv
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")

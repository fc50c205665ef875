"""Moving plan dataclasses between devices."""

from __future__ import annotations

import contextlib
import dataclasses

import numpy as np
import torch


def to_device(obj, device):
    """Copy of ``obj`` with every tensor moved to ``device``: tensors,
    tuples and lists of them, and dataclasses holding any of these.  A
    dataclass field declared with ``metadata={"host": True}`` stays where
    it is (host tables that no kernel reads)."""
    if isinstance(obj, torch.Tensor):
        return obj.to(device)
    if isinstance(obj, (tuple, list)):
        return type(obj)(to_device(o, device) for o in obj)
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return dataclasses.replace(obj, **{
            f.name: to_device(getattr(obj, f.name), device)
            for f in dataclasses.fields(obj)
            if f.init and not f.metadata.get("host")
        })
    return obj


def int32_tensor(x) -> torch.Tensor:
    """A fresh int32 CPU tensor holding ``x`` (copied, so read-only numpy
    or JAX arrays are safe to pass)."""
    return torch.from_numpy(np.array(x, dtype=np.int32))


@contextlib.contextmanager
def highest_matmul_precision():
    """float32 matmuls in full precision inside the block (no TF32 on the
    card, no bfloat16 passes on the CPU); the caller's setting after.

    A caller who set the legacy ``torch.backends.cuda.matmul.allow_tf32``
    after the new API leaves a state PyTorch refuses to report; then the
    legacy flag is what is kept and restored."""
    try:
        saved, legacy = torch.get_float32_matmul_precision(), None
    except RuntimeError:
        saved, legacy = None, torch.backends.cuda.matmul.allow_tf32
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        if saved is not None:
            torch.set_float32_matmul_precision(saved)
        else:
            torch.backends.cuda.matmul.allow_tf32 = legacy

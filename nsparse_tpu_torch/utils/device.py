"""Moving plan dataclasses between devices."""

from __future__ import annotations

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

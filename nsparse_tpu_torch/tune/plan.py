"""Serializable SpMV tuning plans (counterpart of
``nsparse_tpu/tune/plan.py``).

A ``Plan`` records a tuner decision and persists as JSON keyed by
(matrix fingerprint, chip), so tuning is paid once per matrix and card.
The chip key is ``torch.cuda.get_device_name()`` with spaces replaced
(``"cpu"`` for a run on the host).
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
from typing import Optional

import numpy as np


@dataclasses.dataclass
class Plan:
    """SpMV format/tuning decision.

    format: "dia", "ell", "bsr" or "csr".
    min_width / max_slabs / sigma / xshuffle: ELL knobs.
    blocksize: BSR tile shape.
    measured_ms: the tuner's time for it (measure mode).
    memory_bytes: its footprint (the model-mode objective).
    """

    format: str = "ell"
    min_width: int = 8
    max_slabs: int = 8
    sigma: Optional[int] = None
    blocksize: tuple = (8, 128)
    xshuffle: bool = False
    isPlan: bool = False
    measured_ms: float = float("inf")
    memory_bytes: int = 0
    chip: str = ""
    matrix_key: str = ""

    def to_json(self) -> str:
        d = dataclasses.asdict(self)
        d["blocksize"] = list(d["blocksize"])
        return json.dumps(d, indent=1)

    @classmethod
    def from_json(cls, s: str) -> "Plan":
        d = json.loads(s)
        d["blocksize"] = tuple(d.get("blocksize", (8, 128)))
        return cls(**d)

    def save(self, directory: str) -> str:
        os.makedirs(directory, exist_ok=True)
        path = os.path.join(directory, f"{self.matrix_key}_{self.chip}.json")
        with open(path, "w") as f:
            f.write(self.to_json())
        return path

    @classmethod
    def load(cls, directory: str, matrix_key: str,
             chip: str) -> Optional["Plan"]:
        path = os.path.join(directory, f"{matrix_key}_{chip}.json")
        if not os.path.exists(path):
            return None
        with open(path) as f:
            return cls.from_json(f.read())


def chip_key(device) -> str:
    """The plan-cache key of ``device``."""
    import torch

    device = torch.device(device)
    if device.type != "cuda":
        return device.type
    return torch.cuda.get_device_name(device).replace(" ", "_")


def matrix_fingerprint(a) -> str:
    """Stable short key of a CSR matrix: shape, nnz and a hash of the
    full ``rpt`` and ``col`` arrays."""
    rpt, col, _ = a.host_arrays()
    h = hashlib.sha1()
    h.update(str(a.shape).encode())
    h.update(str(a.nnz).encode())
    h.update(np.ascontiguousarray(rpt).tobytes())
    h.update(np.ascontiguousarray(col[: a.nnz]).tobytes())
    return h.hexdigest()[:16]

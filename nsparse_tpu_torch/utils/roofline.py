"""Card specs and the SpMV and SpGEMM rooflines (counterpart of
``nsparse_tpu/utils/roofline.py``).

Both products are memory-bound, so each roofline is bytes moved over
device memory bandwidth.  Bandwidths are NVIDIA's published figures; the H100's form
factors differ (SXM HBM3 vs PCIe HBM2e).
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ChipSpec:
    name: str
    hbm_gbps: float  # device memory bandwidth, GB/s


_SPECS = (
    # (substring of torch.cuda.get_device_name(), spec); first match wins
    ("h100 pcie", ChipSpec("H100 PCIe", 2000.0)),
    ("h100 nvl", ChipSpec("H100 NVL", 3900.0)),
    ("h100", ChipSpec("H100 SXM", 3350.0)),
    ("h200", ChipSpec("H200 SXM", 4800.0)),
)


def chip_specs(device_name: str) -> ChipSpec:
    """Spec of the card called ``device_name``
    (``torch.cuda.get_device_name()``)."""
    low = device_name.lower()
    for key, spec in _SPECS:
        if key in low:
            return spec
    raise KeyError(f"no roofline spec for {device_name!r}")


def spmv_bytes(nnz: int, m: int, n: int, val_bytes: int = 4,
               idx_bytes: int = 4, padded_nnz: int | None = None) -> int:
    """Least traffic of one SpMV: read the stored values and indices
    (``padded_nnz`` counts a layout's explicit zeros) and x, write y.  DIA
    stores no per-entry index: pass ``idx_bytes=0``."""
    stored = padded_nnz if padded_nnz is not None else nnz
    return stored * (val_bytes + idx_bytes) + (n + m) * val_bytes


def spmv_roofline_gflops(nnz: int, m: int, n: int, spec: ChipSpec,
                         val_bytes: int = 4, idx_bytes: int = 4,
                         padded_nnz: int | None = None) -> float:
    """Bandwidth-bound GFLOPS ceiling of y = A @ x (useful flops 2 nnz)."""
    seconds = spmv_bytes(nnz, m, n, val_bytes, idx_bytes, padded_nnz) / (
        spec.hbm_gbps * 1e9)
    return 2.0 * nnz / seconds / 1e9


def spgemm_bytes(nnz_a: int, nnz_b: int, nnz_c: int, n_products: int,
                 val_bytes: int = 4, idx_bytes: int = 4) -> int:
    """Hash-style ideal traffic of C = A @ B: read A and B once, write C
    once, touch each intermediate product once."""
    per_nnz = val_bytes + idx_bytes
    return (nnz_a + nnz_b + nnz_c + n_products) * per_nnz


def spgemm_roofline_gflops(nnz_a: int, nnz_b: int, nnz_c: int,
                           n_products: int, spec: ChipSpec,
                           val_bytes: int = 4, idx_bytes: int = 4) -> float:
    """Bandwidth-bound GFLOPS ceiling (useful flops = 2 P)."""
    seconds = spgemm_bytes(
        nnz_a, nnz_b, nnz_c, n_products, val_bytes, idx_bytes
    ) / (spec.hbm_gbps * 1e9)
    return 2.0 * n_products / seconds / 1e9

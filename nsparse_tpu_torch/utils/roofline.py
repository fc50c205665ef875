"""Card specs and the SpGEMM roofline (counterpart of
``nsparse_tpu/utils/roofline.py``).

SpGEMM is memory-bound, so its roofline is bytes moved over device memory
bandwidth.  Bandwidths are NVIDIA's published figures; the H100's form
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

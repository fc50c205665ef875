"""Per-row work analysis and geometric binning (counterpart of
``nsparse_tpu/ops/binning.py``).

The analog of the reference's BIN machinery (``set_max_bin`` /
``set_min_bin``): rows are classed by their work size into geometric bins
``(..., min * 2^j]``.  ``flops_per_row`` counts in int64: the JAX
package's int32 sum wraps on products past 2^31.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from nsparse_tpu_torch.formats.csr import CSR

BIN_NUM = 7  # parity with the reference's BIN_NUM (spgemm_hash_kernel_gen.c)


def flops_per_row(a: CSR, b: CSR) -> torch.Tensor:
    """(M,) int64 intermediate products of each output row (x2 = FLOPs),
    on A's device."""
    deg_b = torch.diff(b.rpt.to(a.device).long())
    cnt = deg_b[a.col[: a.nnz].long()]
    out = torch.zeros(a.shape[0], dtype=torch.int64, device=a.device)
    return out.index_add_(0, a.row_ids()[: a.nnz].long(), cnt)


def bin_rows(sizes: np.ndarray, min_size: int = 32,
             num_bins: int = BIN_NUM) -> List[np.ndarray]:
    """Partition row indices into geometric size classes.

    Bin j holds rows with ``size <= min_size * 2**j`` (not in a smaller
    bin); the last bin is unbounded.  Returns one int32 index array per
    bin, empty bins kept so bin identity is stable.
    """
    sizes = np.asarray(sizes)
    edges = [min_size * (1 << j) for j in range(num_bins - 1)]
    bins: List[np.ndarray] = []
    lo = -1
    for e in edges:
        sel = (sizes > lo) & (sizes <= e)
        bins.append(np.nonzero(sel)[0].astype(np.int32))
        lo = e
    bins.append(np.nonzero(sizes > lo)[0].astype(np.int32))
    return bins


def bin_histogram(sizes: np.ndarray, min_size: int = 32,
                  num_bins: int = BIN_NUM) -> Tuple[np.ndarray, np.ndarray]:
    """(rows per bin, largest size per bin)."""
    bins = bin_rows(sizes, min_size, num_bins)
    counts = np.array([len(b) for b in bins])
    maxes = np.array(
        [int(np.asarray(sizes)[b].max()) if len(b) else 0 for b in bins])
    return counts, maxes

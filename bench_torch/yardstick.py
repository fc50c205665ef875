"""The yardstick: peaks of the card, the least work of a call, and the
interval arithmetic the trace is read with.

The least work of a call is counted from the cell's CSR inputs alone,
never from a format, a plan or a kernel, so no change to the program can
move it:

- bytes: each input array read once, each output array written once
  (A's and B's values, column indices and row pointers, x; C's values,
  C's structure where the call produces it, y); no intermediate product;
- operations: 2 per intermediate product of a SpGEMM, 2 per stored entry
  of a SpMV, whatever the semiring.

The least time of a call is the larger of its bytes at the card's memory
bandwidth and its operations at the card's float rate outside the tensor
cores (NVIDIA H100 SXM data sheet, dense, at a 700 W power limit).
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
FLOPS_PER_S = {4: 67e12, 8: 34e12}  # by value size in bytes
INDEX_BYTES = 4  # int32 row pointers and column indices


def csr_bytes(n_rows: int, nnz: int, val_bytes: int) -> int:
    """A CSR's arrays: values, column indices and row pointers."""
    return nnz * (val_bytes + INDEX_BYTES) + (n_rows + 1) * INDEX_BYTES


def spgemm_work(a_shape, nnz_a: int, b_shape, nnz_b: int, nnz_c: int,
                n_products: int, val_bytes: int, structure: bool
                ) -> tuple[int, int]:
    """(operations, least bytes) of C = A @ B: A and B read once, C's
    values written once, and C's columns and row pointers too where the
    call produces them (``structure``)."""
    c_out = nnz_c * val_bytes
    if structure:
        c_out = csr_bytes(a_shape[0], nnz_c, val_bytes)
    read = (csr_bytes(a_shape[0], nnz_a, val_bytes)
            + csr_bytes(b_shape[0], nnz_b, val_bytes))
    return 2 * n_products, read + c_out


def spmv_work(shape, nnz: int, val_bytes: int) -> tuple[int, int]:
    """(operations, least bytes) of y = A (.) x: A and x read once, y
    written once."""
    m, n = shape
    return 2 * nnz, csr_bytes(m, nnz, val_bytes) + (n + m) * val_bytes


def least_seconds(ops: int, nbytes: int, val_bytes: int) -> float:
    return max(nbytes / HBM_BYTES_PER_S, ops / FLOPS_PER_S[val_bytes])


def union_seconds(intervals, lo: float, hi: float) -> float:
    """Length of the union of (start, end) intervals, clipped to
    [lo, hi]."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        s, e = max(s, lo), min(e, hi)
        if e <= s:
            continue
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def idle_gaps(intervals, lo: float, hi: float):
    """The (start, end) stretches of [lo, hi] that no interval covers."""
    gaps, t = [], lo
    for s, e in sorted(intervals):
        if s > t:
            gaps.append((t, min(s, hi)))
        t = max(t, e)
        if t >= hi:
            break
    if t < hi:
        gaps.append((t, hi))
    return [(s, e) for s, e in gaps if e > s]

"""Tile-subset gather, tile scatter, tile gather and windowed gather:
kernels K5, K6, K12 and K10.

Counterpart of ``nsparse_tpu/ops/kernels/gather_pallas.py``'s
``gather_subset_window``/``gather_subset_band`` (K5 ``gather_subset``),
``scatter_tiles`` (K6), ``gather_tiles8`` (K12) and ``windowed_gather``
(K10).  The TPU kernels
replace a gather the TPU lacks with roll-scans over a window or band;
Hopper gathers in hardware, so K5 reads each slot's source directly and
one launch serves every class of a flat gather (it takes a list of
equal units: ``flat_gather`` lists those of all its classes), and K10
reads ``win[t, idx]`` directly, a warp per row (a thread per output
from a 4 KB window).  K5 and K6 update their output in place,
as the JAX outputs are aliased.
"""

from __future__ import annotations

import torch

from nsparse_tpu_torch.ops.kernels import cuda_lib


def _positions(ids: torch.Tensor, unit: int) -> torch.Tensor:
    """Flat slot positions covered by the units ``ids``."""
    return (ids.long()[:, None] * unit
            + torch.arange(unit, device=ids.device)).reshape(-1)


def gather_subset_plain(src: torch.Tensor, idx: torch.Tensor,
                        ids: torch.Tensor, unit: int, out: torch.Tensor,
                        other: torch.Tensor | None = None) -> torch.Tensor:
    """Plain PyTorch version of K5 (updates ``out`` in place)."""
    pos = _positions(ids, unit)
    j = idx[pos].long()
    n_src = src.numel()
    if n_src:
        v = torch.where((j >= 0) & (j < n_src), src[j.clamp(0, n_src - 1)],
                        0)
    else:
        v = torch.zeros(j.shape, dtype=out.dtype, device=out.device)
    if other is not None:
        n_o = other.numel()
        v = v * torch.where(pos < n_o, other[pos.clamp(max=max(n_o - 1, 0))],
                            0)
    out[pos] = v
    return out


def gather_subset(src: torch.Tensor, idx: torch.Tensor, ids: torch.Tensor,
                  unit: int, out: torch.Tensor,
                  other: torch.Tensor | None = None) -> torch.Tensor:
    """K5: for every slot ``p`` of the units ``ids`` (``unit`` consecutive
    slots each), ``out[p] = src[idx[p]]`` (0 where ``idx[p]`` is outside
    ``src``), times ``other[p]`` when given (0 past its end).  Other
    slots of ``out`` are left as they are; returns ``out``.

    CPU tensors take :func:`gather_subset_plain`; CUDA tensors launch the
    kernel (``csrc/gather_subset.cu``) or raise.
    """
    if src.dtype != out.dtype or (other is not None
                                  and other.dtype != out.dtype):
        raise TypeError("gather_subset: src, other and out must share a dtype")
    if idx.numel() != out.numel() or out.numel() % unit:
        raise ValueError("gather_subset: idx and out must be whole units of "
                         "one length")
    if src.is_cpu:
        return gather_subset_plain(src, idx, ids, unit, out, other)
    # a null ``other`` reaches C as the pointer 0
    oth, n_oth = (0, 0) if other is None else (other, other.numel())
    if ids.numel():
        cuda_lib.launch("gather_subset", "nsp_gather_subset", src, src.numel(),
                        idx, ids, ids.numel(), unit, oth, n_oth, out)
        gather_subset.launches += 1
    else:
        cuda_lib.validate("gather_subset", src, idx, ids, oth, out)
    return out


gather_subset.launches = 0


def scatter_tiles_plain(dst: torch.Tensor, ids: torch.Tensor,
                        vals: torch.Tensor, tile: int) -> torch.Tensor:
    """Plain PyTorch version of K6 (updates ``dst`` in place)."""
    dst[_positions(ids, tile)] = vals.reshape(-1)
    return dst


def scatter_tiles(dst: torch.Tensor, ids: torch.Tensor, vals: torch.Tensor,
                  tile: int) -> torch.Tensor:
    """K6: ``dst[ids[i]*tile : (ids[i]+1)*tile] = vals[i*tile : ...]``, in
    place; returns ``dst``.

    CPU tensors take :func:`scatter_tiles_plain`; CUDA tensors launch the
    kernel (``csrc/scatter_tiles.cu``) or raise.
    """
    n = ids.numel()
    if vals.numel() != n * tile or vals.dtype != dst.dtype \
            or dst.numel() % tile:
        raise ValueError("scatter_tiles: dst must be whole tiles and vals "
                         "len(ids) tiles of dst's dtype")
    if dst.is_cpu:
        return scatter_tiles_plain(dst, ids, vals, tile)
    if n:
        cuda_lib.launch("scatter_tiles", "nsp_scatter_tiles", dst, ids, n,
                        vals, tile)
        scatter_tiles.launches += 1
    else:
        cuda_lib.validate("scatter_tiles", dst, ids, vals)
    return dst


scatter_tiles.launches = 0

TILE8 = 1024  # a gather_tiles8 tile: 8 rows of 128 slots on the TPU


def gather_tiles8_plain(src: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K12."""
    if src.numel() % TILE8:
        raise ValueError("gather_tiles8: src must be whole 1024-slot tiles")
    tiles = src.view(-1, TILE8)
    n_src = tiles.shape[0]
    j = ids.long()
    valid = (j >= 0) & (j < n_src)
    if not n_src:
        return torch.zeros(ids.numel() * TILE8, dtype=src.dtype,
                           device=src.device)
    out = tiles[j.clamp(0, n_src - 1)]
    return torch.where(valid[:, None], out, 0).reshape(-1)


def gather_tiles8(src: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """K12: ``out`` tile i (1024 slots) = ``src`` tile ``ids[i]``, a zero
    tile where ``ids[i]`` is outside ``src``; returns (len(ids) * 1024,).

    CPU tensors take :func:`gather_tiles8_plain`; CUDA tensors launch the
    kernel (``csrc/gather_tiles8.cu``) or raise.
    """
    if src.numel() % TILE8:
        raise ValueError("gather_tiles8: src must be whole 1024-slot tiles")
    if src.is_cpu:
        return gather_tiles8_plain(src, ids)
    n = ids.numel()
    out = src.new_empty(n * TILE8)
    if not n:
        cuda_lib.validate("gather_tiles8", src, ids)
        return out
    if src.data_ptr() % 16:
        raise ValueError("gather_tiles8: src must be 16-byte aligned")
    cuda_lib.launch("gather_tiles8", "nsp_gather_tiles8", src,
                    src.numel() // TILE8, ids, n, out)
    gather_tiles8.launches += 1
    return out


gather_tiles8.launches = 0


def windowed_gather_plain(win: torch.Tensor, idx: torch.Tensor,
                          window: int) -> torch.Tensor:
    """Plain PyTorch version of K10."""
    j = idx.long()
    inside = (j >= 0) & (j < window)
    return torch.where(inside, torch.gather(win, 1, j.clamp(0, window - 1)),
                       0)


# K10's routes, by the span of a row's window in bytes (window x value
# size): a warp per row reading the window directly, or a thread per
# output (the first design).  tools/k10_variants.py on an NVIDIA H100
# 80GB HBM3 at 700 W (PERF.md, K10): from 4 KB the thread route 0.7-3%
# faster than direct, below it 7-60% slower.
K10_DIRECT, K10_THREAD = 0, 1
THREAD_BYTES = 4096  # a thread per output from this span


def windowed_gather_route(window: int, itemsize: int) -> int:
    """K10's route for a window of ``window`` values of ``itemsize``
    bytes: ``K10_DIRECT`` or ``K10_THREAD``.  It depends on the window
    and the value size alone, never on the data."""
    return K10_DIRECT if window * itemsize < THREAD_BYTES else K10_THREAD


def windowed_gather(win: torch.Tensor, idx: torch.Tensor,
                    window: int) -> torch.Tensor:
    """K10: ``out[t, l] = win[t, idx[t, l]]`` for ``win`` of shape (T,
    max(window, 128)) and int32 ``idx`` of shape (T, 128) in
    ``[0, window)``.  An index outside ``[0, window)`` gives 0 (it never
    reads outside its row); any window from 1 to ``win.shape[1]`` is
    taken (the TPU kernel needs a divisor or a multiple of 128).

    CPU tensors take :func:`windowed_gather_plain`; CUDA tensors launch the
    kernel (``csrc/windowed_gather.cu``, on the route of
    :func:`windowed_gather_route`) or raise.
    """
    if win.dim() != 2 or idx.dim() != 2 or idx.shape[1] != 128 \
            or idx.shape[0] != win.shape[0]:
        raise ValueError("windowed_gather: win must be (T, >= window) and "
                         "idx (T, 128)")
    if not 0 < window <= win.shape[1]:
        raise ValueError(f"windowed_gather: window {window} outside "
                         f"[1, {win.shape[1]}]")
    if win.device.type == "cpu":
        return windowed_gather_plain(win, idx, window)
    out = torch.empty(idx.shape, dtype=win.dtype, device=win.device)
    if idx.numel():
        cuda_lib.launch("windowed_gather", "nsp_windowed_gather", win,
                        win.shape[1], idx, window, idx.shape[0], out,
                        windowed_gather_route(window, win.element_size()))
        windowed_gather.launches += 1
    else:
        cuda_lib.validate("windowed_gather", win, idx, out)
    return out


windowed_gather.launches = 0

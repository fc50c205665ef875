"""Tracing with ``torch.profiler`` (counterpart of
``nsparse_tpu/utils/profiling.py``).

``trace`` records the enclosed region (host ops, and the card's kernels
when there is a card) and writes one Chrome trace (``.json``, viewable in
Perfetto or ``chrome://tracing``) into a directory; ``profile_op`` wraps
one operation with warm-up, trace and timing.  The profiler may drop
device events, so its device times are a breakdown, not a measurement.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch

from nsparse_tpu_torch.utils.timing import on_cuda


@contextlib.contextmanager
def trace(trace_dir: str, cuda: bool | None = None):
    """Trace the enclosed region into ``trace_dir/trace_<pid>_<ns>.json``.
    ``cuda``: record the card's activity too (default: when PyTorch sees
    a card)."""
    from torch.profiler import ProfilerActivity, profile

    if cuda is None:
        cuda = torch.cuda.is_available()
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    os.makedirs(trace_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield trace_dir
    prof.export_chrome_trace(os.path.join(
        trace_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


def profile_op(fn, *args, trace_dir: str, warmup: int = 1, iters: int = 3):
    """Warm up, trace ``iters`` calls of ``fn(*args)`` (the card's activity
    too when an argument lies on a card) and return (result, mean ms per
    call by the host clock after a synchronise, trace_dir)."""
    cuda = on_cuda(args)

    def sync():
        if cuda:
            torch.cuda.synchronize()

    out = None
    for _ in range(max(warmup, 1)):
        out = fn(*args)
    sync()
    with trace(trace_dir, cuda=cuda):
        t0 = time.perf_counter()
        for _ in range(iters):
            out = fn(*args)
        sync()
        t1 = time.perf_counter()
    return out, (t1 - t0) * 1e3 / iters, trace_dir

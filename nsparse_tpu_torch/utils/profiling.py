"""Tracing with ``torch.profiler`` (counterpart of
``nsparse_tpu/utils/profiling.py``), and the port's own spans and
counters.

``trace`` records the enclosed region (host ops, and the card's kernels
when there is a card) and writes one Chrome trace (``.json``, viewable in
Perfetto or ``chrome://tracing``) into a directory; ``profile_op`` wraps
one operation with warm-up, trace and timing.  The profiler may drop
device events, so its device times are a breakdown, not a measurement.

The recorder: the program marks its stages with ``span(name)`` and counts
events with ``count(name)``; ``host_read`` is the one way its call paths
turn a device value into a Python number (a device-to-host read: counted
as ``sync``, timed as the span ``sync.<what>``), and ``synced(what)``
marks an op that synchronises implicitly.  Recording is off by default;
then each of these costs one check of ``RECORDING``.  ``recording()``
turns it on for its body; ``snapshot()`` gives, per span name, its count,
total and self seconds (self: the total less what its child spans
cover), and the counters, as plain numbers; ``reset()`` clears them.
While recording and under ``torch.profiler``, each span but the launch
path's also opens ``record_function("nsp.<name>")``, so the stages lie in
the profiler's trace on the card's clock; ``idle_by_span`` reads them
back against the card's idle gaps.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time

import torch

from nsparse_tpu_torch.utils.timing import on_cuda

TRACE_PREFIX = "nsp."


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


# -- the recorder ------------------------------------------------------------

RECORDING = False
_LOCK = threading.Lock()  # the aggregates: build spans run in threads
_SPANS: dict[str, list] = {}  # name: [count, total s, child s]
_COUNTS: dict[str, int] = {}
_LOCAL = threading.local()  # each thread's stack of open spans


class _Off:
    """The span handed out while recording is off.  Its methods are C
    functions that ignore their arguments (``"".format`` returns "", which
    is false, so an exception passes through), so entering and leaving it
    runs no Python frame."""

    __slots__ = ()
    __enter__ = __exit__ = "".format


_OFF = _Off()


class _Span:
    __slots__ = ("name", "rf", "t0", "child")

    def __init__(self, name: str, trace: bool):
        self.name = name
        self.rf = (torch.autograd.profiler.record_function(TRACE_PREFIX + name)
                   if trace and torch.autograd._profiler_enabled() else None)

    def __enter__(self):
        stack = getattr(_LOCAL, "stack", None)
        if stack is None:
            stack = _LOCAL.stack = []
        stack.append(self)
        self.child = 0.0
        if self.rf is not None:
            self.rf.__enter__()
        self.t0 = time.perf_counter()

    def __exit__(self, *exc):
        t = time.perf_counter() - self.t0
        if self.rf is not None:
            self.rf.__exit__(*exc)
        stack = _LOCAL.stack
        stack.pop()
        if stack:
            stack[-1].child += t
        with _LOCK:
            agg = _SPANS.get(self.name)
            if agg is None:
                agg = _SPANS[self.name] = [0, 0.0, 0.0]
            agg[0] += 1
            agg[1] += t
            agg[2] += self.child
        return False


def span(name: str, trace: bool = True):
    """A context manager timing its body as span ``name`` while recording
    (a no-op otherwise).  ``trace``: under ``torch.profiler`` the span also
    opens ``record_function("nsp.<name>")``; the launch path passes False
    (that costs microseconds a launch under the profiler)."""
    if not RECORDING:
        return _OFF
    return _Span(name, trace)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to counter ``name`` while recording."""
    if RECORDING:
        with _LOCK:
            _COUNTS[name] = _COUNTS.get(name, 0) + n


def synced(what: str):
    """Span ``sync.<what>`` around an op that waits for the card (a
    ``torch.nonzero``, a boolean mask, a copy to the host), counted as a
    ``sync``."""
    if not RECORDING:
        return _OFF
    count("sync")
    return _Span("sync." + what, True)


def host_read(x: torch.Tensor, what: str):
    """The Python number (int or float, by dtype) held by the one-element
    tensor ``x``: a device-to-host read, counted as ``sync`` and timed as
    span ``sync.<what>``."""
    if not RECORDING:
        return x.item()
    with synced(what):
        return x.item()


@contextlib.contextmanager
def recording():
    """Record spans and counters in the body (and restore the setting
    before it after)."""
    global RECORDING
    before, RECORDING = RECORDING, True
    try:
        yield
    finally:
        RECORDING = before


def snapshot() -> dict:
    """What was recorded: ``{"spans": {name: {"count", "total_s",
    "self_s"}}, "counters": {name: n}}``, plain numbers."""
    with _LOCK:
        return {
            "spans": {n: {"count": c, "total_s": t, "self_s": t - ch}
                      for n, (c, t, ch) in _SPANS.items()},
            "counters": dict(_COUNTS),
        }


def reset() -> None:
    """Forget every span and counter recorded so far."""
    with _LOCK:
        _SPANS.clear()
        _COUNTS.clear()


def table(snap: dict | None = None) -> str:
    """The recorder's table: each span (count, total and self ms), the
    longest total first, then each counter."""
    snap = snapshot() if snap is None else snap
    rows = [f"{'span':<32} {'count':>8} {'total ms':>12} {'self ms':>12}"]
    for name, s in sorted(snap["spans"].items(),
                          key=lambda kv: -kv[1]["total_s"]):
        rows.append(f"{name:<32} {s['count']:>8} {1e3 * s['total_s']:>12.3f} "
                    f"{1e3 * s['self_s']:>12.3f}")
    rows.append(f"{'counter':<32} {'n':>8}")
    rows += [f"{name:<32} {n:>8}"
             for name, n in sorted(snap["counters"].items())]
    return "\n".join(rows)


def idle_by_span(busy, spans, lo: float, hi: float) -> dict:
    """The card's idle seconds in [lo, hi] by the innermost span that
    covers each idle gap's midpoint ("" where none does).  ``busy``: the
    card's (start, end) intervals; ``spans``: one thread's (start, end,
    name) spans, each nested in another or apart, on the same clock."""
    gaps, t = [], lo
    for s, e in sorted(busy):
        if s >= hi:
            break
        if s > t:
            gaps.append((t, s))
        t = max(t, e)
    if t < hi:
        gaps.append((t, hi))
    spans = sorted(spans, key=lambda sp: (sp[0], -sp[1]))  # outer first
    out: dict[str, float] = {}
    open_, i = [], 0  # the spans open at the point: each inside the last
    for s, e in sorted(gaps, key=lambda g: g[0] + g[1]):
        mid = (s + e) / 2
        while i < len(spans) and spans[i][0] <= mid:
            while open_ and open_[-1][1] < spans[i][0]:
                open_.pop()
            open_.append(spans[i])
            i += 1
        while open_ and open_[-1][1] < mid:
            open_.pop()
        name = open_[-1][2] if open_ else ""
        out[name] = out.get(name, 0.0) + (e - s)
    return out

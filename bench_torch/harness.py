"""One run of one cell: set-up, the measured window, the traced window's
reading, and the comparison that decides ``correct``.

Everything that belongs to one configuration, traffic mix or metric is a
file found by name: ``generators/<config generator>.py``,
``entries/<traffic entry>.py`` and ``metrics/<metric name>.py`` (a
metric split by cells, ``<quantity>.<cells>``, may share its quantity's
reader).  The loop is closed, with one caller: each call of the entry
is followed by ``torch.cuda.synchronize()``.  A traced run first runs a
window of the same length without the profiler, whose calls give the
host's own enqueue time, then the traced window.
"""

from __future__ import annotations

import array
import dataclasses
import gc
import importlib.util
import os
import random
import subprocess
import sys
import time
import types

import numpy as np
import torch

import yardstick

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
TRACE_SECONDS = 2.0  # the traced window's length at most
BREAKDOWN_ENTRIES = 10
NAME_CHARS = 160  # a device op's name in the breakdown, cut to this


def load(kind: str, name: str):
    """The module ``<kind>/<name>.py`` of the benchmark."""
    path = os.path.join(BENCH_DIR, kind, f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"{kind}.{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(name: str):
    """The reader of metric ``name``: ``metrics/<name>.py``, or for a
    quantity split by cells (``<quantity>.<cells>``, such as
    ``gflops.reuse``) ``metrics/<quantity>.py``."""
    if not os.path.exists(os.path.join(BENCH_DIR, "metrics", f"{name}.py")):
        name = name.split(".")[0]
    return load("metrics", name)


def derive(seed: int, *path: int) -> int:
    """A seed for one use of the run's seed (a pattern, a pool)."""
    ss = np.random.SeedSequence([int(seed) % (1 << 64), *path])
    return int(ss.generate_state(1, dtype=np.uint64)[0] >> 1)


def log(*parts) -> None:
    print(*parts, file=sys.stderr, flush=True)


def card_line(device) -> str:
    """The card's name and power limit, as ``nvidia-smi`` reads them."""
    if device.type != "cuda":
        return "no card (host run)"
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader", "-i", str(device.index or 0)],
            capture_output=True, text=True, timeout=30, check=True)
        return out.stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return torch.cuda.get_device_name(device)


@dataclasses.dataclass
class Context:
    """What an entry's set-up gets: the configuration and traffic, the
    program, the device, the graph maker and a generator for its pools."""

    cfg: dict
    traffic: dict
    program: types.ModuleType
    device: torch.device
    seed: int
    gen: types.ModuleType

    def graph(self, pattern: int = 0):
        return self.gen.generate(self.cfg, pattern,
                                 derive(self.seed, 1, pattern), self.device)

    def rng(self, use: int) -> torch.Generator:
        return self.gen.device_generator(derive(self.seed, 2, use),
                                         self.device)


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Samples:
    """A reservoir of ``per_pool`` outputs for each pool input, drawn
    from the seed: the answers compared once the window has closed."""

    def __init__(self, pool: int, per_pool: int, seed: int):
        self.rng = random.Random(derive(seed, 3))
        self.per_pool = per_pool
        self.seen = [0] * pool
        self.kept = [[] for _ in range(pool)]

    def offer(self, k: int, out) -> None:
        self.seen[k] += 1
        kept = self.kept[k]
        if len(kept) < self.per_pool:
            kept.append(out)
            return
        j = self.rng.randrange(self.seen[k])
        if j < self.per_pool:
            kept[j] = out

    def items(self):
        return [(k, out) for k, outs in enumerate(self.kept) for out in outs]


def _event_ns(e, what):
    return getattr(e, f"{what}_ns")() if hasattr(e, f"{what}_ns") else \
        int(getattr(e, f"{what}_us")() * 1000)


def read_trace(prof):
    """The profiler's events as (device ops, host spans): each a list of
    (start s, end s, name), device ops on the card, host spans the
    harness's own ``bench.*`` annotations."""
    device, host = [], []
    for e in prof.profiler.kineto_results.events():
        start = _event_ns(e, "start") * 1e-9
        end = start + e.duration_ns() * 1e-9 if hasattr(e, "duration_ns") \
            else start + e.duration_us() * 1e-6
        name = e.name()
        if name.startswith("bench."):  # on the card's rows too: skip those
            if e.device_type() != torch.autograd.DeviceType.CUDA:
                host.append((start, end, name[len("bench."):]))
        elif e.device_type() == torch.autograd.DeviceType.CUDA:
            device.append((start, end, name))
    return device, host


def is_kernel(name: str) -> bool:
    return not name.startswith(("Memcpy", "Memset"))


def trace_summary(device_ops, host_spans):
    """The traced window (first call's start to last synchronise's end),
    the device's busy seconds in it, its kernels, and the breakdown."""
    lo = min(s for s, _, _ in host_spans)
    hi = max(e for _, e, _ in host_spans)
    ops = [(s, e, n) for s, e, n in device_ops if e > lo and s < hi]
    intervals = [(s, e) for s, e, _ in ops]
    busy = yardstick.union_seconds(intervals, lo, hi)
    by_name = {}
    for s, e, n in ops:
        by_name[n] = by_name.get(n, 0.0) + (e - s)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:BREAKDOWN_ENTRIES]
    spans = sorted(host_spans)
    starts = np.array([s for s, _, _ in spans])

    def label(t):
        i = int(np.searchsorted(starts, t, "right")) - 1
        if i >= 0 and spans[i][1] >= t:
            return spans[i][2]
        return "harness"

    gaps = [(e - s, label((s + e) / 2))
            for s, e in yardstick.idle_gaps(intervals, lo, hi)]
    totals = {}
    for d, lab in gaps:
        totals[lab] = totals.get(lab, 0.0) + d
    idle = [[f"{lab} (all gaps)", d] for lab, d in
            sorted(totals.items(), key=lambda kv: -kv[1])]
    idle += [[lab, d] for d, lab in sorted(gaps, reverse=True)]
    return types.SimpleNamespace(
        window_s=hi - lo, busy_s=busy,
        kernels=sum(1 for _, _, n in ops if is_kernel(n)),
        breakdown={
            "device_ops": [[n[:NAME_CHARS], t] for n, t in top],
            "idle_gaps": idle[:BREAKDOWN_ENTRIES],
        })


def run_window(call, pool: int, seconds: float, device, samples: Samples,
               spans: bool):
    """Calls of the pool in turn, each followed by a synchronise, until
    ``seconds`` have passed; returns ([(pool input, host seconds from the
    call to its return)], the window's seconds).  ``spans``: each call
    and synchronise in a ``bench.*`` span of the profiler."""
    from torch.profiler import record_function

    ks, enq = array.array("l"), array.array("d")
    t_w0 = time.perf_counter()
    i = 0
    while True:
        k = i % pool
        t0 = time.perf_counter()
        if spans:
            with record_function("bench.call"):
                out = call(k)
            t_enq = time.perf_counter()
            with record_function("bench.sync"):
                sync(device)
        else:
            out = call(k)
            t_enq = time.perf_counter()
            sync(device)
        t1 = time.perf_counter()
        ks.append(k)
        enq.append(t_enq - t0)
        samples.offer(k, out)
        del out
        i += 1
        if t1 - t_w0 >= seconds:
            return list(zip(ks, enq)), t1 - t_w0


def run_cell(cfg: dict, traffic: dict, seed: int, seconds: float,
             trace: bool, device, metrics: list, t_start: float,
             control: bool = False) -> dict:
    """One run of a cell (a configuration under a traffic mix); returns
    the result line as a dict.

    ``metrics``: the entries of BENCHMARK.json to report (end-to-end ones
    without ``trace``, per-layer ones with it).  ``control``: the entry's
    control takes the program's place (readings only; no run of the
    benchmark sets it).  ``t_start``: the host clock at the process's
    start, where set-up begins."""
    import nsparse_tpu_torch as program

    device = torch.device(device)
    log(f"card: {card_line(device)}")
    t_import = time.perf_counter()
    ctx = Context(cfg=cfg, traffic=traffic, program=program, device=device,
                  seed=seed, gen=load("generators", cfg["generator"]))
    entry = load("entries", traffic["entry"]).setup(ctx)
    sync(device)
    t_made = time.perf_counter()
    log(f"work of pool input 0: {entry.work[0][0]} operations, "
        f"{entry.work[0][1]} least bytes")
    call = entry.control if control else entry.call
    pool = entry.pool
    for _ in range(traffic["warmup_rounds"]):
        for k in range(pool):
            call(k)
    sync(device)
    t_warm = time.perf_counter()
    setup_s = t_warm - t_start

    window = min(seconds, TRACE_SECONDS) if trace else seconds
    samples = Samples(pool, traffic["samples_per_pool"], seed)
    # what set-up left behind is no garbage: keep the collector off it
    gc.collect()
    gc.freeze()
    calls, window_s = run_window(call, pool, window, device, samples, False)
    untraced = calls
    summary = None
    if trace:
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        with profile(activities=acts) as prof:
            calls, window_s = run_window(call, pool, window, device,
                                         samples, True)
        t_r = time.perf_counter()
        summary = trace_summary(*read_trace(prof))
        del prof
        log(f"trace read in {time.perf_counter() - t_r:.3f} s")
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)

    ops = sum(entry.work[k][0] for k, _ in calls)
    least = sum(yardstick.least_seconds(*entry.work[k], entry.val_bytes)
                for k, _ in calls)
    run = types.SimpleNamespace(
        calls=calls, untraced=untraced, window_s=window_s, ops=ops,
        least_s=least,
        prep_s=entry.prep_s, setup_s=setup_s, trace=summary)

    # the program's state goes before the reference runs
    entry.release()
    sync(device)
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t_c = time.perf_counter()
    readings = {}
    failed = 0
    limits = traffic["limits"]
    for k, out in samples.items():
        gaps = entry.check(k, out)
        if any(gaps.get(n, float("inf")) > lim for n, lim in limits.items()):
            failed += 1
        for n, v in gaps.items():
            readings[n] = max(readings.get(n, 0.0), v)
    t_done = time.perf_counter()
    correct = bool(samples.items()) and failed == 0 and all(
        readings.get(n, float("inf")) <= lim for n, lim in limits.items())
    log(f"set-up split (s): imports and card query "
        f"{t_import - t_start:.3f}, generation "
        f"and prep {t_made - t_import:.3f} (prep {entry.prep_s}), warm-up "
        f"{t_warm - t_made:.3f}; reference {t_done - t_c:.3f} over "
        f"{len(samples.items())} answers; calls {len(calls)} in "
        f"{window_s:.3f} s" + (f" traced, {len(untraced)} untraced"
                               if trace else ""))

    values = {}
    for m in metrics:
        v = reader(m["name"]).read(run)
        if v is not None:
            values[m["name"]] = {"value": v, "unit": m["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu"),
           "count": 1, "memory_peak_bytes": int(peak)}
    attempted = len(untraced) + (len(calls) if trace else 0)
    result = {"correct": correct, "attempted": attempted, "failed": failed,
              "metrics": values, "device": dev}
    if summary is not None:
        dev["busy_s"] = summary.busy_s
        dev["window_s"] = summary.window_s
        result["breakdown"] = summary.breakdown
    result["checks"] = {n: {"value": readings.get(n, float("inf")),
                            "limit": lim} for n, lim in limits.items()}
    return result

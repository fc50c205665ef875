#!/usr/bin/env python3
"""The program's own spans and counters in one cell of the benchmark.

    python3 tools/trace_cells.py --workload <name> --seed <n> \
        --out <file.jsonl> [--seconds 2]

from the repository's root, on a card.  It sets the cell up as
``bench_torch/run.py`` does (the benchmark's configuration, traffic,
generator and entry, read, not changed) and then, with the recorder of
``nsparse_tpu_torch.utils.profiling``:

1. set-up and warm-up recorded: the ``prep.*`` spans beside the entry's
   ``prep_s``, and the ``build`` counters;
2. three pairs of windows, one with the recorder off and one recorded
   (no profiler), in turn: each window's mean host enqueue time per call
   (the benchmark's ``enqueue_ms``; the medians' ratio is the
   recorder's cost when on), and over the recorded windows, per call,
   the host reads (counter ``sync``), their wait (the ``sync.*`` spans),
   the launch path's host time (span ``launch``), each span's count,
   total and self ms;
3. one call under ``torch.cuda.set_sync_debug_mode("warn")``: every op
   that synchronised, by the line that called it, against the ``sync``
   counter of that call;
4. a window recorded under ``torch.profiler``: the card's idle seconds by
   the innermost span covering each gap (``idle_by_span``), the ``nsp.*``
   spans beside the benchmark's ``bench.call`` and ``bench.sync``;
5. the recorder's cost when off: ns per ``with span(...)`` block, per
   ``count`` and per launch-path check, in loops of a million.

Prints a summary and appends one JSON line to ``--out``.
"""

import argparse
import json
import linecache
import os
import statistics
import sys
import time
import warnings

T_START = time.perf_counter()
ROUNDS = 3  # pairs of windows, recorder off then on
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = os.path.join(ROOT, "bench_torch")
sys.path[:0] = [ROOT, BENCH]

import torch  # noqa: E402

import harness  # noqa: E402
import run as bench_run  # noqa: E402
from nsparse_tpu_torch.utils import profiling  # noqa: E402


def stats(snap: dict, calls: int) -> dict:
    """Per call: each span's count and total / self ms, each counter."""
    spans = {n: {"count": s["count"] / calls,
                 "total_ms": 1e3 * s["total_s"] / calls,
                 "self_ms": 1e3 * s["self_s"] / calls}
             for n, s in snap["spans"].items()}
    syncs = sum(s["total_s"] for n, s in snap["spans"].items()
                if n.startswith("sync."))
    launch = snap["spans"].get("launch", {"count": 0, "total_s": 0.0})
    return {
        "calls": calls,
        "host_syncs_per_call": snap["counters"].get("sync", 0) / calls,
        "sync_wait_ms": 1e3 * syncs / calls,
        "launch_ms": 1e3 * launch["total_s"] / calls,
        "launches_per_call": launch["count"] / calls,
        "spans_per_call": sum(s["count"] for n, s in snap["spans"].items()
                              if n != "launch") / calls,
        "spans": spans,
        "counters": {n: v / calls for n, v in snap["counters"].items()},
    }


def sync_debug(call, device) -> dict:
    """The synchronising ops that ``torch.cuda.set_sync_debug_mode``
    reports in one call, less those it reports around no call at all (the
    mode's own switch), by the line that ran them; and the recorder's
    ``sync`` count of the call."""

    def reported(body):
        harness.sync(device)
        profiling.reset()
        with warnings.catch_warnings(record=True) as caught, \
                profiling.recording():
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                out = body()
            finally:
                torch.cuda.set_sync_debug_mode("default")
        harness.sync(device)
        del out
        counted = profiling.snapshot()["counters"].get("sync", 0)
        profiling.reset()
        return [f"{os.path.relpath(w.filename, ROOT)}:{w.lineno}: "
                + linecache.getline(w.filename, w.lineno).strip()
                for w in caught if "synchroniz" in str(w.message)], counted

    control, _ = reported(lambda: None)
    ops, counted = reported(lambda: call(0))
    for op in control:
        if op in ops:
            ops.remove(op)
    return {"ops": ops, "n_ops": len(ops), "counted": counted,
            "control": control}


def trace_events(prof):
    """(card intervals, host spans): the card's ops, and the host's
    ``bench.*`` and ``nsp.*`` ranges as (start s, end s, name), and the
    count of ``nsp.*`` ranges the profiler mirrored onto the card's rows
    (left out, as ``harness.read_trace`` leaves out ``bench.*``)."""
    busy, spans, mirrored = [], [], 0
    for e in prof.profiler.kineto_results.events():
        start = harness._event_ns(e, "start") * 1e-9
        end = start + e.duration_ns() * 1e-9
        name = e.name()
        on_card = e.device_type() == torch.autograd.DeviceType.CUDA
        if name.startswith(("bench.", profiling.TRACE_PREFIX)):
            if not on_card:
                spans.append((start, end, name))
            else:
                mirrored += name.startswith(profiling.TRACE_PREFIX)
        elif on_card:
            busy.append((start, end))
    return busy, spans, mirrored


def idle_labels(prof) -> dict:
    busy, spans, mirrored = trace_events(prof)
    bench = [s for s in spans if s[2].startswith("bench.")]
    lo = min(s for s, _, _ in bench)
    hi = max(e for _, e, _ in bench)
    idle = profiling.idle_by_span(busy, spans, lo, hi)
    in_call = {n: t for n, t in idle.items()
               if n not in ("", "bench.sync")}
    staged = sum(t for n, t in in_call.items()
                 if n.startswith(("nsp.numeric.", "nsp.sync.", "nsp.spmv.",
                                  "nsp.plan_device.")))
    total = sum(in_call.values())
    return {
        "window_s": hi - lo,
        "busy_s": harness.yardstick.union_seconds(busy, lo, hi),
        "idle_s": sum(idle.values()),
        "idle_in_call_s": total,
        "stage_share_of_call_idle": staged / total if total else None,
        "idle_by_span_s": dict(sorted(idle.items(), key=lambda kv: -kv[1])),
        "nsp_ranges_on_card_rows": mirrored,
    }


def off_cost(n: int = 1_000_000) -> dict:
    """ns per off-mode span block, ``count`` and launch-path check, each
    less an empty loop; the median of 5 rounds."""
    assert not profiling.RECORDING
    span, count = profiling.span, profiling.count

    def empty():
        for _ in range(n):
            pass

    def spans():
        for _ in range(n):
            with span("x"):
                pass

    def counts():
        for _ in range(n):
            count("x")

    def checks():
        for _ in range(n):
            if profiling.RECORDING:
                pass

    def timed(f):
        t0 = time.perf_counter()
        f()
        return (time.perf_counter() - t0) * 1e9 / n

    rounds = {k: [] for k in ("span", "count", "check")}
    for _ in range(5):
        base = timed(empty)
        rounds["span"].append(timed(spans) - base)
        rounds["count"].append(timed(counts) - base)
        rounds["check"].append(timed(checks) - base)
    return {k + "_ns": statistics.median(v) for k, v in rounds.items()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--out", required=True,
                    help="JSON lines file the result is appended to")
    args = ap.parse_args(argv)
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    cell, cfg, traffic, _, _ = bench_run.cell_files(bench, args.workload)
    if not torch.cuda.is_available():
        print("needs a card", file=sys.stderr)
        return 2
    import nsparse_tpu_torch as program
    from torch.profiler import ProfilerActivity, profile

    device = torch.device("cuda:0")
    res = {"workload": args.workload, "seed": args.seed,
           "card": harness.card_line(device)}
    ctx = harness.Context(cfg=cfg, traffic=traffic, program=program,
                          device=device, seed=args.seed,
                          gen=harness.load("generators", cfg["generator"]))
    profiling.reset()
    with profiling.recording():
        entry = harness.load("entries", traffic["entry"]).setup(ctx)
        for _ in range(traffic["warmup_rounds"]):
            for k in range(entry.pool):
                entry.call(k)
        harness.sync(device)
    setup = profiling.snapshot()
    profiling.reset()
    sp = setup["spans"]
    prep = {n: s["total_s"] for n, s in sp.items()
            if n.startswith("prep.")}
    res["setup"] = {"setup_s": time.perf_counter() - T_START,
                    "prep_s": entry.prep_s, "prep_spans_s": prep,
                    "counters": setup["counters"],
                    "build_s": sp.get("build", {}).get("total_s", 0.0)}
    if entry.prep_s:
        inside = sum(prep.get(n, 0.0) for n in (
            "prep.symbolic", "prep.layout", "prep.ell", "prep.to_device"))
        res["setup"]["prep_spans_over_prep_s"] = inside / entry.prep_s

    samples = harness.Samples(entry.pool, traffic["samples_per_pool"],
                              args.seed)
    off, on, n_rec = [], [], 0
    for _ in range(ROUNDS):  # off and recorded windows in turn
        calls, _ = harness.run_window(entry.call, entry.pool, args.seconds,
                                      device, samples, False)
        off.append(1e3 * statistics.fmean(e for _, e in calls))
        with profiling.recording():
            calls, _ = harness.run_window(entry.call, entry.pool,
                                          args.seconds, device, samples,
                                          False)
        on.append(1e3 * statistics.fmean(e for _, e in calls))
        n_rec += len(calls)
    res["recorded"] = stats(profiling.snapshot(), n_rec)
    profiling.reset()
    off_enq, on_enq = statistics.median(off), statistics.median(on)
    res["enqueue_ms"] = {"off": off, "recorded": on,
                         "on_cost_pct": 100 * (on_enq / off_enq - 1)}
    res["sync_debug"] = sync_debug(entry.call, device)

    with profiling.recording(), profile(activities=[
            ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        calls, _ = harness.run_window(entry.call, entry.pool,
                                      args.seconds, device, samples, True)
    profiling.reset()
    res["traced"] = {"calls": len(calls), **idle_labels(prof)}
    del prof
    res["off_cost"] = off_cost()
    r = res["recorded"]
    res["off_cost"]["per_call_ns"] = (
        r["spans_per_call"] * res["off_cost"]["span_ns"]
        + r["launches_per_call"] * res["off_cost"]["check_ns"])
    res["off_cost"]["per_call_pct_of_enqueue"] = (
        1e-4 * res["off_cost"]["per_call_ns"] / off_enq)

    entry.release()
    print(json.dumps(res, indent=1))
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "a") as f:
        f.write(json.dumps(res) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())

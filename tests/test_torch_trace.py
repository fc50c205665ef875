"""The port's recorder (``nsparse_tpu_torch.utils.profiling``): spans,
counters and host reads, on the CPU.

Spans are timed with a fake clock where the numbers are asserted; the
program's spans are checked by name and count on the main paths (the
device planner's host reads, the window numeric phase's stages, the
launch path with the C call stubbed), and the ``nsp.*`` names in a CPU
``torch.profiler`` trace.
"""

import itertools
import types

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import nsparse_tpu_torch as nt
import nsparse_tpu_torch.ops.spgemm_window as twin
from nsparse_tpu_torch.ops.kernels import cuda_lib
from nsparse_tpu_torch.utils import profiling


@pytest.fixture(autouse=True)
def clean_recorder():
    profiling.reset()
    assert not profiling.RECORDING
    yield
    profiling.reset()
    assert not profiling.RECORDING


@pytest.fixture
def clock(monkeypatch):
    """perf_counter ticks 1, 2, 3, ... seconds, one a read."""
    ticks = itertools.count(1)
    monkeypatch.setattr(profiling.time, "perf_counter",
                        lambda: float(next(ticks)))


def _spans():
    return profiling.snapshot()["spans"]


def _counters():
    return profiling.snapshot()["counters"]


def test_nested_spans_give_totals_and_self_times(clock):
    with profiling.recording():
        with profiling.span("outer"):          # t0 = 1
            with profiling.span("inner"):      # 2 .. 3: 1 s
                pass
            with profiling.span("inner"):      # 4 .. 7: 3 s
                with profiling.span("leaf"):   # 5 .. 6: 1 s
                    pass
        # outer ends at 8: 7 s
    s = _spans()
    assert s["outer"] == {"count": 1, "total_s": 7.0, "self_s": 3.0}
    assert s["inner"] == {"count": 2, "total_s": 4.0, "self_s": 3.0}
    assert s["leaf"] == {"count": 1, "total_s": 1.0, "self_s": 1.0}


def test_recording_off_records_nothing():
    with profiling.span("a"):
        profiling.count("b", 5)
        assert profiling.host_read(torch.tensor(7), "x") == 7
        with profiling.synced("y"):
            pass
    assert profiling.span("a") is profiling.span("b")  # the shared no-op
    assert profiling.snapshot() == {"spans": {}, "counters": {}}
    with profiling.recording():
        pass
    assert profiling.snapshot() == {"spans": {}, "counters": {}}


def test_an_exception_passes_through_spans_either_way():
    for on in (False, True):
        with pytest.raises(KeyError):
            with profiling.recording() if on else profiling.span("x"):
                with profiling.span("x"):
                    raise KeyError("k")
        assert not profiling.RECORDING
    assert _spans()["x"]["count"] == 1


def test_counters_add_up_and_reset_clears():
    with profiling.recording():
        profiling.count("a")
        profiling.count("a", 4)
        profiling.count("b", 2)
        with profiling.span("s"):
            pass
    assert _counters() == {"a": 5, "b": 2}
    profiling.reset()
    assert profiling.snapshot() == {"spans": {}, "counters": {}}


def test_host_read_counts_and_returns_python_numbers():
    with profiling.recording():
        n = profiling.host_read(torch.arange(5).sum(), "total")
        f = profiling.host_read(torch.tensor([0.5]).max(), "peak")
    assert (n, type(n)) == (10, int) and (f, type(f)) == (0.5, float)
    assert _counters() == {"sync": 2}
    assert {n: s["count"] for n, s in _spans().items()} == {
        "sync.total": 1, "sync.peak": 1}


def test_the_device_planner_counts_its_host_reads():
    """``spgemm(a, a)`` with the device planner makes six host reads:
    three sizes and the ``torch.nonzero`` of the segment starts in the
    planner, and the segmented sum's two assignments of host scalars."""
    a = nt.rmat_csr(8, 4, dtype=np.float32)
    with profiling.recording():
        c = nt.spgemm(a, a)
    ref = (a.to_scipy() @ a.to_scipy()).tocsr()
    assert c.nnz == ref.nnz
    assert _counters() == {"sync": 6}
    counts = {n: s["count"] for n, s in _spans().items()}
    assert counts == {
        "spgemm": 1, "spgemm_numeric": 1,
        "plan_device.expand": 1, "plan_device.sort": 1,
        "plan_device.boundaries": 1,
        "sync.p_total": 1, "sync.c_nnz": 1, "sync.nonzero": 1,
        "sync.max_len": 1, "sync.scan_head": 1, "sync.scan_starts": 1,
        "numeric.sort.products": 1, "numeric.sort.segsum": 1,
    }
    s = _spans()
    # the reads are children of the planner's stages
    assert s["plan_device.boundaries"]["self_s"] <= \
        s["plan_device.boundaries"]["total_s"] - s["sync.c_nnz"]["total_s"]


def _fallback_heavy():
    """256 rows of 4 entries and two dense rows: with the window ladder
    capped at 1024 slots, a window plan with a fallback pool."""
    rng = np.random.default_rng(11)
    m = 256
    rows, cols = [], []
    for r in range(m):
        rows += [r] * 4
        cols += list(rng.choice(m, size=4, replace=False))
    for r in (3, 100):
        rows += [r] * m
        cols += list(range(m))
    s = sp.csr_matrix((rng.standard_normal(len(rows)), (rows, cols)),
                      shape=(m, m))
    s.sum_duplicates()
    return nt.CSR.from_scipy(s, dtype=np.float32)


@pytest.mark.parametrize("form", ["v1", "v2"])
def test_window_numeric_records_each_stage_once_a_call(monkeypatch, form):
    import nsparse_tpu_torch.tune.kernelgen as tkg

    monkeypatch.setattr(tkg, "N_WIN_CLASSES", 2)
    if form == "v1":
        monkeypatch.setattr(twin, "FUSED_BANK_BUDGET", 0)
    a = _fallback_heavy()
    with profiling.recording():
        plan = nt.spgemm_plan(a, a, shuffle=True, layout="window")
        assert plan.win.fused_expand == (form == "v2")
        assert plan.win.fb_shuffle is not None
        profiling.reset()
        for _ in range(2):
            c = nt.spgemm_numeric(plan, a, a)
    first = "expand" if form == "v1" else "delivery"
    stages = [f"numeric.window.{s}"
              for s in (first, "classes", "fallback", "merge")]
    counts = {n: s["count"] for n, s in _spans().items()}
    assert counts == {"spgemm_numeric": 2, **{s: 2 for s in stages}}
    # no host read and no launch off the card; the fallback stage counts
    # its entries and products from the plan
    fb = plan.win.fb
    assert _counters() == {"numeric.window.fallback.entries": 2 * fb.n_out,
                           "numeric.window.fallback.products":
                               2 * fb.n_products}
    ref = (a.to_scipy() @ a.to_scipy()).toarray()
    np.testing.assert_allclose(c.to_dense().numpy(), ref, rtol=1e-5,
                               atol=1e-5)


@pytest.fixture
def small_xshuffle(monkeypatch):
    """The x-shuffle plans for a small matrix too."""
    from nsparse_tpu_torch.formats import ell

    monkeypatch.setattr(ell, "XSH_MIN_SLOTS", 0)


def test_preparation_spans(small_xshuffle):
    a = nt.rmat_csr(8, 4, dtype=np.float32)
    with profiling.recording():
        nt.spgemm_plan(a, a).to("cpu")
        nt.ELL.from_csr(a, min_width=2, xshuffle=True).to("cpu")
    counts = {n: s["count"] for n, s in _spans().items()}
    assert {n: c for n, c in counts.items() if n != "build"} == {
        "prep.symbolic": 1, "prep.layout": 1, "prep.to_device": 2,
        "prep.ell": 1, "prep.ell.slabs": 1, "prep.ell.gather_plans": 1,
        "prep.ell.xshuffle": 1,
    }
    s = _spans()
    children = sum(s[f"prep.ell.{n}"]["total_s"]
                   for n in ("slabs", "gather_plans", "xshuffle"))
    assert s["prep.ell"]["self_s"] == pytest.approx(
        s["prep.ell"]["total_s"] - children)


def test_spmv_ell_stages(small_xshuffle):
    a = nt.rmat_csr(8, 4, dtype=np.float32)
    ell = nt.ELL.from_csr(a, min_width=2, xshuffle=True)
    x = torch.ones(a.shape[1])
    with profiling.recording():
        nt.spmv(ell, x)
        nt.spmv(ell, x, semiring="min_plus")
    counts = {n: s["count"] for n, s in _spans().items()}
    assert counts == {"spmv": 2, "spmv.gather_x": 1, "spmv.slabs": 2,
                      "spmv.rows": 2}


def test_launch_path_counts_launches_that_return(monkeypatch):
    calls = []
    monkeypatch.setattr(cuda_lib, "validate", lambda what, *args: (
        0, torch.float32, list(args)))
    monkeypatch.setattr(cuda_lib, "_RESOLVED", {
        ("nsp_gather", torch.float32): lambda *a: calls.append(a) or 0,
        ("nsp_runcopy", torch.float32): lambda *a: 716})
    monkeypatch.setattr(cuda_lib, "KERNELS", types.SimpleNamespace(
        get=lambda: types.SimpleNamespace(
            nsp_error_string=lambda rc: b"stub error")))
    monkeypatch.setattr(cuda_lib, "_current_device", lambda: 0)
    monkeypatch.setattr(cuda_lib, "_raw_stream", lambda i: 7)
    cuda_lib.launch("gather", "nsp_gather", 1, 2)
    assert profiling.snapshot() == {"spans": {}, "counters": {}}
    with profiling.recording():
        for _ in range(3):
            cuda_lib.launch("gather", "nsp_gather", 1, 2)
        with pytest.raises(RuntimeError, match="stub error"):
            cuda_lib.launch("runcopy", "nsp_runcopy", 1)
    assert calls == [(1, 2, 7)] * 4
    assert _counters() == {"launch.nsp_gather": 3}
    assert _spans()["launch"]["count"] == 4


def test_build_counters(tmp_path, monkeypatch):
    from nsparse_tpu_torch import buildlib

    monkeypatch.setattr(buildlib, "BUILD_DIR", str(tmp_path))
    src = tmp_path / "one.cpp"
    src.write_text('extern "C" int nsp_one(void) { return 1; }\n')
    cmd = ["g++", "-O1", "-shared", "-fPIC"]
    with profiling.recording():
        lib = buildlib.build_shared("libone", [str(src)], cmd, timeout=120)
        buildlib.build_shared("libone", [str(src)], cmd, timeout=120)
    assert lib.nsp_one() == 1
    assert _counters() == {"build.compiled": 1, "build.cached": 1}
    assert _spans()["build"]["count"] == 2


def test_spans_reach_the_profilers_trace():
    from torch.profiler import ProfilerActivity, profile

    a = nt.rmat_csr(8, 4, dtype=np.float32)
    with profiling.recording(), \
            profile(activities=[ProfilerActivity.CPU]) as prof:
        nt.spgemm(a, a)
    names = {e.name for e in prof.events()}
    assert {"nsp.spgemm", "nsp.plan_device.sort", "nsp.sync.c_nnz",
            "nsp.numeric.sort.segsum"} <= names
    # without the recorder the program leaves nothing in the trace
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        nt.spgemm(a, a)
    assert not any(e.name.startswith("nsp.") for e in prof.events())


def test_table_lists_spans_and_counters(clock):
    with profiling.recording():
        with profiling.span("stage"):
            profiling.count("launch.nsp_gather", 2)
    rows = profiling.table().splitlines()
    assert rows[1].split() == ["stage", "1", "1000.000", "1000.000"]
    assert rows[-1].split() == ["launch.nsp_gather", "2"]


def test_idle_gaps_take_the_innermost_span():
    """Card busy over [1, 2] and [4, 5] of a window [0, 7]; gaps at
    [0, 1], [2, 4], [5, 7].  The first lies in ``stage`` (inside
    ``call``), the second's midpoint 3 in ``read`` (inside ``stage``), the
    third half outside ``call``: its midpoint 6 lies in no span."""
    busy = [(4, 5), (1, 2), (1.5, 1.8)]
    spans = [(0, 5.5, "call"), (2.5, 3.5, "read"), (0, 4, "stage")]
    assert profiling.idle_by_span(busy, spans, 0, 7) == {
        "stage": 1, "read": 2, "": 2}
    # a gap whose midpoint lies in the parent only, after a child ended
    assert profiling.idle_by_span([(0, 1), (3, 4)], [
        (0, 4, "call"), (0.2, 1.5, "stage")], 0, 4) == {"call": 2}
    assert profiling.idle_by_span([(0, 4)], spans, 0, 4) == {}


@pytest.mark.parametrize("argv, rows", [
    (["spmv", "gen:rmat:8:4", "--format", "ell"],
     ["prep.ell", "prep.ell.slabs", "prep.to_device", "spmv", "spmv.slabs"]),
    (["spgemm", "gen:rmat:8:4", "--method", "esc", "--planner", "host"],
     ["prep.symbolic", "prep.layout", "prep.to_device", "spgemm_numeric",
      "numeric.sort.segsum"]),
    (["spgemm", "gen:rmat:8:4", "--method", "esc", "--planner", "device"],
     ["plan_device.sort", "sync.c_nnz", "spgemm_numeric"]),
], ids=["spmv-ell", "spgemm-host", "spgemm-device"])
def test_cli_profile_prints_the_recorder_table(tmp_path, capsys, argv,
                                               rows):
    from nsparse_tpu_torch.cli import main

    rc = main(["--precision", "single", *argv, "--trials", "1", "--device",
               "cpu", "--profile", str(tmp_path)])
    out = capsys.readouterr().out
    assert rc == 0 and f"trace written to {tmp_path}" in out, out
    table = out[out.index("span "):]
    names = {line.split()[0] for line in table.splitlines()}
    assert set(rows) <= names, table
    assert not profiling.RECORDING  # the timed trials run unrecorded


def test_threads_lose_no_update():
    """Spans and counts from more threads than cores (the kernel builds run
    in a pool) add up exactly; each thread nests its own spans."""
    import os
    import sys
    import threading

    n_threads, n = 2 * (os.cpu_count() or 2), 500
    errors = []

    def work():
        try:
            for _ in range(n):
                with profiling.span("outer"):
                    with profiling.span("inner"):
                        profiling.count("c")
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(e)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with profiling.recording():
            threads = [threading.Thread(target=work)
                       for _ in range(n_threads)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not errors and not any(t.is_alive() for t in threads)
    s = _spans()
    assert _counters() == {"c": n_threads * n}
    assert s["outer"]["count"] == s["inner"]["count"] == n_threads * n
    assert s["outer"]["self_s"] == pytest.approx(
        s["outer"]["total_s"] - s["inner"]["total_s"])

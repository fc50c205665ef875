"""The launch path (``cuda_lib.launch``) of every kernel wrapper: K6
scatter_tiles, K12 gather_tiles8, K11 build_bank, K5 gather_subset, K1
gather, K9 spgemm_bsr_blocks, K3 fused_class (both modes), K2 (run form,
piece and flat modes), K4 runcopy (fixed mode), K7 spmv_dia, K8 spmv_bsr
and K10 windowed_gather (and its route), without a card and without
building the kernel library.

The library is never built or loaded here: every test that could reach it
stubs ``cuda_lib.KERNELS`` (and clears the resolved-entry cache), so a
check that runs too late fails the test instead of starting ``nvcc``.  K6
is also held against the JAX ``scatter_tiles`` in interpret mode at more
shapes than ``tests/test_torch_gather.py`` covers.
"""

import types

import numpy as np
import scipy.sparse as sp
import pytest

import jax.numpy as jnp
import torch

from nsparse_tpu.ops.kernels.gather_pallas import scatter_tiles as j_scatter

import nsparse_tpu_torch as nt
from nsparse_tpu_torch.ops.kernels import (
    bsr_blocks,
    cuda_lib,
    dia,
    gather_tiles,
    piecewise,
    runcopy,
    shuffle,
    spmv_bsr,
    window_fused,
)


@pytest.fixture(autouse=True)
def _keep_launch_counts():
    """Tests here count launches on stubbed paths: every wrapper's count
    is left as it was, for the tests of other files that share a
    worker."""
    wrappers = (gather_tiles.scatter_tiles, gather_tiles.gather_tiles8,
                gather_tiles.gather_subset, piecewise.build_bank,
                shuffle.gather, bsr_blocks.spgemm_bsr_blocks,
                window_fused.fused_class_apply,
                window_fused.fused_class_expand, piecewise.expand_pieces,
                piecewise.expand_pieces_flat, piecewise.piecewise_expand,
                runcopy.runcopy, dia.spmv_dia, spmv_bsr.spmv_bsr,
                gather_tiles.windowed_gather)
    saved = [w.launches for w in wrappers]
    yield
    for w, n in zip(wrappers, saved):
        w.launches = n


class _Library:
    """Stands in for the built library: counts ``get()`` and records the
    calls of its entry points."""

    def __init__(self, rc=0):
        self.gets, self.calls = 0, []

        def entry(*args):
            self.calls.append(args)
            return rc

        self.ns = types.SimpleNamespace(
            nsp_scatter_tiles_f32=entry, nsp_scatter_tiles_f64=entry,
            nsp_error_string=lambda rc: b"stub error")

    def get(self):
        self.gets += 1
        return self.ns


@pytest.fixture
def library(monkeypatch):
    lib = _Library()
    monkeypatch.setattr(cuda_lib, "KERNELS", lib)
    monkeypatch.setattr(cuda_lib, "_RESOLVED", {})
    return lib


@pytest.fixture
def no_library(monkeypatch):
    def refuse():
        pytest.fail("the kernel library was touched before the checks")

    monkeypatch.setattr(cuda_lib.KERNELS, "get", refuse)
    monkeypatch.setattr(cuda_lib, "_RESOLVED", {})


def _f32(n=1024):
    return torch.zeros(n, dtype=torch.float32)


def _i32(n=1):
    return torch.zeros(n, dtype=torch.int32)


@pytest.mark.parametrize("args, error, match", [
    ((_f32(), _i32(), _f32()), ValueError, "must be on one CUDA device"),
    ((torch.zeros(1024, device="meta"), _i32(), _f32()), ValueError,
     r"must be on one CUDA device, got \['cpu', 'meta'\]"),
    ((_f32(2048).view(2, 1024).t(), _i32(), _f32()), ValueError,
     "contiguous"),
    ((_f32(), torch.zeros(1, dtype=torch.int64), _f32()), ValueError,
     "int32"),
    ((_f32(), _i32(), torch.zeros(1024, dtype=torch.float64)), TypeError,
     "share one dtype"),
    # int16 indices (K3's extraction table) pass the index check
    ((torch.zeros(1024, device="meta"),
      torch.zeros(1, dtype=torch.int16, device="meta"),
      torch.zeros(1024, device="meta")), ValueError,
     r"must be on one CUDA device, got \['meta'\]"),
], ids=["cpu", "mixed-devices", "non-contiguous", "int64-indices",
        "mixed-floats", "int16-indices"])
def test_launch_checks_before_touching_the_library(no_library, args, error,
                                                   match):
    a, i, b = args
    with pytest.raises(error, match=match):
        cuda_lib.launch("scatter_tiles", "nsp_scatter_tiles", a, i, 1, b,
                        1024)


def test_resolve_looks_up_once_per_name_and_dtype(library):
    f32 = cuda_lib.resolve("nsp_scatter_tiles", torch.float32)
    assert cuda_lib.resolve("nsp_scatter_tiles", torch.float32) is f32
    assert library.gets == 1 and f32 is library.ns.nsp_scatter_tiles_f32
    cuda_lib.resolve("nsp_scatter_tiles", torch.float64)
    assert library.gets == 2
    with pytest.raises(TypeError, match="float32 or float64"):
        cuda_lib.resolve("nsp_scatter_tiles", torch.float16)
    assert library.gets == 2


def _stub_device(monkeypatch, current, device):
    """A card-less launch: ``validate`` answers ``device`` (float32), the
    current device is ``current``; returns the device switches made."""
    switches = []
    state = {"current": current}

    def set_device(i):
        switches.append(i)
        state["current"] = i

    monkeypatch.setattr(cuda_lib, "validate", lambda what, *args: (
        device, torch.float32,
        [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]))
    monkeypatch.setattr(cuda_lib, "_current_device", lambda: state["current"])
    monkeypatch.setattr(cuda_lib, "_set_device", set_device)
    monkeypatch.setattr(cuda_lib, "_raw_stream", lambda i: 7000 + i)
    return switches


@pytest.mark.parametrize("current, device, switches", [
    (0, 0, []),
    (0, 1, [1, 0]),
])
def test_launch_passes_ints_on_the_tensors_device(library, monkeypatch,
                                                  current, device, switches):
    """Pointers, sizes and the stream go to the entry point as plain ints;
    the device is switched only when it is not the current one, and
    restored after the call."""
    got = _stub_device(monkeypatch, current, device)
    dst, ids, vals = _f32(), _i32(), _f32()
    cuda_lib.launch("scatter_tiles", "nsp_scatter_tiles", dst, ids, 1, vals,
                    1024)
    assert library.calls == [(dst.data_ptr(), ids.data_ptr(), 1,
                              vals.data_ptr(), 1024, 7000 + device)]
    assert got == switches
    assert cuda_lib._current_device() == current


def test_launch_raises_on_a_cuda_error_and_restores_the_device(monkeypatch):
    lib = _Library(rc=716)
    monkeypatch.setattr(cuda_lib, "KERNELS", lib)
    monkeypatch.setattr(cuda_lib, "_RESOLVED", {})
    got = _stub_device(monkeypatch, 0, 1)
    with pytest.raises(RuntimeError, match="scatter_tiles: CUDA error 716"):
        cuda_lib.launch("scatter_tiles", "nsp_scatter_tiles", _f32(), _i32(),
                        1, _f32(), 1024)
    assert got == [1, 0] and len(lib.calls) == 1


def _k5(d, other=True, n_ids=2):
    """K5 over ``n_ids`` of four 1024-slot units, with or without
    ``other``."""
    i32 = dict(dtype=torch.int32, device=d)
    return gather_tiles.gather_subset(
        torch.zeros(500, device=d), torch.zeros(4096, **i32),
        torch.zeros(n_ids, **i32), 1024, torch.zeros(4096, device=d),
        torch.zeros(3000, device=d) if other else None)


def _k11(d):
    return piecewise.build_bank(torch.zeros(100, dtype=torch.int32, device=d),
                                64, torch.zeros(300, device=d))


def _k1(d, n=1000):
    return shuffle.gather(torch.zeros(500, device=d),
                          torch.zeros(n, dtype=torch.int32, device=d))


def _k9(d, n_pairs=3, bs=64):
    """K9 on two tiles, ``n_pairs`` pairs all into the first of two C
    tiles."""
    i32 = dict(dtype=torch.int32, device=d)
    tiles = torch.zeros(2, bs, bs, device=d)
    p = torch.zeros(n_pairs, **i32)
    return bsr_blocks.spgemm_bsr_blocks(
        tiles, tiles, p, p, p, torch.tensor([0, n_pairs, n_pairs], **i32))


def _k3(d, expand=False):
    """K3 on one class: v1, two 256-slot windows with one tier; v2, one
    2048-slot window of two subtiles and three pieces."""
    if expand:
        w = 2048
        ident = np.arange(w)
        pieces = window_fused.ClassPieces(
            np.array([[0, 2], [2, 3]]), np.array([0, 512, 0, 0]),
            np.array([0, 1, 2, 0]), np.array([512, 1024, 1024, 1024]),
            j2_cap=4, blk=2048, apv_lo=0, apv_hi=4, bank_rows=64)
        plan = window_fused.build_fused_plan(
            w, w, 0, (), ident, [], np.full(w, -1), ident, pieces).to(d)
        return window_fused.fused_class_apply(
            plan, bank=torch.zeros(16 * 64, 128, device=d),
            apv=torch.zeros(4, device=d))
    w, lv = 256, 3
    ident = np.tile(np.arange(w), 2)
    plan = window_fused.build_fused_plan(
        w, 2 * w, lv, (64,), ident, [np.zeros(128)], np.full(2 * w, -1),
        ident).to(d)
    return window_fused.fused_class_apply(plan, torch.zeros(2 * w, device=d))


def _k2_pieces(d, flat=False, n_sub=2):
    """K2's piece mode (or flat mode) over two classes: one subtile of
    budget 2, then ``n_sub - 1`` of budget 4."""
    tables = piecewise.merge_piece_tables(
        [2, 4], [np.zeros(2), np.zeros(4 * (n_sub - 1))],
        [np.zeros(2), np.zeros(4 * (n_sub - 1))]).to(d)
    run = piecewise.expand_pieces_flat if flat else piecewise.expand_pieces
    return run(tables, torch.zeros(tables.cuts.numel(), device=d),
               torch.zeros(16 * 64, 128, device=d),
               torch.zeros(n_sub * 1024, device=d))


def _k2_runs(d):
    plan = piecewise.build_expand_plan([0, 8], [0, 6], [8, 3], [0, 1], 16,
                                       nnz_a=2, nnz_b=9).to(d)
    return piecewise.piecewise_expand(plan, torch.zeros(2, device=d),
                                      torch.zeros(9, device=d))


def _k4(d):
    """K4's fixed mode: two runs of a 2048-value source into 2048 slots."""
    plan = runcopy.build_runcopy_plan([0, 1500], [1024, 300], 2048,
                                      dst=[0, 1024]).to(d)
    return runcopy.runcopy(plan, torch.zeros(2048, device=d))


def _k7(d, dtype=torch.float32, m=100):
    """K7 on three diagonals of a 100 x 100 matrix (``m`` rows)."""
    return dia.spmv_dia(torch.zeros(3, 100, dtype=dtype, device=d),
                        (-1, 0, 1), torch.zeros(100, dtype=dtype, device=d),
                        m)


def _k8(d):
    """K8 on a 300 x 200 BSR of (128, 128) tiles (a tile per block row)."""
    a = nt.BSR.from_csr(nt.CSR.from_scipy(
        sp.random(300, 200, density=0.01, format="csr", dtype=np.float32,
                  random_state=0)), (128, 128))
    return spmv_bsr.spmv_bsr(a.to(d), torch.zeros(200, device=d))


def _k10(d, window=32, dtype=torch.float32, rows=4):
    """K10 on ``rows`` rows of max(window, 128) values."""
    return gather_tiles.windowed_gather(
        torch.zeros(rows, max(window, 128), dtype=dtype, device=d),
        torch.zeros(rows, 128, dtype=torch.int32, device=d), window)


# the argument of the null ``other`` pointer: the int 0, in that slot only
K5_NULL_OTHER = 6


@pytest.mark.parametrize("call, c_name, null_slot", [
    (lambda d: gather_tiles.scatter_tiles(
        torch.zeros(4096, device=d), torch.zeros(2, dtype=torch.int32,
                                                 device=d),
        torch.zeros(2048, device=d), 1024), "nsp_scatter_tiles", None),
    (lambda d: gather_tiles.gather_tiles8(
        torch.zeros(4096, device=d), torch.zeros(3, dtype=torch.int32,
                                                 device=d)),
     "nsp_gather_tiles8", None),
    (_k5, "nsp_gather_subset", None),
    (lambda d: _k5(d, other=False), "nsp_gather_subset", K5_NULL_OTHER),
    (_k11, "nsp_build_bank", None),
    (_k1, "nsp_gather", None),
    (_k9, "nsp_spgemm_bsr", None),
    (_k3, "nsp_fused_class", None),
    (lambda d: _k3(d, expand=True), "nsp_fused_class_v2", None),
    (_k2_pieces, "nsp_expand_pieces", None),
    (lambda d: _k2_pieces(d, flat=True), "nsp_expand_pieces", None),
    (_k2_runs, "nsp_expand", None),
    (_k4, "nsp_runcopy", None),
    (_k7, "nsp_spmv_dia", None),
    (lambda d: _k7(d, torch.float64), "nsp_spmv_dia", None),
    (_k8, "nsp_spmv_bsr", None),
    (_k10, "nsp_windowed_gather", None),
], ids=["K6", "K12", "K5", "K5-null-other", "K11", "K1", "K9", "K3",
        "K3-v2", "K2-pieces", "K2-flat", "K2-runs", "K4", "K7", "K7-f64",
        "K8", "K10"])
def test_wrappers_pass_the_c_signature(monkeypatch, call, c_name, null_slot):
    """The wrappers on the lean path hand ``launch`` one argument per C
    parameter before the stream: a tensor for each pointer, an int for
    each size; K5's absent ``other`` is the int 0 (a null pointer), and
    no other pointer slot takes an int."""
    seen = []
    monkeypatch.setattr(cuda_lib, "launch",
                        lambda what, name, *args: seen.append((name, args)))
    call("meta")
    (name, args), = seen
    assert name == c_name
    sig = cuda_lib._SIGNATURES[name][:-1]
    assert len(args) == len(sig)
    for i, (a, kind) in enumerate(zip(args, sig)):
        if i == null_slot:
            assert kind is cuda_lib._P and type(a) is int and a == 0
            continue
        assert isinstance(a, torch.Tensor) == (kind is cuda_lib._P)
        assert isinstance(a, (torch.Tensor, int))


def test_k3_and_k2_pass_their_sizes(monkeypatch):
    """K3 passes the class's windows, width, fold levels and tier count
    (v2 also the subtiles per step and the region size) and its int16
    extraction table; K2's piece modes pass the class rows, the compact
    subtiles and the row scale (128 bank, 1 flat)."""
    seen = []
    monkeypatch.setattr(cuda_lib, "launch",
                        lambda what, name, *args: seen.append(args))
    _k3("meta")
    _k3("meta", expand=True)
    _k2_pieces("meta", n_sub=3)
    _k2_pieces("meta", flat=True, n_sub=3)
    v1, v2, pieces, flat = seen
    assert v1[2].dtype == torch.int16 and v1[5:] == (2, 256, 3, 1)
    assert v2[8].dtype == torch.int16 and v2[11:] == (1, 2048, 0, 0, 2, 4)
    assert pieces[5:8] == (2, 3, 128) and flat[5:8] == (2, 3, 1)
    assert pieces[4].shape == (2, 3)
    tables = piecewise.merge_piece_tables([2, 8, 4], [np.zeros(2), [],
                                                      np.zeros(8)],
                                          [np.zeros(2), [], np.zeros(8)])
    assert tables.cls.tolist() == [[0, 2, 0], [1, 4, 2]]
    assert tables.rows == ((0, 2, 0), (1, 4, 2)) and tables.n_sub == 3


@pytest.mark.parametrize("flat", [False, True], ids=["aligned", "flat"])
def test_expand_from_bank_launches_k2_once(monkeypatch, flat):
    """A piece plan with subtiles in three budget classes expands in one
    K2 launch (and one K1 for the A values, one K12), in either mode."""
    if flat:
        monkeypatch.setattr(piecewise, "BANK_ROWS_MAX", 1)
    a = nt.rmat_csr(9, edge_factor=6, dtype=np.float32, seed=4)
    pw = nt.spgemm_plan(a, a, shuffle=True, layout="global").glob.pw
    assert pw.aligned == (not flat)
    assert sum(1 for i in pw.ids if i.numel()) >= 3
    seen = []
    monkeypatch.setattr(cuda_lib, "launch",
                        lambda what, name, *args: seen.append(name))
    rows = pw.table_rows * (piecewise.BANK_K if pw.aligned else 1)
    piecewise.expand_from_bank(pw.to("meta"), a.val.to("meta"),
                               torch.zeros(rows, 128, device="meta"))
    assert sorted(seen) == ["nsp_expand_pieces", "nsp_gather",
                            "nsp_gather_tiles8"]
    launches = (piecewise.expand_pieces_flat if flat
                else piecewise.expand_pieces).launches
    assert launches == 1


# K10's route codes, as its C entry reads them (csrc/windowed_gather.cu)
DIRECT, THREAD = 0, 1


@pytest.mark.parametrize("window, dtype, route", [
    (1, torch.float32, DIRECT), (32, torch.float32, DIRECT),
    (100, torch.float32, DIRECT), (512, torch.float32, DIRECT),
    (1023, torch.float32, DIRECT), (1024, torch.float32, THREAD),
    (1, torch.float64, DIRECT), (128, torch.float64, DIRECT),
    (384, torch.float64, DIRECT), (511, torch.float64, DIRECT),
    (512, torch.float64, THREAD), (1024, torch.float64, THREAD)])
def test_k10_route_depends_on_the_window_and_dtype(monkeypatch, window,
                                                   dtype, route):
    """K10 hands ``launch`` its sizes and the route: a warp per row
    reading the window directly below a 4 KB span (f32 windows up to
    1023, f64 up to 511), a thread per output from 4 KB."""
    seen = []
    monkeypatch.setattr(cuda_lib, "launch",
                        lambda what, name, *args: seen.append(args))
    before = gather_tiles.windowed_gather.launches
    out = _k10("meta", window, dtype, rows=3)
    (win, cols, idx, w, rows, got, took), = seen
    assert (cols, w, rows) == (max(window, 128), window, 3)
    assert got is out and out.shape == (3, 128) and out.dtype == dtype
    assert took == route
    assert gather_tiles.windowed_gather.launches == before + 1


def test_k5_passes_its_sizes(monkeypatch):
    """K5's sizes: the source's length, the unit count and size, and
    ``other``'s length (0 without one)."""
    seen = []
    monkeypatch.setattr(cuda_lib, "launch",
                        lambda what, name, *args: seen.append(args))
    _k5("meta", n_ids=3)
    _k5("meta", other=False, n_ids=3)
    for args, n_other in zip(seen, (3000, 0)):
        assert [args[i] for i in (1, 4, 5, 7)] == [500, 3, 1024, n_other]


@pytest.mark.parametrize("call", [
    lambda: gather_tiles.scatter_tiles(
        torch.zeros(2048, device="meta"),
        torch.zeros(1, dtype=torch.int32, device="meta"),
        torch.zeros(1024, device="meta"), 1024),
    lambda: gather_tiles.scatter_tiles(
        torch.zeros(2048, device="meta"),
        torch.zeros(0, dtype=torch.int32, device="meta"),
        torch.zeros(0, device="meta"), 1024),
    lambda: gather_tiles.gather_tiles8(
        torch.zeros(2048, device="meta"),
        torch.zeros(0, dtype=torch.int32, device="meta")),
    lambda: _k5("meta"),
    lambda: _k5("meta", n_ids=0),
    lambda: _k5("meta", other=False),
    lambda: _k11("meta"),
    lambda: _k1("meta"),
    lambda: _k1("meta", n=0),
    lambda: _k9("meta"),
    lambda: _k9("meta", n_pairs=0),
    lambda: _k3("meta"),
    lambda: _k3("meta", expand=True),
    lambda: _k2_pieces("meta"),
    lambda: _k2_pieces("meta", flat=True),
    lambda: _k2_runs("meta"),
    lambda: _k4("meta"),
    lambda: _k7("meta"),
    lambda: _k7("meta", torch.float64),
    lambda: _k7("meta", m=0),
    lambda: _k8("meta"),
    lambda: _k10("meta"),
    lambda: _k10("meta", rows=0),
], ids=["K6", "K6-empty", "K12-empty", "K5", "K5-empty", "K5-null-other",
        "K11", "K1", "K1-empty", "K9", "K9-no-pairs", "K3", "K3-v2",
        "K2-pieces", "K2-flat", "K2-runs", "K4", "K7", "K7-f64", "K7-empty",
        "K8", "K10", "K10-empty"])
def test_wrappers_refuse_a_non_cuda_device(no_library, call):
    """Off the CPU, every wrapper launches on a card or raises, also when
    there is nothing to move; no launch is counted."""
    def counts():
        return (gather_tiles.scatter_tiles.launches,
                gather_tiles.gather_tiles8.launches,
                gather_tiles.gather_subset.launches,
                piecewise.build_bank.launches, shuffle.gather.launches,
                bsr_blocks.spgemm_bsr_blocks.launches,
                window_fused.fused_class_apply.launches,
                window_fused.fused_class_expand.launches,
                piecewise.expand_pieces.launches,
                piecewise.expand_pieces_flat.launches,
                piecewise.piecewise_expand.launches, runcopy.runcopy.launches,
                dia.spmv_dia.launches, spmv_bsr.spmv_bsr.launches,
                gather_tiles.windowed_gather.launches)

    before = counts()
    with pytest.raises(ValueError, match="must be on one CUDA device"):
        call()
    assert counts() == before


@pytest.mark.parametrize("x, idx, match", [
    (torch.zeros(500, device="meta"),
     torch.zeros(8, dtype=torch.int64, device="meta"), "int32"),
    (torch.zeros(2, 250, device="meta").t(),
     torch.zeros(8, dtype=torch.int32, device="meta"), "contiguous"),
    (torch.zeros(500, device="meta"),
     torch.zeros(8, dtype=torch.int32, device="meta"),
     r"must be on one CUDA device, got \['meta'\]"),
    (torch.zeros(500, device="meta"), torch.zeros(8, dtype=torch.int32),
     r"must be on one CUDA device, got \['cpu', 'meta'\]"),
], ids=["int64-indices", "non-contiguous-x", "meta", "mixed-devices"])
def test_k1_refuses_before_touching_the_library(no_library, x, idx, match):
    before = shuffle.gather.launches
    with pytest.raises(ValueError, match=match):
        shuffle.gather(x, idx)
    assert shuffle.gather.launches == before


def test_k1_counts_one_launch_per_call_that_moves_values(monkeypatch):
    """K1 hands ``launch`` x, its length, idx, the output it allocated and
    the output length; a call with no outputs validates and launches
    nothing."""
    seen, checked = [], []
    monkeypatch.setattr(cuda_lib, "launch",
                        lambda what, name, *args: seen.append(args))
    monkeypatch.setattr(cuda_lib, "validate",
                        lambda what, *args: checked.append(args))
    before = shuffle.gather.launches
    out = _k1("meta", n=1001)
    _k1("meta", n=0)
    assert shuffle.gather.launches == before + 1
    (x, n_x, idx, got, n), = seen
    assert got is out and (n_x, n, idx.numel()) == (500, 1001, 1001)
    assert out.shape == (1001,) and len(checked) == 1


@pytest.mark.parametrize("call, error, match", [
    (lambda: bsr_blocks.spgemm_bsr_blocks(
        torch.zeros(2, 64, 64, device="meta"),
        torch.zeros(2, 64, 64, dtype=torch.float64, device="meta"),
        *3 * (torch.zeros(1, dtype=torch.int32, device="meta"),),
        torch.tensor([0, 1], dtype=torch.int32, device="meta")),
     TypeError, "share a dtype"),
    (lambda: bsr_blocks.spgemm_bsr_blocks(
        torch.zeros(2, 64, 64, device="meta"),
        torch.zeros(2, 64, 64, device="meta"),
        torch.zeros(1, dtype=torch.int32, device="meta"),
        torch.zeros(2, dtype=torch.int32, device="meta"),
        torch.zeros(1, dtype=torch.int32, device="meta"),
        torch.tensor([0, 1], dtype=torch.int32, device="meta")),
     ValueError, "differ in length"),
    (lambda: _k9("meta", bs=96), ValueError, "multiple of 64"),
    (lambda: _k9("meta"), ValueError, "must be on one CUDA device"),
    (lambda: bsr_blocks.spgemm_bsr_blocks(
        torch.zeros(2, 64, 64, device="meta"),
        torch.zeros(2, 64, 64, device="meta"),
        *3 * (torch.zeros(1, dtype=torch.int64, device="meta"),),
        torch.tensor([0, 1], dtype=torch.int32, device="meta")),
     ValueError, "int32"),
], ids=["mixed-dtypes", "unequal-pairs", "bs-96", "meta", "int64-pairs"])
def test_k9_refuses_before_touching_the_library(no_library, call, error,
                                                match):
    before = bsr_blocks.spgemm_bsr_blocks.launches
    with pytest.raises(error, match=match):
        call()
    assert bsr_blocks.spgemm_bsr_blocks.launches == before


def test_k9_launches_the_kernel_never_the_plain_version(monkeypatch):
    """Off the CPU K9 goes to ``launch`` with its C tiles, their count and
    bs, and counts the launch; tiles without pairs are zeroed after a
    validation, with no launch.  The plain version is never called."""
    seen, checked = [], []
    monkeypatch.setattr(cuda_lib, "launch",
                        lambda what, name, *args: seen.append(args))
    monkeypatch.setattr(cuda_lib, "validate",
                        lambda what, *args: checked.append(args))
    monkeypatch.setattr(bsr_blocks, "spgemm_bsr_blocks_plain",
                        lambda *args: pytest.fail("plain version called"))
    before = bsr_blocks.spgemm_bsr_blocks.launches
    c = _k9("meta", bs=128)
    _k9("meta", n_pairs=0)
    assert bsr_blocks.spgemm_bsr_blocks.launches == before + 1
    (*_, n_c, bs, out), = seen
    assert out is c and c.shape == (2, 128, 128) and (n_c, bs) == (2, 128)
    assert len(checked) == 1


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("n_dst, ids, tile_rows", [
    (16, [15, 0, 9, 3, 12, 1, 6], 8),
    (6, [5, 2], 16),
], ids=["7-tiles", "2048-value-tiles"])
def test_scatter_tiles_more_shapes_match_jax(dtype, n_dst, ids, tile_rows):
    """K6's plain version against the JAX scatter_tiles in interpret mode
    (f64 through its two uint32 planes) at a second tile count and a
    second tile size, bit for bit; tiles not listed keep their values."""
    rng = np.random.default_rng(len(ids))
    dst = rng.standard_normal((n_dst * tile_rows, 128)).astype(dtype)
    vals = rng.standard_normal((len(ids), tile_rows, 128)).astype(dtype)
    ids = np.array(ids, np.int32)
    want = np.asarray(j_scatter(jnp.asarray(dst.copy()), jnp.asarray(ids),
                                jnp.asarray(vals), tile_rows=tile_rows))
    got = torch.from_numpy(dst.copy()).reshape(-1)
    out = gather_tiles.scatter_tiles(got, torch.from_numpy(ids),
                                     torch.from_numpy(vals),
                                     tile_rows * 128)
    assert out is got
    np.testing.assert_array_equal(got.reshape(dst.shape).numpy(), want)
    kept = np.setdiff1d(np.arange(n_dst), ids)
    np.testing.assert_array_equal(
        want.reshape(n_dst, -1)[kept], dst.reshape(n_dst, -1)[kept])

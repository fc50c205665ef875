"""The hash SpGEMM (``ops/kernels/spgemm_hash.py``, ``csrc/spgemm_hash.cu``)
on the CPU: its routes and their tables, the wrapper's checks, its
pipeline and recorder against a stand-in for the card, and ``spgemm``'s
routing.

The kernels run only on a card (``chip_smoke.py``'s ``hash_phase`` holds
them against the ESC path there).  Here ``_Card`` stands in for them: it
runs each entry point's contract (binning, scatter, symbolic counts,
numeric rows) on CPU tensors, so the host side (the two reads, the
slices of ``perm``, the device-table sizes, C's row pointers and padded
tail) is checked end to end against the ESC path.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from nsparse_tpu.formats.csr import CSR as JCSR
from nsparse_tpu.ops.spgemm import spgemm_numeric as j_numeric
from nsparse_tpu.ops.spgemm import spgemm_plan_device as j_plan_device

import chip_smoke
import nsparse_tpu_torch as nt
from nsparse_tpu_torch.ops.binning import flops_per_row
from nsparse_tpu_torch.ops.kernels import cuda_lib
from nsparse_tpu_torch.ops.kernels import spgemm_hash as sh
from nsparse_tpu_torch.ops.spgemm import spgemm_numeric_sort
from nsparse_tpu_torch.utils import profiling

RTOL = {torch.float32: 2e-5, torch.float64: 1e-10}


@pytest.fixture(autouse=True)
def _fresh_recorder():
    profiling.reset()
    yield
    profiling.reset()


# -- routes and tables ------------------------------------------------------


BLOCKS = ["block2048", "block4096", "block8192", "block16384"]


@pytest.mark.parametrize("phase, n_cols, dtype, names, passes", [
    ("symbolic", 32768, torch.float32, ["pwarp", "warp", "dense"], 1),
    ("symbolic", 1 << 20, torch.float64, ["pwarp", "warp", "dense"], 2),
    ("symbolic", 1 << 22, torch.float32, ["pwarp", "warp", "dense"], 5),
    ("symbolic", 1 << 23, torch.float32, ["pwarp", "warp", "dense"], 10),
    ("symbolic", 1 << 24, torch.float32,
     ["pwarp", "warp", *BLOCKS, "block32768", "global"], None),
    ("symbolic", 1 << 28, torch.float32,
     ["pwarp", "warp", *BLOCKS, "block32768", "global"], None),
    ("numeric", 16384, torch.float32, ["pwarp", "warp", "dense"], 1),
    ("numeric", 32768, torch.float32, ["pwarp", "warp", "dense"], 2),
    ("numeric", 32768, torch.float64, ["pwarp", "warp", "dense"], 3),
    ("numeric", 65536, torch.float32, ["pwarp", "warp", "dense"], 3),
    ("numeric", 65536, torch.float64, ["pwarp", "warp", "dense"], 5),
    ("numeric", 1 << 20, torch.float32, ["pwarp", "warp", *BLOCKS, "dense"],
     38),
    ("numeric", 1 << 22, torch.float64, ["pwarp", "warp", *BLOCKS,
                                         "dense"], 296),
    ("numeric", 1 << 23, torch.float64, ["pwarp", "warp", *BLOCKS,
                                         "global"], None),
    ("numeric", 100, torch.float64, ["pwarp", "warp", "dense"], 1),
], ids=["sym-32k", "sym-1m-f64", "sym-4m", "sym-8m", "sym-16m",
        "sym-256m", "num-16k-f32", "num-32k-f32", "num-32k-f64",
        "num-64k-f32", "num-64k-f64", "num-1m", "num-4m-f64", "num-8m-f64",
        "num-100-f64"])
def test_routes_follow_the_shapes(phase, n_cols, dtype, names, passes):
    """The routes by phase, width and dtype: past the warp route, the
    dense accumulator alone while it takes at most DENSE_PASSES slices of
    N (each sized so two blocks share an SM: numeric 32, symbolic 12);
    past that hash tables in shared memory while they fit, then the dense
    route to TABLE_PASSES (numeric 320, symbolic 12), then tables in
    device memory."""
    routes = sh.hash_routes(phase, n_cols, torch.empty(0, dtype=dtype)
                            .element_size())
    assert [r.name for r in routes] == names
    limits = [r.limit for r in routes]
    assert limits[-1] is None
    assert limits[:-1] == [32, 512] + [1024 << i
                                       for i in range(len(routes) - 3)]
    if passes is not None:
        assert -(-n_cols // routes[-1].slots) == passes
        assert routes[-1].slots % 32 == 0


@pytest.mark.parametrize("phase", sh.PHASES)
@pytest.mark.parametrize("n_cols", [1, 100, 4096, 32768, 40_000, 1 << 20,
                                    (1 << 31) - 1])
@pytest.mark.parametrize("val_bytes", [4, 8])
def test_every_table_fits_the_opt_in(phase, n_cols, val_bytes):
    """Every route's shared memory fits the 227 KB a block may opt in to,
    every table is at most half full, the dense route takes N values
    (numeric) and N bits in its passes, alone to DENSE_PASSES and behind
    the hash blocks to TABLE_PASSES, and past that tables lie in device
    memory."""
    routes = sh.hash_routes(phase, n_cols, val_bytes)
    slot = 4 + (val_bytes if phase == "numeric" else 0)
    for r in routes:
        assert r.smem <= sh.SMEM_MAX, r
        assert r.threads % 32 == 0 and r.threads <= 1024
        if r.limit is not None:
            assert r.slots >= 2 * r.limit
            groups = {sh.PWARP: r.threads // sh.PWARP_LANES,
                      sh.WARP: r.threads // 32}.get(r.kind, 1)
            extra = sh.SCRATCH_BYTES if r.kind == sh.BLOCK else 0
            assert r.smem == groups * r.slots * slot + extra
    tail, vb = routes[-1], slot - 4
    passes = -(-n_cols // sh.dense_route(n_cols, vb).slots)
    assert 2 * (sh.dense_route(n_cols, vb).smem + 1024) <= sh.SMEM_SM
    assert (len(routes) == 3) == (passes <= sh.DENSE_PASSES[phase])
    if tail.kind == sh.DENSE:
        assert tail.slots % 32 == 0
        assert -(-n_cols // tail.slots) == passes <= sh.TABLE_PASSES[phase]
        assert tail.smem == tail.slots * vb + tail.slots // 8 + \
            sh.SCRATCH_BYTES
        assert tail == sh.dense_route(n_cols, vb)
    else:
        assert tail.kind == sh.GLOBAL and tail.smem == sh.SCRATCH_BYTES
        assert passes > sh.TABLE_PASSES[phase]


@pytest.mark.parametrize("n_cols", [1 << 20, 1 << 22])
def test_f64_tables_hold_fewer_slots(n_cols):
    """A numeric slot holds a key and a value, a symbolic one a key: per
    byte an f64 table holds fewer slots, its largest shared table is no
    larger than f32's, and the symbolic phase's is at least as large."""
    def blocks(phase, vb):
        return {r.slots: r.smem for r in sh.hash_routes(phase, n_cols, vb)
                if r.kind == sh.BLOCK}

    f32, f64 = blocks("numeric", 4), blocks("numeric", 8)
    assert max(f64) <= max(f32)
    assert all(f64[t] > f32[t] for t in f64)
    sym = blocks("symbolic", 4)
    assert not sym or max(sym) >= max(f32)


@pytest.mark.parametrize("n_cols, size, f32, f64", [
    (1 << 24, 0, None, None), (1 << 24, 1, "pwarp", "pwarp"),
    (1 << 24, 32, "pwarp", "pwarp"), (1 << 24, 33, "warp", "warp"),
    (1 << 24, 512, "warp", "warp"), (1 << 24, 513, "block2048", "block2048"),
    (1 << 24, 1024, "block2048", "block2048"),
    (1 << 24, 1025, "block4096", "block4096"),
    (1 << 24, 4096, "block8192", "block8192"),
    (1 << 24, 8192, "block16384", "block16384"),
    (1 << 24, 8193, "global", "global"),
    (1 << 24, 1 << 20, "global", "global"),
    (1 << 21, 513, "block2048", "block2048"),
    (1 << 21, 8193, "dense", "dense"), (1 << 22, 8193, "dense", "dense"),
    (1 << 23, 8193, "dense", "global"),
    (65536, 513, "dense", "dense"), (65536, 8193, "dense", "dense"),
    (32768, 513, "dense", "dense"), (32768, 32768, "dense", "dense"),
], ids=lambda v: str(v))
def test_route_of_each_bin_edge(n_cols, size, f32, f64):
    """Rows at each bin edge in the numeric phase: a row of size s takes
    the first route whose limit is at least s, else the tail; past the
    warp route the dense accumulator takes every row while N fits in 32
    slices of two blocks an SM (f32 to about 895,000 columns, f64 to about
    455,000); past that a row too large for the largest shared table takes
    the dense route to 320 slices (f32 to about 8.9 M columns, f64 to
    about 4.5 M), else a table in device memory; an empty row takes
    none."""
    for vb, want in ((4, f32), (8, f64)):
        routes = sh.hash_routes("numeric", n_cols, vb)
        (b,) = sh.route_of([size], routes)
        assert (routes[b].name if b >= 0 else None) == want


# -- the wrapper's checks ----------------------------------------------------


def _csr(device="meta", idx=torch.int32, dtype=torch.float32, b_dtype=None):
    a = nt.CSR(rpt=torch.zeros(5, dtype=idx, device=device),
               col=torch.zeros(8, dtype=idx, device=device),
               val=torch.zeros(8, dtype=dtype, device=device),
               shape=(4, 4), nnz=8)
    b = nt.CSR(rpt=a.rpt, col=a.col,
               val=torch.zeros(8, dtype=b_dtype or dtype, device=device),
               shape=(4, 4), nnz=8)
    return a, b


@pytest.fixture
def no_library(monkeypatch):
    def refuse():
        pytest.fail("the kernel library was touched before the checks")

    monkeypatch.setattr(cuda_lib.KERNELS, "get", refuse)
    monkeypatch.setattr(cuda_lib, "_RESOLVED", {})


@pytest.mark.parametrize("args, error, match", [
    (_csr("cpu"), ValueError, r"must be on one CUDA device, got \['cpu'\]"),
    (_csr("meta"), ValueError, r"must be on one CUDA device, got \['meta'\]"),
    (_csr(idx=torch.int64), ValueError, "int32"),
    (_csr(b_dtype=torch.float64), TypeError, "share one dtype"),
], ids=["cpu", "meta", "int64-indices", "mixed-dtypes"])
def test_wrapper_refuses_before_any_launch(no_library, args, error, match):
    with profiling.recording(), pytest.raises(error, match=match):
        sh.spgemm_hash(*args)
    assert not [k for k in profiling.snapshot()["counters"]
                if k.startswith("launch.")]


@pytest.mark.parametrize("dtype", [torch.int64, torch.float64, torch.int32])
def test_scratch_buffers_skip_the_dtype_check(dtype):
    """A ``Scratch`` buffer (the hash path's int64 histogram and table
    offsets) passes as its pointer whatever its dtype, and still must lie
    on the launch's device and be contiguous; a bare int64 tensor is still
    refused as an index array."""
    vals = torch.zeros(4, dtype=torch.float32, device="meta")
    buf = torch.zeros(6, dtype=dtype, device="meta")
    with pytest.raises(ValueError, match=r"one CUDA device, got \['meta'\]"):
        cuda_lib.validate("t", vals, cuda_lib.Scratch(buf), 3)
    with pytest.raises(ValueError, match="contiguous"):
        cuda_lib.validate("t", vals, cuda_lib.Scratch(buf[::2]))
    with pytest.raises(ValueError, match=r"one CUDA device, got \['cpu', "):
        cuda_lib.validate("t", vals, cuda_lib.Scratch(
            torch.zeros(6, dtype=dtype)))
    if dtype is torch.int64:
        with pytest.raises(ValueError, match="int32 or int16"):
            cuda_lib.validate("t", vals, buf)


# -- the pipeline against a stand-in for the card ----------------------------


def _global_slots(size):
    """A ``global`` row's device-memory table, as csrc/spgemm_hash.cu
    sizes it: the power of two at least twice its size."""
    t = 2
    while t < 2 * size:
        t *= 2
    return t


class _Card:
    """Runs each hash entry point's contract on CPU tensors, as
    ``csrc/spgemm_hash.cu`` runs it on the card, and checks the wrapper's
    arguments against the C signatures."""

    def __init__(self):
        self.calls = []

    def launch(self, what, name, *args):
        sig = cuda_lib._SIGNATURES[name][:-1]
        assert len(args) == len(sig), name
        scratch = [isinstance(a, cuda_lib.Scratch) for a in args]
        args = [a.t if s else a for a, s in zip(args, scratch)]
        for a, s in zip(args, scratch):
            assert not s or a.dtype == torch.int64, name
        for a, kind in zip(args, sig):
            assert isinstance(a, torch.Tensor) == (kind is cuda_lib._P), name
            if isinstance(a, torch.Tensor):
                assert a.is_contiguous() and a.dtype in (
                    torch.int32, torch.int64, torch.float32,
                    torch.float64), name
        self.calls.append(name)
        profiling.count("launch." + name)
        getattr(self, name[len("nsp_"):])(*args)

    @staticmethod
    def products(ar, ac, av, br, bc, bv, row):
        ks = ac[ar[row]: ar[row + 1]].long()
        cols = [bc[br[k]: br[k + 1]] for k in ks]
        if not cols:
            return torch.zeros(0, dtype=torch.int32), None
        prods = None
        if av is not None:
            prods = torch.cat([av[j] * bv[br[k]: br[k + 1]] for j, k in
                               zip(range(int(ar[row]), int(ar[row + 1])),
                                   ks)])
        return torch.cat(cols), prods

    def hash_bin(self, a_rpt, a_col, b_rpt, row_nnz, mode, m, n, limits,
                 n_limits, tail_global, size, bins, goff, info):
        limits = torch.tensor(limits[:n_limits])
        assert n_limits < sh.MAX_BINS and (limits.diff() > 0).all()
        if mode == 0:
            deg = b_rpt.long().diff()
            p = torch.zeros(m, dtype=torch.int64)
            rows = torch.repeat_interleave(torch.arange(m),
                                           a_rpt.long().diff())
            p.index_add_(0, rows, deg[a_col[: int(a_rpt[-1])].long()])
            s = p.clamp(max=n)
        else:
            s = row_nnz.long()
        b = torch.searchsorted(limits, s)
        b[s == 0] = -1
        bins.copy_(b)
        for k in range(n_limits + 1):
            info[k] += int((b == k).sum())
        tail = torch.nonzero(b == n_limits).squeeze(1)
        if tail_global and tail.numel():
            slots = torch.tensor([_global_slots(int(v)) for v in s[tail]])
            goff[tail] = info[sh.INFO_GLOBAL] + slots.cumsum(0) - slots
            info[sh.INFO_GLOBAL] += int(slots.sum())
        if mode == 0:
            size.copy_(s)
            row_nnz[b < 0] = 0
        else:
            info[sh.INFO_NNZ] += int(s.sum())

    def hash_scatter(self, bins, m, info, n_bins, perm):
        for b in range(n_bins):
            rows = torch.nonzero(bins == b).squeeze(1)
            start = int(info[:b].sum())
            perm[start: start + rows.numel()] = rows.int()
            info[sh.INFO_NNZ + 1 + b] += rows.numel()

    def hash_symbolic(self, kind, slots, threads, a_rpt, a_col, b_rpt,
                      b_col, perm, n_rows, size, goff, gkeys, n, row_nnz):
        assert perm.numel() == n_rows
        for row in perm.tolist():
            cols, _ = self.products(a_rpt, a_col, None, b_rpt, b_col, None,
                                    row)
            distinct = int(torch.unique(cols).numel())
            if kind == sh.GLOBAL:
                end = int(goff[row]) + _global_slots(int(size[row]))
                assert end <= gkeys.numel()
            elif kind != sh.DENSE:
                assert 2 * distinct <= slots
            row_nnz[row] = distinct

    def hash_numeric(self, kind, slots, threads, a_rpt, a_col, a_val, b_rpt,
                     b_col, b_val, perm, n_rows, goff, gkeys, gvals, n,
                     c_rpt, c_col, c_val):
        assert perm.numel() == n_rows
        for row in perm.tolist():
            cols, prods = self.products(a_rpt, a_col, a_val, b_rpt, b_col,
                                        b_val, row)
            uniq, inv = torch.unique(cols, sorted=True, return_inverse=True)
            base, end = int(c_rpt[row]), int(c_rpt[row + 1])
            assert end - base == uniq.numel()
            if kind == sh.GLOBAL:
                end_slot = int(goff[row]) + _global_slots(end - base)
                assert end_slot <= gkeys.numel() == gvals.numel()
            elif kind != sh.DENSE:
                assert 2 * uniq.numel() <= slots
            c_col[base:end] = uniq
            c_val[base:end] = torch.zeros(uniq.numel(), dtype=c_val.dtype
                                          ).index_add_(0, inv, prods)


@pytest.fixture
def card(monkeypatch):
    c = _Card()
    monkeypatch.setattr(cuda_lib, "validate",
                        lambda what, *args: (0, None, list(args)))
    monkeypatch.setattr(cuda_lib, "launch", c.launch)
    return c


def _scipy(m, dtype):
    return nt.CSR.from_scipy(sp.csr_matrix(m), dtype=dtype)


def _rand(seed, m, n, per_row, vals=None):
    rng = np.random.default_rng(seed)
    return sp.random(m, n, density=per_row / n, random_state=rng,
                     data_rvs=vals and (lambda k: vals(rng, k)),
                     format="csr")


def _rmat_rows_emptied():
    m = (sp.diags((np.arange(512) % 3 > 0).astype(float))
         @ nt.rmat_csr(9, edge_factor=6, seed=4).to_scipy()).tocsr()
    m.eliminate_zeros()
    return nt.CSR.from_scipy(m)


def _full_row():
    full = _rand(1, 300, 300, 3).tolil()
    full[0, :] = 1.0
    return (_scipy(full, np.float64),
            _scipy(sp.identity(300) + _rand(2, 300, 300, 2), np.float64))


def _cancel():
    x = _rand(3, 64, 32, 2, lambda rng, k: rng.integers(1, 5, k))
    y = _rand(4, 32, 64, 3,
              lambda rng, k: rng.choice([-4, -3, -2, -1, 1, 2, 3, 4], k))
    return (_scipy(sp.hstack([x, x]), np.float64),
            _scipy(sp.vstack([y, -y]), np.float64))


# (a, b) pairs: R-MAT, empty rows and products, a row that covers every
# column, rows in the tail routes, exact cancellation, M * N past the ESC
# path's packed key
CASES = {
    "rmat": lambda: 2 * (nt.rmat_csr(9, edge_factor=6, seed=4),),
    "empty-rows": lambda: 2 * (_rmat_rows_emptied(),),
    "empty": lambda: (_scipy(sp.csr_matrix((5, 7)), np.float64),
                      _scipy(sp.csr_matrix((7, 5)), np.float64)),
    "full-row": _full_row,
    "tail": lambda: (_scipy(_rand(5, 3, 65536, 300), np.float64),
                     _scipy(_rand(6, 65536, 65536, 40), np.float64)),
    "cancel": _cancel,
    "wide-key": lambda: (_scipy(_rand(7, 2048, 64, 2), np.float64),
                         _scipy(_rand(8, 64, 1 << 20, 4), np.float64)),
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("case", list(CASES))
def test_pipeline_matches_the_esc_path(card, case, dtype):
    """C through the hash pipeline: row pointers and columns equal to the
    ESC path's, values within RTOL of |A||B|, the tail past nnz zero; one
    binning and one scatter a phase and one launch per route that took
    rows."""
    a, b = CASES[case]()
    a = a.with_values(a.val.to(dtype))
    b = b.with_values(b.val.to(dtype))
    with profiling.recording():
        c = sh.spgemm_hash(a, b)
        counters = profiling.snapshot()["counters"]
    c_rpt, c_col, c_val, nnz = c.rpt, c.col, c.val, c.nnz
    assert c.shape == (a.shape[0], b.shape[1])
    used = {p: sum(1 for k, v in counters.items()
                   if k.startswith(f"spgemm_hash.rows.{p}.") and v)
            for p in sh.PHASES}
    assert card.calls.count("nsp_hash_bin") == 2
    assert card.calls.count("nsp_hash_scatter") == 2
    assert card.calls.count("nsp_hash_symbolic") == used["symbolic"]
    assert card.calls.count("nsp_hash_numeric") == used["numeric"]
    if case == "wide-key":
        assert a.shape[0] * b.shape[1] >= 2**31
        with pytest.raises(ValueError, match="M \\* N < 2\\^31"):
            nt.spgemm_plan_device(a, b)
        ref = nt.CSR.from_scipy((a.to_scipy() @ b.to_scipy()).tocsr())
    else:
        ref = spgemm_numeric_sort(nt.spgemm_plan_device(a, b), a, b)
    assert nnz == ref.nnz and c_col.numel() == c_val.numel() == \
        sh._round_up(nnz, sh.LANES)
    assert torch.equal(c_rpt, ref.rpt)
    assert torch.equal(c_col[:nnz], ref.col[:nnz])
    assert not c_col[nnz:].any() and not c_val[nnz:].any()
    scale = nt.spgemm_abs_oracle(a, b).data if nnz else 0.0
    err = np.abs(c_val[:nnz].double().numpy()
                 - ref.val[:nnz].double().numpy())
    assert (err <= RTOL[dtype] * scale + 1e-30).all()
    if case == "cancel":
        assert nnz and not c_val.any()
    if case == "full-row":
        assert int(c_rpt[1]) == b.shape[1]
    if case == "tail":
        tail = sh.hash_routes("numeric", b.shape[1], c_val.element_size())
        assert counters[f"spgemm_hash.rows.numeric.{tail[-1].name}"] == 3
        assert counters.get("spgemm_hash.global_rows", 0) == \
            (3 if tail[-1].kind == sh.GLOBAL else 0)


@pytest.mark.parametrize("n_cols, dtype", chip_smoke.LADDER_CASES,
                         ids=lambda v: str(v))
def test_route_ladder_takes_every_route(card, n_cols, dtype):
    """``chip_smoke.route_ladder``, whose products the card's hash phase
    runs to check every route: each route of both phases takes rows (the
    counters equal the host's binning of the sizes), and where the ESC
    path takes the shape (M * N < 2^31), C equals its C."""
    a, b = chip_smoke.route_ladder(nt, n_cols, dtype,
                                   np.random.default_rng(n_cols))
    with profiling.recording():
        c = sh.spgemm_hash(a, b)
        counters = profiling.snapshot()["counters"]
    sizes = {"symbolic": flops_per_row(a, b).clamp(max=n_cols).numpy(),
             "numeric": np.diff(c.rpt.numpy())}
    for phase in sh.PHASES:
        routes = sh.hash_routes(phase, n_cols, a.val.element_size())
        bins = sh.route_of(sizes[phase], routes)
        got = [counters.get(f"spgemm_hash.rows.{phase}.{r.name}", 0)
               for r in routes]
        assert got == [int((bins == k).sum()) for k in range(len(routes))]
        assert all(got), (phase, [r.name for r in routes], got)
    if a.shape[0] * n_cols < 2**31:
        ref = spgemm_numeric_sort(nt.spgemm_plan_device(a, b), a, b)
        assert torch.equal(c.rpt, ref.rpt)
        assert torch.equal(c.col[: c.nnz], ref.col[: c.nnz])


def test_recorder_names(card):
    """The hash path's spans (``spgemm.hash.bin``, ``.symbolic``,
    ``.numeric``), its two reads (``sync.hash_bins``, ``sync.c_nnz``),
    the launch path's counters and the route counters, read from the
    histograms; with the recorder off, nothing is counted."""
    a = nt.rmat_csr(8, 4, dtype=np.float32)
    sh.spgemm_hash(a, a)
    assert profiling.snapshot() == {"spans": {}, "counters": {}}
    with profiling.recording():
        sh.spgemm_hash(a, a)
    snap = profiling.snapshot()
    assert set(snap["spans"]) == {
        "spgemm.hash.bin", "spgemm.hash.symbolic", "spgemm.hash.numeric",
        "sync.hash_bins", "sync.c_nnz"}
    assert snap["counters"]["sync"] == 2
    rows = {k: v for k, v in snap["counters"].items()
            if k.startswith("spgemm_hash.rows.")}
    routes = {p: [r.name for r in sh.hash_routes(p, a.shape[1], 4)]
              for p in sh.PHASES}
    assert all(k.split(".")[3] in routes[k.split(".")[2]] for k in rows)
    for phase in sh.PHASES:
        assert sum(v for k, v in rows.items()
                   if k.startswith(f"spgemm_hash.rows.{phase}.")) == \
            int((flops_per_row(a, a) > 0).sum())
    assert snap["counters"]["spgemm_hash.global_rows"] == 0
    assert {k for k in snap["counters"] if k.startswith("launch.")} == {
        "launch.nsp_hash_bin", "launch.nsp_hash_scatter",
        "launch.nsp_hash_symbolic", "launch.nsp_hash_numeric"}


# -- spgemm's routing -----------------------------------------------------------


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("case", ["rmat", "empty-rows"])
def test_auto_on_the_cpu_keeps_the_device_planner(case, dtype):
    """On the CPU ``spgemm(a, b)`` (planner "auto") is the device
    planner's path: C equals the JAX package's (``rpt`` and ``col``
    exactly, values within the checks' tolerance) and, bit for bit,
    ``planner="device"``'s."""
    a, b = CASES[case]()
    s = a.to_scipy().astype(dtype)
    ta = nt.CSR.from_scipy(s)
    ja = JCSR.from_scipy(s)
    jc = j_numeric(j_plan_device(ja, ja), ja, ja)
    c = nt.spgemm(ta, ta)
    nnz = c.nnz
    np.testing.assert_array_equal(np.asarray(jc.rpt), c.rpt.numpy())
    np.testing.assert_array_equal(np.asarray(jc.col)[:nnz],
                                  c.col.numpy()[:nnz])
    assert nt.check_spgemm_answer(c, nt.spgemm_oracle(ta, ta),
                                  abs_ref=nt.spgemm_abs_oracle(ta, ta))
    d = nt.spgemm(ta, ta, planner="device")
    assert torch.equal(c.rpt, d.rpt) and torch.equal(c.col, d.col)
    assert torch.equal(c.val, d.val)

"""The HPCG configuration on the CPU at small grids: the generator against
scipy, the set-up's product counts against their closed forms (and the
closed forms against the 256³ hierarchy's counts), whole runs of both
cells (the program passes, the control fails, a broken timed path
fails), and the readers of the program's recorder."""

import dataclasses
import types

import numpy as np
import pytest
import scipy.sparse as sp

import harness
import readings
import reference_hpcg

import nsparse_tpu_torch as nt

CELLS = (("hpcg-256", "rap-oneshot"), ("hpcg-256", "spmv-dia"))
GRID, SECONDS = 8, 0.2


def gen():
    return harness.load("generators", "hpcg")


def scipy_csr(m):
    return sp.csr_matrix((m.val.numpy(), m.col.numpy(), m.rpt.numpy()),
                         shape=m.shape)


def interp_1d(nf):
    """1-D linear interpolation as scipy builds it, for comparison."""
    nc = (nf + 1) // 2
    p = sp.lil_matrix((nf, nc))
    for i in range(nf):
        p[i, i // 2] = 1.0 if i % 2 == 0 else 0.5
        if i % 2 and i // 2 + 1 < nc:
            p[i, i // 2 + 1] = 0.5
    return p.tocsr()


def kron3(fz, fy, fx):
    m = sp.kron(sp.kron(fz, fy), fx).tocsr()
    m.eliminate_zeros()  # kron may store whole blocks, zeros too
    return m


@pytest.mark.parametrize("d", [(4, 4, 4), (8, 6, 4), (6, 10, 8)])
def test_generator_against_scipy(d):
    """A's pattern is the 27-point stencil (x fastest), its values HPCG's
    or symmetric factors in [0.5, 1.5) with the diagonal 26; P is the
    Kronecker product of 1-D interpolations, R its transpose; every CSR
    canonical."""
    g = gen()
    nx, ny, nz = d
    h = g.hierarchy({"nx": nx, "ny": ny, "nz": nz, "levels": 2}, "cpu")
    tri = [sp.diags([1.0, 1.0, 1.0], [-1, 0, 1], shape=(k, k))
           for k in (nz, ny, nx)]
    pattern = kron3(*tri)
    hpcg = (27 * sp.identity(nx * ny * nz) - pattern).tocsr()
    a = g.operator(d, "cpu")
    assert (scipy_csr(a) != hpcg).nnz == 0
    assert np.array_equal(h.a.rpt.numpy(), pattern.indptr)
    assert np.array_equal(h.a.col.numpy(), pattern.indices)
    val = g.coefficients(h, g.device_generator(5, "cpu"))
    m = scipy_csr(dataclasses.replace(h.a, val=val))
    assert (m != m.T).nnz == 0
    assert np.all(m.diagonal() == 26)
    off = (m - sp.diags(m.diagonal())).tocsr()
    assert off.nnz == pattern.nnz - nx * ny * nz
    assert -off.data.max() >= 0.5 and -off.data.min() < 1.5
    r, p = h.transfers[0]
    want = kron3(*(interp_1d(k) for k in (nz, ny, nx)))
    for got, ref in ((p, want), (r, want.T.tocsr())):
        got = scipy_csr(got)
        assert got.shape == ref.shape and got.has_sorted_indices
        assert np.array_equal(got.indptr, ref.indptr)
        assert np.array_equal(got.indices, ref.indices)
        assert np.array_equal(got.data, ref.data)
    assert h.grids == [d, tuple((k + 1) // 2 for k in d)]
    offsets, vals = g.diagonals(d, "cpu")
    dense = hpcg.toarray()
    rows = np.arange(nx * ny * nz)
    for off, v in zip(offsets, vals.numpy()):
        inside = (rows + off >= 0) & (rows + off < rows.size)
        got = v[: rows.size]
        want_d = np.zeros(rows.size)
        want_d[inside] = dense[rows[inside], rows[inside] + off]
        assert np.array_equal(got, want_d)
    assert not vals[:, rows.size:].any()


def closed_1d(c: int) -> tuple:
    """1-D counts of one level, c coarse points (nf = 2c): products of
    A·P, nnz(A·P), products of R·(A·P), nnz(A_{l+1})."""
    return 9 * c - 5, 5 * c - 3, 7 * c - 5, 3 * c - 2


# the 256³ hierarchy's counts by level (checked with scipy on the 1-D factors)
TABLE_256 = [
    (1_509_003_523, 258_474_853, 707_347_971, 55_742_968),
    (186_169_411, 31_855_013, 86_938_307, 6_859_000),
    (22_665_187, 3_869_893, 10_503_459, 830_584)]


def test_closed_forms_give_the_256_hierarchy():
    """The counts are products of 1-D counts (every operator is a
    Kronecker product); at 256³ they give TABLE_256, 2 x 2,522,627,858
    operations a set-up; the 1-D forms match scipy's 1-D products."""
    rows = [tuple(v ** 3 for v in closed_1d(c)) for c in (128, 64, 32)]
    assert rows == TABLE_256
    assert sum(r[0] + r[2] for r in rows) == 2_522_627_858
    for c in (1, 2, 5, 128):
        nf = 2 * c
        a = sp.diags([1.0, 1.0, 1.0], [-1, 0, 1], shape=(nf, nf)).tocsr()
        p = interp_1d(nf)
        ap = a @ p
        products = lambda x, y: int((np.diff(y.indptr)[x.indices]).sum())
        assert closed_1d(c) == (products(a, p), ap.nnz,
                                products(p.T.tocsr(), ap), (p.T @ ap).nnz)


@pytest.mark.parametrize("n", [8, 16])
def test_set_up_counts_match_the_closed_forms(n):
    """The entry's work, from the reference's symbolic pass on the
    generator's hierarchy: each level's counts are the closed forms', and
    the operations 2 x the products of every level."""
    g = gen()
    rap = harness.load("entries", "rap")
    h = g.hierarchy({"nx": n, "ny": n, "nz": n, "levels": 4}, "cpu")
    got = [(p_ap, nnz_ap, p_rap, coarse.nnz) for p_ap, nnz_ap, p_rap, coarse
           in reference_hpcg.galerkin_symbolic(h.a, h.transfers)]
    cs = [n // 2, n // 4, n // 8]
    assert got == [tuple(v ** 3 for v in closed_1d(c)) for c in cs]
    ops, nbytes = rap.galerkin_work(h.a, h.transfers)
    assert ops == 2 * sum(r[0] + r[2] for r in got)
    assert nbytes > 12 * h.a.nnz


def runs(cell, seeds=(), control_seeds=()):
    cfg, traffic = readings.read_files(*cell)
    small = dict(cfg, nx=GRID, ny=GRID, nz=GRID)
    return list(readings.readings(small, traffic, list(seeds),
                                  list(control_seeds), SECONDS, "cpu"))


@pytest.mark.parametrize("cell", CELLS, ids=[t for _, t in CELLS])
def test_program_passes_and_control_fails(cell):
    lines = runs(cell, seeds=(3_000_000_011,),
                 control_seeds=(3_000_000_021,))
    assert [ln["correct"] for ln in lines] == [True, False]


def altered(fn):
    """One value of the answer moved by a millionth of its size."""
    def f(*a, **k):
        out = fn(*a, **k)
        csr = isinstance(out, nt.CSR)
        v = (out.val if csr else out).clone()
        i = (out.nnz if csr else v.numel()) // 3
        v[i] += 1e-6 * max(abs(float(v[i])), 1.0)
        return dataclasses.replace(out, val=v) if csr else v
    return f


def stale(fn):
    """Each call hands back the previous answer to operands of its
    shapes (a set-up's levels differ in shape)."""
    last = {}

    def f(*a, **k):
        out = fn(*a, **k)
        key = tuple(tuple(x.shape) for x in a)
        prev = last.get(key, out)
        last[key] = out
        return prev
    return f


def moved_entry(fn):
    """One entry of C moved to the next column."""
    def f(*a, **k):
        out = fn(*a, **k)
        col = out.col.clone()
        col[out.nnz // 2] = (col[out.nnz // 2] + 1) % out.shape[1]
        return dataclasses.replace(out, col=col)
    return f


FAULTS = [(CELLS[0], "rap", f) for f in (altered, stale, moved_entry)] + [
    (CELLS[1], "spmv", f) for f in (altered, stale)]


@pytest.mark.parametrize("cell,name,fault", FAULTS,
                         ids=[f"{c[1]}-{f.__name__}" for c, _, f in FAULTS])
def test_a_broken_timed_path_is_not_correct(cell, name, fault, monkeypatch):
    monkeypatch.setattr(nt, name, fault(getattr(nt, name)))
    assert [ln["correct"] for ln in runs(cell, seeds=(3_000_000_031,))
            ] == [False]


def test_readers_of_the_recorder():
    """The readers take the calls recorded in ``bench.call`` spans, of
    any entry: host reads and their wait a call (a one-shot product; a
    set-up of two levels: two ``rap``); with no such call they read
    nothing."""
    from nsparse_tpu_torch.utils import profiling

    syncs = harness.reader("host_syncs_per_call.rap")
    wait = harness.reader("sync_wait_ms.rap")
    run = types.SimpleNamespace()
    profiling.reset()
    assert syncs.read(run) is None and wait.read(run) is None
    g = gen()
    h = g.hierarchy({"nx": 4, "ny": 4, "nz": 4, "levels": 2}, "cpu")
    r, p = (nt.CSR(rpt=m.rpt, col=m.col, val=m.val, shape=m.shape,
                   nnz=m.nnz) for m in h.transfers[0])
    a = g.operator((4, 4, 4), "cpu")
    a = nt.CSR(rpt=a.rpt, col=a.col, val=a.val, shape=a.shape, nnz=a.nnz)
    with profiling.recording():
        nt.rap(r, a, p)
    one = profiling.snapshot()
    profiling.reset()
    with profiling.recording():
        nt.spgemm(a, a)
    assert syncs.read(run) is None and wait.read(run) is None
    product = profiling.snapshot()["counters"]["sync"]
    profiling.reset()
    with profiling.recording():
        for _ in range(2):
            with profiling.span("bench.call"):
                nt.spgemm(a, a)
    assert product > 0 and syncs.read(run) == product
    assert wait.read(run) > 0
    profiling.reset()
    with profiling.recording():
        for _ in range(3):
            with profiling.span("bench.call"):
                nt.rap(r, a, p)
                nt.rap(r, a, p)
    assert syncs.read(run) == 2 * one["counters"]["sync"]
    waits = profiling.snapshot()["spans"]
    assert 0 < wait.read(run) <= 1e3 * waits["bench.call"]["total_s"] / 3
    profiling.reset()

"""The port's distributed layer (``nsparse_tpu_torch.parallel``) against
the JAX package's (``nsparse_tpu.parallel``), on the CPU.

The JAX side runs on the 8-device virtual CPU mesh of ``conftest.py``;
the port on ``make_mesh(D, device="cpu")``.  Both get the same inputs,
made from a seed with numpy.  Partitions and plan index arrays must equal
the JAX package's array for array; SpMV values agree within rtol 1e-12
(f64) or 1e-5 (f32), SpGEMM values within rtol 1e-8 (f64) or 1e-5 (f32)
of |A||B| (PERF.md §2), structure exact.

The JAX dist-window path takes tens of seconds on the CPU, so it runs
once, in a module fixture; its plans build the JAX package's native Benes
router, taken under a file lock (see ``tests/test_torch_window_v2.py``).
"""

import fcntl
import os
import tempfile
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import nsparse_tpu.parallel as jpar
import nsparse_tpu.parallel.spgemm as jps
from nsparse_tpu.formats.csr import CSR as JCSR

import nsparse_tpu_torch as nt
import nsparse_tpu_torch.parallel as tpar
import nsparse_tpu_torch.parallel.spgemm as tps
from nsparse_tpu_torch.parallel.partition import local_spmv
from nsparse_tpu_torch.tune import kernelgen as tkg
from nsparse_tpu_torch.utils.checking import (
    check_spgemm_answer,
    spgemm_abs_oracle,
    spgemm_oracle,
)

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs the 8-device virtual CPU mesh")

SPMV_RTOL = {np.float32: 1e-5, np.float64: 1e-12}
SPGEMM_RTOL = {np.float32: 1e-5, np.float64: 1e-8}


def _pair(s):
    """(JAX CSR, port CSR) of one scipy matrix."""
    return JCSR.from_scipy(s), nt.CSR.from_scipy(s)


def _random(m, n, density, seed, dtype=np.float64):
    return nt.random_csr(m, n, density, dtype=dtype, seed=seed).to_scipy()


def _stencil(nx, ny, dtype=np.float64):
    return nt.stencil_csr(nx, ny, dtype=dtype).to_scipy()


def _aggregation(n, nc, agg):
    """(P, R = P^T) as scipy CSR: node i -> aggregate agg[i]."""
    p = sp.csr_matrix((np.ones(n), (np.arange(n), agg)), shape=(n, nc))
    return p, p.T.tocsr()


def _cpu_mesh(n):
    return tpar.make_mesh(n, device="cpu")


def _np(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _assert_part_equal(jp, tp):
    assert tp.n_shards == jp.n_shards
    assert tp.shard_nnz == tuple(int(r[-1]) for r in np.asarray(jp.rpt))
    assert (tp.shape, tp.m_loc, tp.nnz) == (jp.shape, jp.m_loc, jp.nnz)
    assert tp.capacity == int(jp.val.shape[1])
    for f in ("rpt", "col", "val"):
        np.testing.assert_array_equal(_np(getattr(tp, f)),
                                      _np(getattr(jp, f)), err_msg=f)


def _assert_c_close(jc, tc, scale, dtype):
    """Port C against JAX C: rpt/col equal, values within rtol of
    ``scale`` (|A||B| on C's structure)."""
    np.testing.assert_array_equal(_np(tc.rpt), _np(jc.rpt))
    np.testing.assert_array_equal(_np(tc.col)[: tc.nnz], _np(jc.col)[: jc.nnz])
    tv = _np(tc.val)[: tc.nnz].astype(np.float64)
    jv = _np(jc.val)[: jc.nnz].astype(np.float64)
    bound = SPGEMM_RTOL[dtype] * np.maximum(np.abs(jv), scale)
    assert (np.abs(tv - jv) <= bound).all(), np.abs(tv - jv).max()


# -- mesh ---------------------------------------------------------------------


def test_make_mesh_shapes_and_devices():
    m = _cpu_mesh(8)
    assert m.size == 8 and m.shape == (8,) and m.axis_names == ("x",)
    assert all(d == torch.device("cpu") for d in m.devices)
    m2 = tpar.make_mesh(shape=(2, 4), axis_names=("x", "y"), device="cpu")
    assert m2.size == 8 and m2.shape == (2, 4) and m2.axis_names == ("x", "y")
    j2 = jpar.make_mesh(shape=(2, 4), axis_names=("x", "y"))
    assert tuple(j2.devices.shape) == m2.shape
    assert tuple(j2.axis_names) == m2.axis_names
    with pytest.raises(ValueError):
        tpar.make_mesh(4, shape=(3,), device="cpu")


# -- partitions ---------------------------------------------------------------

PART_CASES = {
    "random100x80": lambda: _random(100, 80, 0.07, 1),
    "stencil65": lambda: _stencil(13, 5),       # 65 rows on 8 shards
    "rmat8_f32": lambda: nt.rmat_csr(8, 4, dtype=np.float32,
                                     seed=2).to_scipy(),
}


@pytest.mark.parametrize("case", sorted(PART_CASES))
@pytest.mark.parametrize("n_shards", [3, 8])
def test_partition_rows_matches_jax(case, n_shards):
    ja, ta = _pair(PART_CASES[case]())
    jp = jpar.partition_rows(ja, n_shards)
    tp = tpar.partition_rows(ta, n_shards, mesh=_cpu_mesh(n_shards))
    _assert_part_equal(jp, tp)
    back = tpar.gather_partitioned(tp)
    np.testing.assert_array_equal(_np(back.rpt), _np(ta.rpt))
    np.testing.assert_array_equal(_np(back.val), _np(ta.val))


BANDED_CASES = {
    "stencil16x16_8": (lambda: _stencil(16, 16), 8),
    # 195 rows on 8 shards: a row-padded last shard
    "stencil15x13_8_f32": (lambda: _stencil(15, 13, np.float32), 8),
    "diag32_4": (lambda: sp.diags(np.arange(1.0, 33.0)).tocsr(), 4),
}


@pytest.mark.parametrize("case", sorted(BANDED_CASES))
def test_partition_banded_and_shard_x_match_jax(case):
    make, n_shards = BANDED_CASES[case]
    ja, ta = _pair(make())
    jp = jpar.partition_banded(ja, n_shards)
    tp = tpar.partition_banded(ta, n_shards, mesh=_cpu_mesh(n_shards))
    _assert_part_equal(jp, tp)
    assert tp.halo == jp.halo
    x = np.random.default_rng(7).standard_normal(ta.shape[0])
    jx = jpar.shard_x(jnp.asarray(x), n_shards, jp.m_loc)
    tx = tpar.shard_x(torch.from_numpy(x), n_shards, tp.m_loc)
    assert len(tx) == n_shards
    np.testing.assert_array_equal(torch.stack(tx).numpy(), np.asarray(jx))


# -- SpMV ---------------------------------------------------------------------


SPMV_CASES = {"random200x120": lambda: _random(200, 120, 0.05, 2),
              "stencil65": lambda: _stencil(13, 5)}
_JAX_SPMV = {}


def _jax_spmv_dist(case, dtype):
    """(A, x, the JAX row-sharded y), once per case and dtype: its gathered
    y is the sharded one flattened and cut to M (``spmv_dist``)."""
    if (case, dtype) not in _JAX_SPMV:
        s = SPMV_CASES[case]().astype(dtype)
        x = np.random.default_rng(3).standard_normal(s.shape[1]).astype(dtype)
        ja = JCSR.from_scipy(s)
        y = np.asarray(jpar.spmv_dist(jpar.partition_rows(ja, 8),
                                      jnp.asarray(x), jpar.make_mesh(8),
                                      gather=False))
        _JAX_SPMV[case, dtype] = (s, x, y)
    return _JAX_SPMV[case, dtype]


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("gather", [True, False])
@pytest.mark.parametrize("case", sorted(SPMV_CASES))
def test_spmv_dist_matches_jax(case, gather, dtype):
    s, x, jy = _jax_spmv_dist(case, dtype)
    if gather:
        jy = jy.reshape(-1)[: s.shape[0]]
    mesh = _cpu_mesh(8)
    ty = tpar.spmv_dist(tpar.partition_rows(nt.CSR.from_scipy(s), 8,
                                            mesh=mesh),
                        torch.from_numpy(x), mesh, gather=gather)
    ty = ty.numpy() if gather else torch.stack(ty).numpy()
    assert ty.shape == jy.shape and ty.dtype == jy.dtype
    np.testing.assert_allclose(ty, jy, rtol=SPMV_RTOL[dtype],
                               atol=SPMV_RTOL[dtype] * np.abs(jy).max())
    want = s @ x
    np.testing.assert_allclose(ty.reshape(-1)[: s.shape[0]], want,
                               rtol=SPMV_RTOL[dtype],
                               atol=SPMV_RTOL[dtype] * np.abs(want).max())


def test_local_spmv_matches_jax():
    from nsparse_tpu.parallel.partition import local_spmv as j_local

    ja, ta = _pair(_random(50, 40, 0.1, 4))
    jp, tp = jpar.partition_rows(ja, 3), tpar.partition_rows(ta, 3)
    x = np.random.default_rng(5).standard_normal(40)
    for d in range(3):
        jy = j_local(jp.rpt[d], jp.col[d], jp.val[d], jnp.asarray(x),
                     jp.m_loc)
        for nnz in (None, tp.shard_nnz[d]):  # the padded tail, or not
            ty = local_spmv(tp.rpts[d], tp.cols[d], tp.vals[d],
                            torch.from_numpy(x), tp.m_loc, nnz)
            np.testing.assert_allclose(ty.numpy(), np.asarray(jy),
                                       rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("case", sorted(BANDED_CASES))
def test_spmv_halo_matches_jax(case):
    make, n_shards = BANDED_CASES[case]
    s = make()
    dtype = s.dtype.type
    ja, ta = _pair(s)
    x = np.random.default_rng(1).standard_normal(s.shape[0]).astype(dtype)
    jp = jpar.partition_banded(ja, n_shards)
    jy = np.asarray(jpar.spmv_halo(
        jp, jpar.shard_x(jnp.asarray(x), n_shards, jp.m_loc),
        jpar.make_mesh(n_shards)))
    mesh = _cpu_mesh(n_shards)
    tp = tpar.partition_banded(ta, n_shards, mesh=mesh)
    ty = torch.stack(tpar.spmv_halo(
        tp, tpar.shard_x(torch.from_numpy(x), n_shards, tp.m_loc, mesh),
        mesh)).numpy()
    assert ty.shape == jy.shape
    np.testing.assert_allclose(ty, jy, rtol=SPMV_RTOL[dtype],
                               atol=SPMV_RTOL[dtype] * np.abs(jy).max())
    want = s @ x
    np.testing.assert_allclose(ty.reshape(-1)[: s.shape[0]], want,
                               rtol=SPMV_RTOL[dtype],
                               atol=SPMV_RTOL[dtype] * np.abs(want).max())


# -- refusals -----------------------------------------------------------------


def _wide(pkg):
    return pkg.partition_banded(
        (JCSR if pkg is jpar else nt.CSR).from_scipy(_random(64, 64, 0.3, 5)),
        8)


def _escaping(pkg):
    a = (JCSR if pkg is jpar else nt.CSR).from_scipy(_random(64, 64, 0.3, 3))
    ap = pkg.partition_rows(a, 8)
    return pkg.spgemm_halo_plan(ap, ap)


def _non_square(pkg):
    a = (JCSR if pkg is jpar else nt.CSR).from_scipy(_random(64, 48, 0.1, 3))
    return pkg.partition_banded(a, 4)


def _too_many_devices(pkg):
    # the JAX virtual mesh has 8 devices; the port sees no card here
    return pkg.make_mesh(9 if pkg is jpar else 1)


def _shard_mismatch(pkg):
    a = (JCSR if pkg is jpar else nt.CSR).from_scipy(_stencil(8, 8))
    return pkg.spgemm_halo_plan(pkg.partition_rows(a, 4),
                                pkg.partition_rows(a, 8))


@pytest.mark.parametrize("refusal", [_wide, _escaping, _non_square,
                                     _too_many_devices, _shard_mismatch],
                         ids=lambda f: f.__name__.strip("_"))
def test_refusals_match_jax(refusal):
    if refusal is _too_many_devices and torch.cuda.is_available():
        pytest.skip("a card is visible: make_mesh(1) succeeds")
    with pytest.raises(ValueError):
        refusal(jpar)
    with pytest.raises(ValueError):
        refusal(tpar)


def test_dist_window_refuses_what_jax_refuses():
    """A shard without products takes no window plan: both packages raise
    NotImplementedError (every shard must take the v2 form)."""
    s = sp.csr_matrix(sp.diags(np.ones(32)).tocsr())
    s[20:, :] = 0
    s.eliminate_zeros()
    ja, ta = _pair(s)
    with pytest.raises(NotImplementedError):
        jpar.spgemm_plan_dist_window(jpar.partition_rows(ja, 4), ja)
    with pytest.raises(NotImplementedError):
        tpar.spgemm_plan_dist_window(tpar.partition_rows(ta, 4), ta)


# -- SpGEMM, B replicated -----------------------------------------------------


def _new_values(part, seed):
    """Per-shard values with the same sparsity: padded slots stay 0."""
    rng = np.random.default_rng(seed)
    out = []
    for d in range(part.n_shards):
        v = part.vals[d].clone()
        n = part.shard_nnz[d]
        v[:n] = torch.from_numpy(rng.uniform(0.5, 1.5, n).astype(
            v.numpy().dtype))
        out.append(v)
    return out


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_spgemm_plan_dist_matches_jax(dtype):
    s = _random(96, 96, 0.06, 5).astype(dtype)
    ja, ta = _pair(s)
    jp = jpar.partition_rows(ja, 8)
    mesh = _cpu_mesh(8)
    tp = tpar.partition_rows(ta, 8, mesh=mesh)
    jplan = jps.spgemm_plan_dist(jp, ja)
    tplan = tpar.spgemm_plan_dist(tp, ta)
    assert tplan.c_nnz == jplan.c_nnz
    assert (tplan.shape, tplan.m_loc, tplan.n_products) == (
        jplan.shape, jplan.m_loc, jplan.n_products)
    assert tplan.c_capacity == jplan.c_capacity
    for f in ("c_rpt", "c_col", "apos", "bpos", "out_pos"):
        np.testing.assert_array_equal(_np(getattr(tplan, f)),
                                      _np(getattr(jplan, f)), err_msg=f)
    scale = spgemm_abs_oracle(ta, ta).data
    jc = jps.gather_partitioned(jps.spgemm_numeric_dist(
        jplan, jp, ja, jpar.make_mesh(8)))
    tc_part = tpar.spgemm_dist(tp, ta, mesh, plan=tplan)
    _assert_c_close(jc, tpar.gather_partitioned(tc_part), scale, dtype)
    # a value re-run on the same plans
    tp2 = tp.with_values(_new_values(tp, 9))
    a2 = tpar.gather_partitioned(tp2)
    tc2 = tpar.gather_partitioned(tps.spgemm_numeric_dist(tplan, tp2, a2,
                                                          mesh))
    assert check_spgemm_answer(tc2, spgemm_oracle(a2, a2),
                               abs_ref=spgemm_abs_oracle(a2, a2))


def test_one_device_mesh_copies_nothing(monkeypatch):
    """On a one-device mesh whose shards and plans already live there, the
    numeric phase copies neither A nor a plan."""
    s = _random(64, 64, 0.08, 6)
    _, ta = _pair(s)
    mesh = _cpu_mesh(1)
    tp = tpar.partition_rows(ta, 1, mesh=mesh)
    plan = tpar.spgemm_plan_dist(tp, ta)

    def no_copy(*a, **k):
        raise AssertionError("a plan was copied in the numeric phase")

    monkeypatch.setattr(type(plan.plans[0]), "to", no_copy)
    c = tps.spgemm_numeric_dist(plan, tp, ta, mesh)
    assert tp.shard(0).val.data_ptr() == tp.vals[0].data_ptr()
    monkeypatch.undo()
    assert check_spgemm_answer(tpar.gather_partitioned(c),
                               spgemm_oracle(ta, ta))


# -- SpGEMM, halo exchange ----------------------------------------------------

HALO_CASES = {
    "stencil16x16": (lambda: _stencil(16, 16), 8),
    "stencil15x13_f32": (lambda: _stencil(15, 13, np.float32), 8),
}


@pytest.mark.parametrize("case", sorted(HALO_CASES))
def test_spgemm_halo_matches_jax(case):
    make, n_shards = HALO_CASES[case]
    s = make()
    dtype = s.dtype.type
    ja, ta = _pair(s)
    jp = jpar.partition_rows(ja, n_shards)
    mesh = _cpu_mesh(n_shards)
    tp = tpar.partition_rows(ta, n_shards, mesh=mesh)
    jplan = jpar.spgemm_halo_plan(jp, jp)
    tplan = tpar.spgemm_halo_plan(tp, tp)
    assert tplan.c_nnz == jplan.c_nnz
    assert tplan.n_products == jplan.n_products
    for f in ("c_rpt", "c_col", "apos", "bpos", "out_pos"):
        np.testing.assert_array_equal(_np(getattr(tplan, f)),
                                      _np(getattr(jplan, f)), err_msg=f)
    # the local B of every shard is the JAX package's, array for array
    from nsparse_tpu.parallel.spgemm_halo import _local_b_csr as j_local_b

    for d in range(n_shards):
        jb, tb = j_local_b(jp, d, n_shards), tplan.b_locs[d]
        assert (tb.shape, tb.nnz) == (jb.shape, jb.nnz)
        np.testing.assert_array_equal(tb.rpt.numpy(), np.asarray(jb.rpt))
        np.testing.assert_array_equal(tb.col.numpy(), np.asarray(jb.col))
    scale = spgemm_abs_oracle(ta, ta).data
    jc = jps.gather_partitioned(jpar.spgemm_halo(jp, jp, jpar.make_mesh(
        n_shards)))
    tc = tpar.gather_partitioned(tpar.spgemm_halo(tp, tp, mesh, plan=tplan))
    _assert_c_close(jc, tc, scale, dtype)
    assert check_spgemm_answer(tc, spgemm_oracle(ta, ta), abs_ref=scale)
    # new values on the same plan
    tp2 = tp.with_values(_new_values(tp, 4))
    a2 = tpar.gather_partitioned(tp2)
    tc2 = tpar.gather_partitioned(tpar.spgemm_halo(tp2, tp2, mesh,
                                                   plan=tplan))
    assert check_spgemm_answer(tc2, spgemm_oracle(a2, a2),
                               abs_ref=spgemm_abs_oracle(a2, a2))


def _rap_operands(n, nc, agg, a):
    p, r = _aggregation(n, nc, agg)
    return [_pair(x) for x in (r, a, p)]


def _rap_scale(r, a, p):
    sa = (abs(r.to_scipy()) @ abs(a.to_scipy()) @ abs(p.to_scipy())).tocsr()
    sa.sum_duplicates()
    sa.sort_indices()
    ref = (r.to_scipy() @ a.to_scipy() @ p.to_scipy()).tocsr()
    ref.sum_duplicates()
    ref.sort_indices()
    return ref, sa


def test_rap_halo_matches_jax():
    n, nc = 256, 64
    (jr, tr), (ja, ta), (jp, tp) = _rap_operands(
        n, nc, np.arange(n) // 4, _stencil(16, 16))
    jc = jps.gather_partitioned(jpar.rap_halo(
        *(jpar.partition_rows(x, 8) for x in (jr, ja, jp)),
        jpar.make_mesh(8)))
    mesh = _cpu_mesh(8)
    tc = tpar.gather_partitioned(tpar.rap_halo(
        *(tpar.partition_rows(x, 8, mesh=mesh) for x in (tr, ta, tp)), mesh))
    ref, sa = _rap_scale(tr, ta, tp)
    _assert_c_close(jc, tc, sa.data, np.float64)
    assert check_spgemm_answer(tc, ref, abs_ref=sa)


# -- the dist window ----------------------------------------------------------


@pytest.fixture(scope="module")
def jax_dist_window():
    """The JAX package's dist window C of R-MAT-9 (edge factor 6, f32,
    seed 3) over 4 shards, built once under the native router's lock."""
    import nsparse_tpu.native as jnative

    path = os.path.join(tempfile.gettempdir(), "nsparse_tpu_native.lock")
    with open(path, "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            lib = jnative.get_lib()
            if lib is None:
                jnative._build_failed = False
                time.sleep(10)
                lib = jnative.get_lib()
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
    if lib is None:
        pytest.fail("the JAX package's native Benes router neither built "
                    "nor loaded twice; its dist window plans need it")
    s = nt.rmat_csr(9, edge_factor=6, dtype=np.float32, seed=3).to_scipy()
    ja, ta = _pair(s)
    jp = jpar.partition_rows(ja, 4)
    dp = jpar.spgemm_plan_dist_window(jp, ja)
    jc = jps.gather_partitioned(jpar.spgemm_numeric_dist_window(
        dp, jp, ja, jpar.make_mesh(4)))
    return ta, dp, jc


def test_dist_window_matches_jax(jax_dist_window):
    ta, jdp, jc = jax_dist_window
    mesh = _cpu_mesh(4)
    tp = tpar.partition_rows(ta, 4, mesh=mesh)
    dp = tpar.spgemm_plan_dist_window(tp, ta)
    assert all(p.layout == "window" and p.win.fused_expand for p in dp.plans)
    assert dp.c_nnz == jdp.c_nnz and dp.n_products == jdp.n_products
    for d in range(4):
        n = dp.c_nnz[d]
        np.testing.assert_array_equal(dp.c_rpt[d].numpy(),
                                      np.asarray(jdp.plan.c_rpt[d]))
        np.testing.assert_array_equal(dp.c_col[d, :n].numpy(),
                                      np.asarray(jdp.plan.c_col[d, :n]))
    tc = tpar.gather_partitioned(tpar.spgemm_numeric_dist_window(
        dp, tp, ta, mesh))
    scale = spgemm_abs_oracle(ta, ta).data
    _assert_c_close(jc, tc, scale, np.float32)
    assert check_spgemm_answer(tc, spgemm_oracle(ta, ta), abs_ref=scale)
    # a value re-run on the same plans
    tp2 = tp.with_values(_new_values(tp, 9))
    a2 = tpar.gather_partitioned(tp2)
    tc2 = tpar.gather_partitioned(tpar.spgemm_numeric_dist_window(
        dp, tp2, a2, mesh))
    assert check_spgemm_answer(tc2, spgemm_oracle(a2, a2),
                               abs_ref=spgemm_abs_oracle(a2, a2))


def _fallback_heavy():
    """256 rows of 4 random columns and two dense rows (3 and 100), which
    no window of a two-class ladder holds."""
    rng = np.random.default_rng(11)
    m = 256
    rows, cols, vals = [], [], []
    for r in range(m):
        rows += [r] * 4
        cols += list(rng.choice(m, size=4, replace=False))
        vals += list(rng.standard_normal(4))
    for r in (3, 100):
        rows += [r] * m
        cols += list(range(m))
        vals += list(rng.standard_normal(m))
    s = sp.csr_matrix((np.asarray(vals, np.float32),
                       (np.asarray(rows), np.asarray(cols))), shape=(m, m))
    s.sum_duplicates()
    return s


@pytest.mark.parametrize("case", ["uneven", "fallback"])
def test_dist_window_against_scipy(case, monkeypatch):
    if case == "uneven":
        # 100 rows over 4 shards: a row-padded last shard
        s, n_shards = _random(100, 100, 0.15, 11, np.float32), 4
    else:
        monkeypatch.setattr(tkg, "N_WIN_CLASSES", 2)
        s, n_shards = _fallback_heavy(), 4
    _, ta = _pair(s)
    mesh = _cpu_mesh(n_shards)
    tp = tpar.partition_rows(ta, n_shards, mesh=mesh)
    dp = tpar.spgemm_plan_dist_window(tp, ta)
    fb = [p.win.fb_shuffle is not None for p in dp.plans]
    assert any(fb) == (case == "fallback"), fb
    c = tpar.spgemm_numeric_dist_window(dp, tp, ta, mesh)
    for d in range(n_shards):
        assert not c.vals[d][dp.c_nnz[d]:].any()
    assert check_spgemm_answer(tpar.gather_partitioned(c),
                               spgemm_oracle(ta, ta),
                               abs_ref=spgemm_abs_oracle(ta, ta))


# -- R·A·P with A·P on the devices -------------------------------------------


@pytest.mark.parametrize("numeric", ["esc", "window"])
def test_rap_dist_keeps_ap_on_the_devices(numeric, monkeypatch):
    """No host gather inside the chain: gather_partitioned raises there.
    The result equals scipy's."""
    n, nc = 64, 24
    agg = np.random.default_rng(8).integers(0, nc, n)
    (_, tr), (_, ta), (_, tp) = _rap_operands(n, nc, agg, _stencil(8, 8))

    def boom(*a, **k):
        raise AssertionError("A·P gathered on the host mid-R·A·P")

    monkeypatch.setattr(tps, "gather_partitioned", boom)
    parts = tpar.rap_dist_parts(tr, ta, tp, _cpu_mesh(4), numeric=numeric)
    monkeypatch.undo()
    got = tpar.gather_partitioned(parts)
    ref, sa = _rap_scale(tr, ta, tp)
    assert check_spgemm_answer(got, ref, abs_ref=sa)
    assert tpar.rap_dist(tr, ta, tp, _cpu_mesh(4), numeric=numeric) == got

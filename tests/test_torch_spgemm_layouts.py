"""The port's SpGEMM layouts and planners against the JAX package.

The same matrices, made from a seed with numpy, go through the JAX
package and the port on the CPU, where every kernel wrapper runs its
plain PyTorch version:

- the layout rule of ``spgemm_plan`` (window, global slab, sort);
- the sort layout's plan arrays and C;
- the global slab layout's piece tables, slab arrays and C, against the
  JAX slab numeric phase on ``tests/test_spgemm.py``'s three slab cases
  (one through its Pallas kernels in interpret mode, ``FORCE_PALLAS``, as
  that file runs them);
- K2's unaligned (flat) mode, through ``BANK_ROWS_MAX`` patched in both
  packages: its tables equal JAX's, and C matches scipy on any B, and
  JAX on a B whose row degrees are multiples of 8 (elsewhere the JAX
  package reads raw ``b.val`` at 8-aligned offsets, and its C is wrong);
- run-dense subtiles (B rows with no entries), routed element-wise in
  both modes as the JAX plan routes them;
- the device planner, the ``planner=`` argument and the CLI's
  ``--planner``;
- the repaired faults: slack-free window layouts, empty products, and
  products whose rows all overflow the window arenas.

Tolerances: C's structure exactly; values within 2e-5 (f32) or 1e-10
(f64) of |A||B| of JAX's (sums in another order), and the scipy check
scaled by |A||B|.
"""

import dataclasses

import numpy as np
import pytest
import scipy.sparse as sp

import jax
import jax.numpy as jnp
import torch

import nsparse_tpu.ops.kernels.flat_gather as jfg
import nsparse_tpu.ops.kernels.piecewise as jpw
from nsparse_tpu.formats.csr import CSR as JCSR
from nsparse_tpu.io.generate import rmat_csr as jrmat
from nsparse_tpu.ops.spgemm import _spgemm_numeric_slab as j_slab
from nsparse_tpu.ops.spgemm import spgemm_numeric as j_numeric
from nsparse_tpu.ops.spgemm import spgemm_plan as j_plan
from nsparse_tpu.ops.spgemm import spgemm_plan_device as j_plan_device
from nsparse_tpu.ops.spgemm import spgemm_symbolic_nnz as j_symbolic_nnz

import nsparse_tpu_torch as nt
from nsparse_tpu_torch.ops.kernels import piecewise as tpw
from nsparse_tpu_torch.ops.spgemm import spgemm_numeric_slab

RTOL = {np.float32: 2e-5, np.float64: 1e-10}


def _np(x):
    return np.asarray(x).astype(np.int64)


def _both(s, dtype=np.float64):
    """(JAX CSR, port CSR) of a scipy matrix."""
    s = sp.csr_matrix(s).astype(dtype)
    return JCSR.from_scipy(s), nt.CSR.from_scipy(s)


def _rmat(dtype=np.float64):
    return (jrmat(9, edge_factor=6, dtype=dtype, seed=4),
            nt.rmat_csr(9, edge_factor=6, dtype=dtype, seed=4))


def _slab_case(case, dtype):
    """tests/test_spgemm.py's three slab cases: (ja, jb, ta, tb)."""
    if case == "rmat":
        ja, ta = _rmat(dtype)
        return ja, ja, ta, ta
    rng = np.random.default_rng(7 if case == "multilevel" else 8)
    if case == "multilevel":
        a_s = rng.standard_normal((3, 1400))
        b_s = rng.standard_normal((1400, 5))
    else:
        m = 64
        dense_row = rng.standard_normal((1, m))
        body = sp.random(m - 1, m, density=0.08, random_state=9)
        a_s = np.vstack([dense_row, body.toarray()])
        b_s = rng.standard_normal((m, 20))
    (ja, ta), (jb, tb) = _both(a_s, dtype), _both(b_s, dtype)
    return ja, jb, ta, tb


def _no_window(dtype=np.float64):
    """The smallest product whose only row overflows every window arena:
    one C entry of 4097 > LEN_MAX products (1 x 4097 times 4097 x 1)."""
    (ja, ta), (jb, tb) = (_both(np.ones((1, 4097)), dtype),
                          _both(np.ones((4097, 1)), dtype))
    return ja, jb, ta, tb


def _empty_cases():
    """A 5 x 7 zero A times its transpose, and A^2 for a 10 x 10 A whose
    two entries (0, 3) and (9, 4) meet only empty rows."""
    z = sp.csr_matrix((5, 7))
    e = sp.csr_matrix((np.ones(2), ([0, 9], [3, 4])), shape=(10, 10))
    return [(z, z.T.tocsr()), (e, e)]


def _jax_layout(jp):
    if jp.win is not None:
        return "window"
    return "global" if jp.slab_shuffle is not None else "sort"


def _check_c(jc, tc, ta, tb, dtype):
    """C of the port against JAX (structure exactly, values within RTOL of
    |A||B|) and the scipy oracle."""
    nnz = tc.nnz
    np.testing.assert_array_equal(_np(jc.rpt), tc.rpt.numpy())
    np.testing.assert_array_equal(_np(jc.col)[:nnz], tc.col.numpy()[:nnz])
    err = np.abs(tc.val.numpy()[:nnz].astype(np.float64)
                 - np.asarray(jc.val)[:nnz].astype(np.float64))
    scale = nt.spgemm_abs_oracle(ta, tb).data if nnz else 0.0
    assert (err <= RTOL[dtype] * scale + 1e-12).all(), err.max()
    _check_scipy(tc, ta, tb)


def _check_scipy(tc, ta, tb):
    assert nt.check_spgemm_answer(tc, nt.spgemm_oracle(ta, tb), verbose=True,
                                  abs_ref=nt.spgemm_abs_oracle(ta, tb))
    assert not tc.val[tc.nnz :].any()


# -- the layout rule --------------------------------------------------------


@pytest.mark.parametrize("case,kw,want", [
    ("rmat", {}, "sort"),
    ("rmat", dict(shuffle=True, layout="window"), "window"),
    ("no_window", dict(shuffle=True), "global"),
    ("rmat", dict(shuffle=True, layout="global"), "global"),
    ("empty", dict(shuffle=True), "sort"),
])
def test_layout_rule_matches_jax(case, kw, want):
    """Below 2^20 products, windows forced, windows that do not apply, the
    global layout asked for, an empty product: both packages take the
    same layout, and a forced window layout that cannot be built raises
    the same error in both."""
    if case == "rmat":
        ja, ta = _rmat()
        jb, tb = ja, ta
    elif case == "no_window":
        ja, jb, ta, tb = _no_window()
    else:
        (ja, ta), (jb, tb) = (_both(s) for s in _empty_cases()[0])
    assert _jax_layout(j_plan(ja, jb, **kw)) == want
    tp = nt.spgemm_plan(ta, tb, **kw)
    assert tp.layout == want
    assert {"window": tp.win, "global": tp.glob, "sort": tp.srt}[want] \
        is not None
    if case == "no_window":
        with pytest.raises(ValueError) as je:
            j_plan(ja, jb, shuffle=True, layout="window")
        with pytest.raises(ValueError) as te:
            nt.spgemm_plan(ta, tb, shuffle=True, layout="window")
        assert str(te.value) == str(je.value)


# -- the sort layout ---------------------------------------------------------


def _gather_plan_equal(jg, tg):
    np.testing.assert_array_equal(_np(jg.idx2d), tg.idx2d.numpy())
    np.testing.assert_array_equal(_np(jg.fb_ids), tg.fb_ids.numpy())
    assert tuple(jg.classes) == tg.classes and jg.n == tg.n
    for ji, ti in zip(jg.ids, tg.ids):
        np.testing.assert_array_equal(_np(ji), ti.numpy())


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_sort_plan_matches_jax(dtype):
    """Every array of the sort plan equals JAX's (the gather plans routed
    alike), and C is JAX's, also on new values on the same plan."""
    ja, ta = _rmat(dtype)
    jp, tp = j_plan(ja, ja), nt.spgemm_plan(ta, ta)
    s = tp.srt
    for name in ("apos", "bpos", "out_pos", "ends", "uniq_bpos", "bp_rank"):
        np.testing.assert_array_equal(_np(getattr(jp, name)),
                                      getattr(s, name).numpy(), err_msg=name)
    _gather_plan_equal(jp.av_gp, s.av_gp)
    _gather_plan_equal(jp.bv_gp, s.bv_gp)
    _check_c(j_numeric(jp, ja, ja), nt.spgemm_numeric(tp, ta, ta), ta, ta,
             dtype)
    v2 = np.random.default_rng(3).standard_normal(ta.nnz).astype(dtype)
    ja2 = dataclasses.replace(ja, val=jnp.asarray(v2))
    ta2 = ta.with_values(torch.from_numpy(v2))
    _check_c(j_numeric(jp, ja2, ja2), nt.spgemm_numeric(tp, ta2, ta2), ta2,
             ta2, dtype)


# -- the global slab layout ---------------------------------------------------


def _piece_tables_equal(jw, tw):
    """The port's PiecewisePlan against the JAX one, array for array."""
    assert (jw.n, jw.n_pad, jw.nnz_a, jw.nnz_b, jw.aligned) == (
        tw.n, tw.n_pad, tw.nnz_a, tw.nnz_b, tw.aligned)
    # the JAX plan keeps the bank's size in the unaligned mode too
    assert tw.bank_rows == (jw.bank_rows if jw.aligned else 0)
    for jx, tx in ((jw.ids, tw.ids), (jw.cuts, tw.cuts),
                   (jw.boffs, tw.boffs)):
        assert len(jx) == len(tx)
        for j, t in zip(jx, tx):
            np.testing.assert_array_equal(_np(j), t.numpy())
    jaidx = np.concatenate([_np(x) for x in jw.aidx])
    apv = tw.apv_idx.numpy()
    np.testing.assert_array_equal(jaidx, np.where(apv < 0, tw.nnz_a, apv))
    for name in ("arena_src", "fb_ids", "fb_bidx", "fb_aidx"):
        np.testing.assert_array_equal(_np(getattr(jw, name)),
                                      getattr(tw, name).numpy(), err_msg=name)


def _slab_equal(jp, tp):
    g = tp.glob
    _piece_tables_equal(jp.pw, g.pw)
    n_src = g.pw.n  # the port zero-fills past the products
    js = _np(jp.slab_shuffle.idx)
    np.testing.assert_array_equal(np.where(js < n_src, js, -1),
                                  g.slab_shuffle.idx.numpy())
    ja_ = _np(jp.asm_shuffle.idx)
    res = sum(cnt for lv in g.slab_levels for _, cnt in lv)  # res_off
    np.testing.assert_array_equal(np.where(ja_ < res, ja_, -1),
                                  g.asm_shuffle.idx.numpy())
    assert tuple(jp.slab_levels) == g.slab_levels
    for ji, ti in zip(jp.lvl_idx, g.lvl_idx):
        np.testing.assert_array_equal(_np(ji), ti.numpy())


@pytest.mark.parametrize("case,interpret", [
    ("rmat", True), ("multilevel", False), ("mixed", False)])
def test_global_plan_matches_jax(case, interpret, monkeypatch):
    """The global plan's piece tables and slab arrays equal JAX's, and its
    C (f32) is the JAX slab numeric phase's: on R-MAT through the Pallas
    kernels in interpret mode (25 s), on the other two through the JAX
    package's plain path (interpret mode would take 35-45 s each)."""
    dtype = np.float32
    ja, jb, ta, tb = _slab_case(case, dtype)
    jp = j_plan(ja, jb, shuffle=True, layout="global")
    tp = nt.spgemm_plan(ta, tb, shuffle=True, layout="global")
    assert tp.layout == "global" and tp.glob.pw.aligned
    _slab_equal(jp, tp)
    if case == "multilevel":
        assert len(tp.glob.slab_levels) >= 2 and tp.glob.lvl_idx
    monkeypatch.setattr(jfg, "FORCE_PALLAS", interpret)
    # the plain path reads its tables on the host: it runs eagerly
    jc = (jax.jit(j_slab) if interpret else j_slab)(jp, ja, jb)
    _check_c(jc, nt.spgemm_numeric(tp, ta, tb), ta, tb, dtype)


# -- K2's unaligned (flat) mode -----------------------------------------------


@pytest.fixture
def unaligned(monkeypatch):
    """Every bank past BANK_ROWS_MAX in both packages: the unaligned mode."""
    monkeypatch.setattr(jpw, "BANK_ROWS_MAX", 1)
    monkeypatch.setattr(tpw, "BANK_ROWS_MAX", 1)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_unaligned_tables_and_values(dtype, unaligned):
    """R-MAT (row degrees of every kind): the flat tables equal JAX's,
    and C, read from the 8-aligned table, matches scipy; the plain
    numeric phase equals the kernel route's."""
    ja, ta = _rmat(dtype)
    jp = j_plan(ja, ja, shuffle=True, layout="global")
    tp = nt.spgemm_plan(ta, ta, shuffle=True, layout="global")
    assert not tp.glob.pw.aligned and not jp.pw.aligned
    _slab_equal(jp, tp)
    assert tp.glob.pw.table_rows == tpw.flat_table_rows(tp.glob.pw.nnz_b)
    c = nt.spgemm_numeric(tp, ta, ta)
    _check_scipy(c, ta, ta)
    from nsparse_tpu_torch.ops.spgemm_window import PLAIN_OPS

    assert torch.equal(spgemm_numeric_slab(tp, ta, ta, PLAIN_OPS).val, c.val)


def _rows_of_eights(seed=21, n=96):
    """A (48 x 96, density 0.1) and B (96 x 96) whose row degrees are 0, 8
    or 16: the empty B rows give runs with no products, which pack more
    than 128 pieces into some subtiles (the run-dense route)."""
    rng = np.random.default_rng(seed)
    b_s = sp.lil_matrix((n, n))
    for r in range(n):
        deg = 8 * int(rng.integers(0, 3))
        b_s[r, rng.choice(n, size=deg, replace=False)] = \
            rng.standard_normal(deg)
    a_s = sp.random(48, n, density=0.1, random_state=4)
    return _both(a_s), _both(b_s)


@pytest.mark.parametrize("mode", ["aligned", "unaligned"])
def test_run_dense_subtiles_match_jax(mode, monkeypatch):
    """B row degrees all multiples of 8 (where the JAX package's unaligned
    mode reads its raw ``b.val`` offsets correctly), some 0: the plans
    route run-dense subtiles element-wise (K1, K6) in both modes, their
    tables equal JAX's, and C is JAX's and scipy's."""
    if mode == "unaligned":
        monkeypatch.setattr(jpw, "BANK_ROWS_MAX", 1)
        monkeypatch.setattr(tpw, "BANK_ROWS_MAX", 1)
    (ja, ta), (jb, tb) = _rows_of_eights()
    assert not (np.diff(tb.rpt.numpy()) % 8).any()
    jp = j_plan(ja, jb, shuffle=True, layout="global")
    tp = nt.spgemm_plan(ta, tb, shuffle=True, layout="global")
    assert tp.glob.pw.aligned == (mode == "aligned")
    assert tp.glob.pw.fb_ids.numel()
    _slab_equal(jp, tp)
    _check_c(j_slab(jp, ja, jb), nt.spgemm_numeric(tp, ta, tb), ta, tb,
             np.float64)


# -- the device planner and spgemm(planner=) ---------------------------------


def _device_cases():
    ja, ta = _rmat()
    (je, te), (je2, te2) = (_both(s) for s in _empty_cases()[1])
    return [("rmat", ja, ja, ta, ta), ("empty", je, je2, te, te2)]


@pytest.mark.parametrize("case", ["rmat", "empty"])
def test_device_planner_matches_jax(case):
    """c_rpt, c_col, out_pos and ends equal JAX's; each entry's products
    (apos, bpos) equal as a set; C matches JAX's."""
    _, ja, jb, ta, tb = {c[0]: c for c in _device_cases()}[case]
    jp, tp = j_plan_device(ja, jb), nt.spgemm_plan_device(ta, tb)
    assert (tp.layout, tp.planner) == ("sort", "device")
    assert (jp.n_products, jp.c_nnz) == (tp.n_products, tp.c_nnz)
    s = tp.srt
    for j, t in ((jp.c_rpt, tp.c_rpt), (jp.c_col, tp.c_col),
                 (jp.out_pos, s.out_pos), (jp.ends, s.ends)):
        np.testing.assert_array_equal(_np(j), t.numpy())
    p = tp.n_products

    def triples(out_pos, apos, bpos):
        t3 = np.stack([out_pos[:p], apos[:p], bpos[:p]], 1)
        return t3[np.lexsort(t3.T[::-1])]

    np.testing.assert_array_equal(
        triples(_np(jp.out_pos), _np(jp.apos), _np(jp.bpos)),
        triples(s.out_pos.numpy(), s.apos.numpy(), s.bpos.numpy()))
    _check_c(j_numeric(jp, ja, jb), nt.spgemm_numeric(tp, ta, tb), ta, tb,
             np.float64)


def test_device_planner_key_limit_matches_jax():
    """M * N >= 2^31 overflows the packed sort key: both packages refuse
    it with the same error."""
    (ja, ta), (jb, tb) = _both(sp.csr_matrix((1 << 16, 1))), \
        _both(sp.csr_matrix((1, 1 << 15)))
    with pytest.raises(ValueError) as je:
        j_plan_device(ja, jb)
    with pytest.raises(ValueError) as te:
        nt.spgemm_plan_device(ta, tb)
    assert str(te.value) == str(je.value)


@pytest.mark.parametrize("planner,layout", [
    ("auto", "sort"), ("device", "sort"), ("host", "sort"), ("bogus", None),
])
def test_spgemm_planner_argument(planner, layout):
    """``spgemm(a, b, planner=)``: auto and device take the device
    planner, host the host plan; any other value raises."""
    _, ta = _rmat()
    if layout is None:
        with pytest.raises(ValueError, match="planner"):
            nt.spgemm(ta, ta, planner=planner)
        return
    _check_scipy(nt.spgemm(ta, ta, planner=planner), ta, ta)


def test_segsum_oracle_and_symbolic_nnz():
    """``spgemm_numeric_segsum(plan, a, b)`` (JAX's signature) on host and
    device sort plans equals the numeric phase; a window plan carries no
    product arrays and raises; ``spgemm_symbolic_nnz`` is JAX's."""
    ja, ta = _rmat()
    c = nt.spgemm_numeric(nt.spgemm_plan(ta, ta), ta, ta)
    for plan in (nt.spgemm_plan(ta, ta), nt.spgemm_plan_device(ta, ta)):
        ref = nt.spgemm_numeric_segsum(plan, ta, ta)
        np.testing.assert_array_equal(ref.col.numpy(), c.col.numpy())
        np.testing.assert_allclose(ref.val.numpy(), c.val.numpy(),
                                   rtol=1e-12, atol=1e-12)
    with pytest.raises(ValueError, match="no product arrays"):
        nt.spgemm_numeric_segsum(
            nt.spgemm_plan(ta, ta, shuffle=True, layout="window"), ta, ta)
    assert nt.spgemm_symbolic_nnz(ta, ta) == j_symbolic_nnz(ja, ja)


@pytest.mark.parametrize("planner", ["device", "host", "auto"])
def test_cli_spgemm_planners(planner, capsys):
    from nsparse_tpu_torch.cli import main

    rc = main(["--precision", "double", "spgemm", "gen:rmat:8:4",
               "--method", "esc", "--planner", planner, "--device", "cpu"])
    out = capsys.readouterr().out
    assert rc == 0, out
    want = "host" if planner == "host" else "device"
    assert f"layout: sort ({want} plan" in out
    assert out.rstrip().endswith("pass")


# -- the repaired faults --------------------------------------------------------


def test_slack_free_window_layout():
    """C = A·A for a 128 x 128 all-ones A: every window is full, so the
    layout has no gap runs (the JAX window planner shares the fault, so
    C is held against scipy)."""
    _, ta = _both(np.ones((128, 128)))
    tp = nt.spgemm_plan(ta, ta, shuffle=True, layout="window")
    assert tp.layout == "window"
    c = nt.spgemm_numeric(tp, ta, ta)
    np.testing.assert_array_equal(c.rpt.numpy(), np.arange(129) * 128)
    _check_scipy(c, ta, ta)


@pytest.mark.parametrize("which", [0, 1])
def test_empty_products(which):
    """A product with no intermediate products is an empty C (nnz 0, the
    JAX package's row pointers), under every planner."""
    (ja, ta), (jb, tb) = (_both(s) for s in _empty_cases()[which])
    jc = j_numeric(j_plan(ja, jb), ja, jb)
    for c in (nt.spgemm(ta, tb), nt.spgemm(ta, tb, planner="host"),
              nt.spgemm_numeric(nt.spgemm_plan(ta, tb, shuffle=True), ta,
                                tb)):
        assert c.nnz == jc.nnz == 0
        np.testing.assert_array_equal(c.rpt.numpy(), _np(jc.rpt))
        assert not c.val.any()


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_rows_beyond_every_window(dtype):
    """The only row of C needs more than LEN_MAX products in one entry, so
    no row fits a window: the plan takes the global layout, as JAX's
    does, and C matches JAX (its slab numeric phase) and scipy."""
    ja, jb, ta, tb = _no_window(dtype)
    jp = j_plan(ja, jb, shuffle=True)
    tp = nt.spgemm_plan(ta, tb, shuffle=True)
    assert tp.layout == "global" == _jax_layout(jp)
    _slab_equal(jp, tp)
    _check_c(j_slab(jp, ja, jb), nt.spgemm_numeric(tp, ta, tb), ta, tb,
             dtype)

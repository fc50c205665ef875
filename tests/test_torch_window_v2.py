"""The port's v2 window numeric phase against the JAX package's.

The JAX package builds its v2 form (in-kernel expansion from the
pre-rolled B bank) when it plans for the accelerator; here its plans are
built under ``NSPARSE_PLAN_TARGET=tpu``, which on the CPU gives the same
window geometry, and its kernels run in interpret mode or through their
plain references.  The port builds v2 whenever the bank fits
``FUSED_BANK_BUDGET``.  Plans must match array for array; the bank, the
per-piece A values and the piece expansion bit for bit; class outputs
and C must equal the port's own v1 form (``torch.equal``), and C must
match the JAX result and scipy at the bounds of ``tests/test_torch_spgemm.py``.
"""

import dataclasses
import fcntl
import os
import tempfile
import time

import numpy as np
import pytest

import jax.numpy as jnp
import torch

import nsparse_tpu.ops.spgemm_window as jwin
from nsparse_tpu.io.generate import rmat_csr as jrmat
from nsparse_tpu.ops.kernels.piecewise import build_bank as j_build_bank
from nsparse_tpu.ops.kernels.piecewise import piecewise_expand as j_expand
from nsparse_tpu.ops.kernels.window_fused import fused_class_apply as j_fused
from nsparse_tpu.ops.spgemm import spgemm_numeric as j_numeric
from nsparse_tpu.ops.spgemm import spgemm_plan as j_plan
from nsparse_tpu.ops.spgemm_window import apv_values as j_apv_values

import nsparse_tpu_torch as nt
import nsparse_tpu_torch.ops.spgemm_window as twin
import nsparse_tpu_torch.tune.kernelgen as tkg
from nsparse_tpu_torch.ops.kernels import piecewise, window_fused
from test_torch_spgemm import CASES, _check_values, _pair

V2_CASES = CASES + ["rmat8"]
FOLD_RTOL = {np.float32: 1e-6, np.float64: 1e-12}


@pytest.fixture(scope="module")
def router():
    """The JAX package's native Benes router, which its v2 plans need.

    It is built on first use into one file in its source directory under
    a thread lock only, so test processes that build it at once can load
    a half-written file, and the failed load then sticks for the process.
    Build it under a file lock, and after a failed load wait and retry
    once."""
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
        pytest.fail("the JAX package's native Benes router "
                    "(nsparse_tpu/native) neither built nor loaded twice; "
                    "its v2 plans (NSPARSE_PLAN_TARGET=tpu) need it")
    return lib


def _pair_of(case, dtype):
    if case == "rmat8":
        return (jrmat(8, edge_factor=8, dtype=dtype, seed=2),
                nt.rmat_csr(8, edge_factor=8, dtype=dtype, seed=2))
    return _pair(case, dtype)


@pytest.fixture(scope="module")
def v2_plans(router):
    """Per case, cached: (JAX CSR, port CSR, JAX v2 plan, its extras,
    port v2 plan, port v1 plan), in float64."""
    cache = {}

    def get(case):
        if case not in cache:
            with pytest.MonkeyPatch.context() as mp:
                mp.setenv("NSPARSE_PLAN_TARGET", "tpu")
                if case == "fallback":
                    mp.setattr(jwin, "N_WIN_CLASSES", 2)
                    mp.setattr(tkg, "N_WIN_CLASSES", 2)
                ja, ta = _pair_of(case, np.float64)
                extras = {}
                jp = j_plan(ja, ja, shuffle=True, layout="window",
                            extras_out=extras)
                tp = nt.spgemm_plan(ta, ta, shuffle=True, layout="window")
                mp.setattr(twin, "FUSED_BANK_BUDGET", 0)
                tp1 = nt.spgemm_plan(ta, ta, shuffle=True, layout="window")
            cache[case] = (ja, ta, jp, extras, tp, tp1)
        return cache[case]

    return get


def _np(x):
    return np.asarray(x)


@pytest.mark.parametrize("case", V2_CASES)
def test_v2_plan_matches_jax(case, v2_plans):
    """The v2 tables, array for array: the form, the bank, each class's
    piece tables and A-value slice, and the fallback pool's piece plan."""
    ja, ta, jp, extras, tp, _ = v2_plans(case)
    jw, tw = jp.win, tp.win
    assert jw.fused_expand and tw.fused_expand
    assert jw.bank_rows == tw.bank_rows
    assert tuple(jw.class_geom) == tw.class_geom
    assert (jw.fb_off, jw.fb_len, jw.n_compact) == (
        tw.fb_off, tw.fb_len, tw.n_compact)
    np.testing.assert_array_equal(extras["b8_idx"], tw.b8_idx.numpy())
    apv_idx = tw.apv_idx.numpy().astype(np.int64)
    nnz_a = ta.nnz
    assert len(extras["eaidx_cls"]) == len(tw.fused)
    for jf, tf, jea in zip(jw.fused, tw.fused, extras["eaidx_cls"]):
        assert (jf.j2_cap, jf.apv_lo, jf.apv_hi, jf.blk) == (
            tf.j2_cap, tf.apv_lo, tf.apv_hi, tf.blk)
        et = _np(jf.etrips)
        np.testing.assert_array_equal(et[:, :2], tf.etrips.numpy())
        assert not et[:, 2:].any()  # SMEM padding columns
        for name in ("ecuts", "eboffs", "eends"):
            np.testing.assert_array_equal(
                _np(getattr(jf, name)).reshape(-1),
                getattr(tf, name).numpy(), err_msg=name)
        sl = apv_idx[tf.apv_lo : tf.apv_hi]
        np.testing.assert_array_equal(jea, np.where(sl < 0, nnz_a, sl))
    assert (jp.pw is None) == (tw.pw is None)
    if tw.pw is None:
        return
    jpw, tpw = jp.pw, tw.pw
    assert jpw.aligned and jpw.bank_rows == tpw.bank_rows
    assert (jpw.n, jpw.n_pad, jpw.nnz_a, jpw.nnz_b) == (
        tpw.n, tpw.n_pad, tpw.nnz_a, tpw.nnz_b)
    assert tuple(jpw.apv_splits) == tpw.apv_splits
    for name in ("ids", "cuts", "boffs"):
        for j, t in zip(getattr(jpw, name), getattr(tpw, name)):
            np.testing.assert_array_equal(_np(j), t.numpy(), err_msg=name)
    pa = tpw.apv_idx.numpy().astype(np.int64)
    for ja_, (lo, hi) in zip(jpw.aidx, tpw.apv_splits):
        np.testing.assert_array_equal(
            _np(ja_), np.where(pa[lo:hi] < 0, nnz_a, pa[lo:hi]))
    np.testing.assert_array_equal(_np(jpw.arena_src), tpw.arena_src.numpy())
    # 8-aligned runs start at most 128 pieces in a subtile, within the
    # largest budget: the JAX plan routes no subtile element-wise, and the
    # port's plan has no such route
    for name in ("fb_ids", "fb_bidx", "fb_aidx"):
        assert not _np(getattr(jpw, name)).size, name


def _vals(n, dtype, seed):
    return np.random.default_rng(seed).standard_normal(n).astype(dtype)


@pytest.mark.parametrize("case", V2_CASES)
def test_apv_values_match_jax(case, v2_plans):
    ja, ta, jp, _, tp, _ = v2_plans(case)
    a = _vals(ta.nnz, np.float32, 3)
    want = _np(j_apv_values(jp.win, jnp.asarray(a)))
    got = twin.apv_values(tp.win, torch.from_numpy(a)).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_piece_expansion_matches_jax(dtype, v2_plans):
    """The fallback pool's piece route (K1, K2 piece mode, K12) equals
    the JAX piecewise_expand on its aligned plan, slot for slot."""
    ja, ta, jp, _, tp, _ = v2_plans("fallback")
    tw = tp.win
    assert tw.pw is not None and len({int(i.numel()) for i in tw.pw.ids}) > 1
    a = _vals(ta.nnz, dtype, 4)
    b = _vals(ta.nnz, dtype, 5)
    want = _np(j_expand(jp.pw, jnp.asarray(a), jnp.asarray(b)))
    bank = piecewise.build_bank(tw.b8_idx, tw.bank_rows, torch.from_numpy(b))
    got = piecewise.piecewise_expand(tw.pw, torch.from_numpy(a),
                                     torch.from_numpy(b), bank=bank)
    np.testing.assert_array_equal(got.numpy(), want)


def test_fused_class_v2_matches_jax_interpret(v2_plans):
    """K3 v2 against the JAX fused kernel run in interpret mode, on every
    class of R-MAT-8, from the same bank and A values."""
    ja, ta, jp, _, tp, _ = v2_plans("rmat8")
    a = _vals(ta.nnz, np.float32, 6)
    jbank = j_build_bank(jp.win.b8_gp, jp.win.bank_rows, jnp.asarray(a))
    japv = j_apv_values(jp.win, jnp.asarray(a))
    tbank = piecewise.build_bank(tp.win.b8_idx, tp.win.bank_rows,
                                 torch.from_numpy(a))
    np.testing.assert_array_equal(tbank.numpy(), _np(jbank))
    tapv = twin.apv_values(tp.win, torch.from_numpy(a))
    assert any(f.tier_vs for f in tp.win.fused)  # tiers exercised
    for jf, tf in zip(jp.win.fused, tp.win.fused):
        want = _np(j_fused(jf, bank=jbank, apv=japv[jf.apv_lo : jf.apv_hi]))
        got = window_fused.fused_class_apply(
            tf, bank=tbank, apv=tapv[tf.apv_lo : tf.apv_hi]).numpy()
        np.testing.assert_allclose(got, want, rtol=FOLD_RTOL[np.float32],
                                   atol=0)


@pytest.mark.parametrize("case", V2_CASES)
def test_v2_equals_v1(case, v2_plans):
    """Products are formed once and folded in v1's order: every class
    arena and C equal the v1 form's, in float32 and float64."""
    _, ta, _, _, tp, tp1 = v2_plans(case)
    w2, w1 = tp.win, tp1.win
    assert w2.fused_expand and not w1.fused_expand
    for dtype in (torch.float32, torch.float64):
        a = ta.with_values(ta.val.to(dtype))
        bank, apv = twin.v2_delivery(w2, a.val, a.val)
        prod = piecewise.piecewise_expand(w1.expand, a.val, a.val)
        for f2, f1, (base, slots, _, _) in zip(w2.fused, w1.fused,
                                               w1.class_geom):
            assert torch.equal(
                window_fused.fused_class_apply(
                    f2, bank=bank, apv=apv[f2.apv_lo : f2.apv_hi]),
                window_fused.fused_class_apply(f1, prod[base : base + slots]))
        assert torch.equal(nt.spgemm_numeric(tp, a, a).val,
                           nt.spgemm_numeric(tp1, a, a).val)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("case", ["rmat9", "fallback", "rmat8"])
def test_v2_slice_matches_jax(case, dtype, v2_plans, monkeypatch):
    """The whole slice: the port's v2 plan and numeric phase against the
    JAX package's C and scipy, then a value re-run on the same plans."""
    if case == "fallback":
        monkeypatch.setattr(jwin, "N_WIN_CLASSES", 2)
        monkeypatch.setattr(tkg, "N_WIN_CLASSES", 2)
    ja, ta = _pair_of(case, dtype)
    tp = nt.spgemm_plan(ta, ta, shuffle=True, layout="window")
    assert tp.win.fused_expand
    jp = j_plan(ja, ja, shuffle=True, layout="window")
    _check_values(ja, j_numeric(jp, ja, ja), ta, nt.spgemm_numeric(tp, ta, ta),
                  dtype)
    v2 = np.random.default_rng(5).standard_normal(ta.nnz).astype(dtype)
    ja2 = dataclasses.replace(ja, val=jnp.asarray(v2))
    ta2 = ta.with_values(torch.from_numpy(v2))
    _check_values(ja2, j_numeric(jp, ja2, ja2), ta2,
                  nt.spgemm_numeric(tp, ta2, ta2), dtype)


def test_budget_rule(monkeypatch):
    """v2 exactly when the f32 bank (rows x 16 copies x 512 bytes) fits
    FUSED_BANK_BUDGET; at a budget of 0, v1."""
    a = nt.rmat_csr(8, edge_factor=8, dtype=np.float64, seed=2)
    w = nt.spgemm_plan(a, a, shuffle=True, layout="window").win
    assert w.fused_expand and w.expand is None and w.b8_idx.numel()
    need = w.bank_rows * 16 * 512
    for budget, v2 in ((need, True), (need - 1, False), (0, False)):
        monkeypatch.setattr(twin, "FUSED_BANK_BUDGET", budget)
        w = nt.spgemm_plan(a, a, shuffle=True, layout="window").win
        assert w.fused_expand == v2
        assert (w.expand is None) == v2 and (w.fb_off == 0 or not v2)
        assert all(f.expand == v2 for f in w.fused)

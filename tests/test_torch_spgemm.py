"""The port's SpGEMM main path (nsparse_tpu_torch) against the JAX package.

The same matrices, made from a seed with numpy, go through the JAX
package's window plan and numeric phase (eager, index form — the form it
builds off the TPU) and through the port on the CPU, where every kernel
wrapper runs its plain PyTorch version.  Plans must match array for array;
values must match the JAX result at the bounds of
``tests/test_spgemm_window.py`` and pass the scipy check.
"""

import dataclasses

import numpy as np
import pytest
import scipy.sparse as sp

import jax.numpy as jnp
import torch

import nsparse_tpu.ops.spgemm_window as jwin
from nsparse_tpu.formats.csr import CSR as JCSR
from nsparse_tpu.io.generate import rmat_csr as jrmat
from nsparse_tpu.io.generate import stencil_csr as jstencil
from nsparse_tpu.ops.spgemm import spgemm_numeric as j_numeric
from nsparse_tpu.ops.spgemm import spgemm_plan as j_plan

import nsparse_tpu_torch as nt
import nsparse_tpu_torch.ops.spgemm_window as twin
import nsparse_tpu_torch.tune.kernelgen as tkg
from nsparse_tpu_torch.ops.kernels.window_fused import level_widths
from nsparse_tpu_torch.ops.spgemm import plan_from_numpy


def _dense_block():
    rng = np.random.default_rng(7)
    m, d = 256, 80
    bg = sp.random(m, m, density=0.01, random_state=3, format="lil")
    bg[:d, :d] = rng.standard_normal((d, d))
    return sp.csr_matrix(bg)


def _fallback_heavy():
    rng = np.random.default_rng(11)
    m = 256
    rows, cols, vals = [], [], []
    for r in range(m):
        cc = rng.choice(m, size=4, replace=False)
        rows += [r] * 4
        cols += list(cc)
        vals += list(rng.standard_normal(4))
    for r in (3, 100):
        rows += [r] * m
        cols += list(range(m))
        vals += list(rng.standard_normal(m))
    s = sp.csr_matrix((np.asarray(vals), (np.asarray(rows), np.asarray(cols))),
                      shape=(m, m))
    s.sum_duplicates()
    return s


def _pair(case, dtype):
    """(JAX CSR, port CSR) of one test matrix."""
    if case == "rmat9":
        return (jrmat(9, edge_factor=8, dtype=dtype, seed=4),
                nt.rmat_csr(9, edge_factor=8, dtype=dtype, seed=4))
    if case == "stencil28":
        return jstencil(28, 28, dtype=dtype), nt.stencil_csr(28, 28, dtype=dtype)
    s = (_dense_block() if case == "dense80" else _fallback_heavy()).astype(dtype)
    return JCSR.from_scipy(s), nt.CSR.from_scipy(s)


CASES = ["rmat9", "stencil28", "dense80", "fallback"]


@pytest.fixture
def window_classes(monkeypatch, request):
    """The port's v1 form, which the JAX index-form plan takes off the
    accelerator (tests/test_torch_window_v2.py holds v2); the
    fallback-heavy case caps the window ladder at 1024 slots on both
    sides, as tests/test_spgemm_window.py does."""
    monkeypatch.setattr(twin, "FUSED_BANK_BUDGET", 0)
    if request.node.callspec.params.get("case") == "fallback":
        monkeypatch.setattr(jwin, "N_WIN_CLASSES", 2)
        monkeypatch.setattr(tkg, "N_WIN_CLASSES", 2)


def _plans(case, dtype):
    ja, ta = _pair(case, dtype)
    extras = {}
    jp = j_plan(ja, ja, shuffle=True, layout="window", extras_out=extras)
    tp = nt.spgemm_plan(ta, ta, shuffle=True, layout="window")
    return ja, ta, jp, tp, extras


def _jax_arrays(jp):
    """The JAX window plan's index-form arrays as numpy (plan_from_numpy's
    input)."""
    w = jp.win
    fb = w.fb_shuffle is not None
    return dict(
        shape=jp.shape, c_rpt=np.asarray(jp.c_rpt), c_col=np.asarray(jp.c_col),
        c_nnz=jp.c_nnz, n_products=jp.n_products, class_geom=w.class_geom,
        tier_vs=[[V for _, V, _ in fp.tier_meta] for fp in w.fused],
        tile_idx=[np.asarray(bp.idx) for bp in w.benes],
        tier_idx=[[np.asarray(t) for t in fp.ref_tier_idx] for fp in w.fused],
        ext_idx=[np.asarray(fp.ref_ext_idx) for fp in w.fused],
        entry_idx=[np.asarray(fp.ref_entry_idx) for fp in w.fused],
        fb_shuffle=np.asarray(w.fb_shuffle.idx) if fb else None,
        fb_perm=np.asarray(w.fb_perm.idx) if fb else None,
        fb_levels=w.fb_levels,
        fb_lvl_idx=[np.asarray(i) for i in w.fb_lvl_idx],
        fb_off=w.fb_off, fb_len=w.fb_len, n_compact=w.n_compact,
    )


def _lift_ext(local, w, lv, tier_vs, slots):
    """Port window-local pyramid index -> the JAX level-major one."""
    n_win = slots // w
    lw = np.asarray(level_widths(w, lv, tier_vs), np.int64)
    lbase = np.concatenate([[0], np.cumsum(lw)[:-1]])
    vbase = np.concatenate([[0], np.cumsum(lw * n_win)[:-1]])
    out = np.full(local.size, -1, np.int64)
    live = local >= 0
    lvl = np.searchsorted(lbase, local[live], side="right") - 1
    win = np.flatnonzero(live) // w
    out[live] = vbase[lvl] + win * lw[lvl] + local[live] - lbase[lvl]
    return out


@pytest.mark.parametrize("case", CASES)
def test_window_plan_matches_jax(case, window_classes):
    """Every index array of the port's plan equals the JAX index-form plan
    (port indices lifted back from window-local to class-global)."""
    _, _, jp, tp, extras = _plans(case, np.float64)
    jw, tw = jp.win, tp.win
    assert (jp.n_products, jp.c_nnz) == (tp.n_products, tp.c_nnz)
    np.testing.assert_array_equal(np.asarray(jp.c_rpt), tp.c_rpt.numpy())
    np.testing.assert_array_equal(np.asarray(jp.c_col), tp.c_col.numpy())
    assert tuple(jw.class_geom) == tw.class_geom
    assert (jw.fb_off, jw.fb_len, jw.n_compact) == (
        tw.fb_off, tw.fb_len, tw.n_compact)
    for (_, slots, w, lv), jb, jf, tf in zip(jw.class_geom, jw.benes, jw.fused,
                                             tw.fused):
        tile = tf.tile_idx.numpy().astype(np.int64)
        np.testing.assert_array_equal(
            np.asarray(jb.idx), tile + np.arange(slots) // w * w
        )
        assert tf.tier_vs == tuple(V for _, V, _ in jf.tier_meta)
        off = 0
        for v, jt in zip(tf.tier_vs, jf.ref_tier_idx):
            loc = tf.tier_idx.numpy()[off : off + slots // w * v].astype(np.int64)
            off += loc.size
            lifted = loc + np.arange(loc.size) // v * v
            np.testing.assert_array_equal(np.asarray(jt), lifted)
        entry = tf.entry_idx.numpy().astype(np.int64)
        np.testing.assert_array_equal(
            np.asarray(jf.ref_entry_idx), entry + np.arange(slots) // w * w
        )
        np.testing.assert_array_equal(
            np.asarray(jf.ref_ext_idx),
            _lift_ext(tf.ext_idx.numpy().astype(np.int64), w, lv, tf.tier_vs,
                      slots),
        )
    assert (jw.fb_shuffle is None) == (tw.fb_shuffle is None)
    if tw.fb_shuffle is not None:
        assert case == "fallback"
        js = np.asarray(jw.fb_shuffle.idx)
        # past the fallback products the port zero-fills (-1)
        np.testing.assert_array_equal(
            np.where(js < tw.fb_len, js, -1), tw.fb_shuffle.idx.numpy()
        )
        np.testing.assert_array_equal(
            np.asarray(jw.fb_perm.idx), tw.fb_perm.idx.numpy()
        )
        assert tuple(jw.fb_levels) == tw.fb_levels
        for ji, ti in zip(jw.fb_lvl_idx, tw.fb_lvl_idx):
            np.testing.assert_array_equal(np.asarray(ji), ti.numpy())
    for key, t in (("mrg_src", tw.merge.src_off), ("mrg_dst", tw.merge.dst),
                   ("mrg_len", tw.merge.len)):
        np.testing.assert_array_equal(extras[key], t.numpy())
    assert tw.merge.n_src == extras["arena_len"] + extras["fb_seg"]


def _check_values(ja, jc, ta, tc, dtype):
    np.testing.assert_array_equal(np.asarray(jc.rpt), tc.rpt.numpy())
    np.testing.assert_array_equal(np.asarray(jc.col), tc.col.numpy())
    rtol = 1e-10 if dtype == np.float64 else 2e-5
    np.testing.assert_allclose(
        tc.val.numpy(), np.asarray(jc.val), rtol=rtol, atol=1e-12
    )
    assert nt.check_spgemm_answer(
        tc, nt.spgemm_oracle(ta, ta), verbose=True,
        abs_ref=nt.spgemm_abs_oracle(ta, ta),
    )


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("case", ["rmat9", "fallback"])
def test_slice_matches_jax(case, dtype, window_classes):
    """Plan + numeric, port vs JAX, then a value re-run on the same plans."""
    ja, ta, jp, tp, _ = _plans(case, dtype)
    _check_values(ja, j_numeric(jp, ja, ja), ta, nt.spgemm_numeric(tp, ta, ta),
                  dtype)
    v2 = np.random.default_rng(5).standard_normal(ta.nnz).astype(dtype)
    ja2 = dataclasses.replace(ja, val=jnp.asarray(v2))
    ta2 = ta.with_values(torch.from_numpy(v2))
    _check_values(ja2, j_numeric(jp, ja2, ja2), ta2,
                  nt.spgemm_numeric(tp, ta2, ta2), dtype)


@pytest.mark.parametrize("case", CASES)
def test_numeric_on_converted_jax_plan(case, window_classes):
    """The port's numeric phase on the JAX package's own plan, converted by
    plan_from_numpy.  The JAX plan does not expose the expansion runs, so
    the converter takes them from the port's planner.  The port's own plan
    is held against the JAX numeric phase above, so the converted plan
    must give its values exactly."""
    _, ta, jp, tp, extras = _plans(case, np.float64)
    conv = plan_from_numpy(_jax_arrays(jp), extras, tp.win.expand)
    c = nt.spgemm_numeric(conv, ta, ta)
    assert torch.equal(c.val, nt.spgemm_numeric(tp, ta, ta).val)
    assert nt.check_spgemm_answer(c, nt.spgemm_oracle(ta, ta), verbose=True)


def test_spgemm_entry_and_segsum_oracle():
    a = nt.rmat_csr(8, edge_factor=6, dtype=np.float64, seed=9)
    c = nt.spgemm(a, a)
    ref = nt.spgemm_numeric_segsum(nt.spgemm_plan(a, a), a, a)
    assert c.nnz == ref.nnz
    np.testing.assert_array_equal(c.col.numpy(), ref.col.numpy())
    np.testing.assert_allclose(c.val.numpy(), ref.val.numpy(),
                               rtol=1e-12, atol=1e-12)
    assert nt.spgemm_flops(a, a) == 2 * nt.spgemm_plan(a, a).n_products


def test_numeric_rejects_mismatched_inputs():
    a = nt.rmat_csr(7, edge_factor=4, dtype=np.float64, seed=1)
    plan = nt.spgemm_plan(a, a)
    with pytest.raises(TypeError):
        nt.spgemm_numeric(plan, a.with_values(a.val.float()), a)
    other = nt.rmat_csr(7, edge_factor=4, dtype=np.float64, seed=2)
    with pytest.raises(ValueError):
        nt.spgemm_numeric(plan, other, other)


def test_cli_spgemm_host_planner(capsys):
    from nsparse_tpu_torch.cli import main

    rc = main(["--precision", "double", "spgemm", "gen:rmat:8:4",
               "--planner", "host", "--device", "cpu"])
    out = capsys.readouterr().out
    assert rc == 0, out
    assert "intermediate products" in out and out.rstrip().endswith("pass")
    assert "layout: sort (host plan" in out

"""The port's block-sparse SpGEMM (K9 ``spgemm_bsr_blocks``,
``plan_spgemm_bsr``, ``spgemm_bsr``, ``choose_spgemm_path``) against the
JAX package.

The same numpy-seeded matrices go through both packages: plans must be
equal array for array, C's values within the stated tolerances of the
JAX results (its Pallas kernel in interpret mode, as
``tests/test_spgemm_bsr.py`` runs it) and of scipy.  On the CPU the
port's K9 wrapper runs its plain version (a batched product and a sum per
C tile); ``chip_smoke.py`` holds the CUDA kernel against it on the card.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from nsparse_tpu.formats.csr import CSR as JCSR
from nsparse_tpu.ops import spgemm_bsr as jbsr
from nsparse_tpu.ops.spgemm import spgemm as j_spgemm

import nsparse_tpu_torch as nt
from nsparse_tpu_torch.ops import spgemm_bsr as tbsr
from nsparse_tpu_torch.ops.kernels import bsr_blocks


def _positive(s):
    """Positive values: tile densification must not create cancellation
    zeros that scipy's oracle would drop from the exact structure."""
    s = sp.csr_matrix(s)
    s.data = np.abs(s.data) + 0.1
    return s


def _fem(n, dof, nb, bw, seed, dtype=np.float64):
    return nt.fem_block_csr(n, dof=dof, neighbors=nb, bandwidth=bw,
                            dtype=dtype, seed=seed).to_scipy()


def _rect():
    a = sp.random(200, 150, 0.05, random_state=1, format="csr") \
        + sp.eye(200, 150) * 0.5
    b = sp.random(150, 100, 0.05, random_state=2, format="csr") \
        + sp.eye(150, 100) * 0.5
    return a, b


# name: (A, B, bs) as scipy matrices
CASES = {
    "stencil16": lambda: (2 * (_positive(nt.stencil_csr(16, 16).to_scipy()),)
                          + (None,)),
    "fem24": lambda: (2 * (_positive(_fem(24, 8, 3, 6, 1)),) + (None,)),
    "rect200x150x100": lambda: (*_rect(), None),
    "fem64-bs128": lambda: (2 * (_positive(_fem(64, 16, 4, 8, 2)),) + (128,)),
}


def _pair(case, dtype=np.float64):
    """((JAX A, JAX B), (port A, port B), bs) of a case in ``dtype``."""
    a, b, bs = CASES[case]()
    mats = [m.astype(dtype) for m in (a, b)]
    return ([JCSR.from_scipy(m) for m in mats],
            [nt.CSR.from_scipy(m) for m in mats], bs)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _same_gather_plan(j, t):
    np.testing.assert_array_equal(np.asarray(j.idx2d), t.idx2d.numpy())
    for field in ("ids", "bases"):
        jf, tf = getattr(j, field), getattr(t, field)
        assert len(jf) == len(tf)
        for x, y in zip(jf, tf):
            np.testing.assert_array_equal(np.asarray(x), y.numpy())
    np.testing.assert_array_equal(np.asarray(j.fb_ids), t.fb_ids.numpy())
    assert j.classes == t.classes and j.n == t.n


def _same_plan(jp, tp):
    for f in ("a_blocks", "b_blocks", "pair_a", "pair_b", "pair_c",
              "c_block_row", "c_block_col", "c_rpt", "c_col", "c_slot",
              "a_fill_mask", "b_fill_mask"):
        jx, tx = np.asarray(getattr(jp, f)), _np(getattr(tp, f))
        assert jx.dtype == tx.dtype, f
        np.testing.assert_array_equal(jx, tx, err_msg=f)
    _same_gather_plan(jp.a_fill_gp, tp.a_fill_gp)
    _same_gather_plan(jp.b_fill_gp, tp.b_fill_gp)
    for f in ("shape", "n_block_rows", "bs", "fill", "flops", "c_nnz",
              "n_pairs", "n_c_blocks"):
        assert getattr(jp, f) == getattr(tp, f), f
    # the derived run starts of each C tile
    pc = np.asarray(jp.pair_c)
    np.testing.assert_array_equal(
        tp.c_pair_start.numpy(),
        np.searchsorted(pc, np.arange(jp.n_c_blocks + 1)))


@pytest.mark.parametrize("case", sorted(CASES))
def test_plan_matches_jax(case):
    (ja, jb), (ta, tb), bs = _pair(case)
    _same_plan(jbsr.plan_spgemm_bsr(ja, jb, bs), tbsr.plan_spgemm_bsr(
        ta, tb, bs))


def test_block_pairs_enumerate_every_product():
    """Each (A tile (i, k), B tile (k, j)) pair appears once, in (i, j,
    a_id, b_id) order, with no padding: the JAX plans equal the port's at
    its pairs per step of 1, and no pair names the trailing zero tile."""
    assert jbsr.PAIRS_PER_STEP == tbsr.kernelgen.BSR_PAIRS_PER_STEP == 1
    ga = sp.random(9, 7, 0.3, random_state=8, format="csr")
    gb = sp.random(7, 11, 0.3, random_state=9, format="csr")
    ga.sort_indices()
    gb.sort_indices()
    a_brow, a_bcol = np.repeat(np.arange(9), np.diff(ga.indptr)), ga.indices
    b_brow, b_bcol = np.repeat(np.arange(7), np.diff(gb.indptr)), gb.indices
    pa, pb, pc, start, crow, ccol = tbsr._block_pairs(
        a_brow, a_bcol, b_brow, b_bcol, 7, 11)
    want = sorted((a_brow[x], b_bcol[y], x, y)
                  for x in range(a_bcol.size) for y in range(b_bcol.size)
                  if a_bcol[x] == b_brow[y])
    got = [(crow[c], ccol[c], x, y) for x, y, c in zip(pa, pb, pc)]
    assert got == want
    np.testing.assert_array_equal(start, np.searchsorted(pc, np.arange(
        crow.size + 1)))
    (_, _), (ta, tb), bs = _pair("fem64-bs128")
    tp = tbsr.plan_spgemm_bsr(ta, tb, bs)
    assert int(tp.pair_a.max()) < len(tp.a_blocks) - 1
    assert int(tp.pair_b.max()) < len(tp.b_blocks) - 1


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_values_match_jax_and_scipy(case, dtype):
    """f64: C equal to JAX's within 1e-12; f32: within 1e-6 of |A||B|
    (both sum the same tile products, in other orders); both pass the
    scipy check."""
    (ja, jb), (ta, tb), bs = _pair(case, dtype)
    jc = jbsr.spgemm_bsr(ja, jb, jbsr.plan_spgemm_bsr(ja, jb, bs))
    tc = tbsr.spgemm_bsr(ta, tb, tbsr.plan_spgemm_bsr(ta, tb, bs))
    np.testing.assert_array_equal(np.asarray(jc.rpt), tc.rpt.numpy())
    np.testing.assert_array_equal(np.asarray(jc.col), tc.col.numpy())
    want = np.asarray(jc.val, np.float64)
    got = tc.val.numpy().astype(np.float64)
    if dtype == np.float64:
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=0)
    else:
        scale = nt.spgemm_abs_oracle(ta, tb).data
        assert (np.abs(got - want) <= 1e-6 * scale).all()
    assert nt.check_spgemm_answer(tc, nt.spgemm_oracle(ta, tb),
                                  abs_ref=nt.spgemm_abs_oracle(ta, tb),
                                  verbose=True)


@pytest.mark.parametrize("case", ["fem24", "fem64-bs128"])
def test_value_rerun_equals_fresh_plan(case):
    """New values through ``spgemm_bsr_numeric`` (planned re-blockify)
    give the tiles of a fresh plan on those values, and JAX's re-run."""
    (ja, _), (ta, _), bs = _pair(case)
    plan = tbsr.plan_spgemm_bsr(ta, ta, bs)
    v2 = np.abs(np.random.default_rng(5).standard_normal(ta.nnz)) + 0.1
    t2 = ta.with_values(torch.from_numpy(v2))
    got = tbsr.spgemm_bsr_numeric(plan, t2, t2)
    fresh = tbsr.tile_products(tbsr.plan_spgemm_bsr(t2, t2, bs))
    torch.testing.assert_close(got, fresh, rtol=1e-12, atol=0)
    j2 = JCSR.from_scipy(t2.to_scipy())
    want = np.asarray(jbsr.spgemm_bsr_numeric(
        jbsr.plan_spgemm_bsr(ja, ja, bs), j2, j2))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=1e-14)


def test_int32_tables_refuse_to_wrap():
    """Where the JAX planner casts to int32 silently, the port raises."""
    assert tbsr._int32(np.array([(1 << 31) - 1]), "x").dtype == np.int32
    with pytest.raises(ValueError, match="2\\*\\*31"):
        tbsr._int32(np.array([3, 1 << 31]), "a C tile slot")


def test_value_rerun_rejects_other_matrices():
    (_, _), (ta, _), bs = _pair("fem24")
    plan = tbsr.plan_spgemm_bsr(ta, ta, bs)
    other = nt.stencil_csr(16, 16)
    with pytest.raises(ValueError, match="plan built for nnz"):
        tbsr.spgemm_bsr_numeric(plan, other, other)


PATH_MATRICES = {
    "fem64": lambda: _fem(64, 16, 4, 8, 2, np.float32),
    "rmat10": lambda: nt.rmat_csr(10, 8, dtype=np.float32, seed=3).to_scipy(),
    "stencil64": lambda: nt.stencil_csr(64, 64).to_scipy(),
    "random500": lambda: nt.random_csr(500, 500, density=0.02,
                                       seed=4).to_scipy(),
}


@pytest.mark.parametrize("name", sorted(PATH_MATRICES))
def test_choose_path_and_block_stats_match_jax(name):
    s = PATH_MATRICES[name]()
    ja, ta = JCSR.from_scipy(s), nt.CSR.from_scipy(s)
    assert jbsr.block_stats(ja, ja) == tbsr.block_stats(ta, ta)
    assert jbsr.choose_spgemm_path(ja, ja) == tbsr.choose_spgemm_path(ta, ta)
    want = {"fem64": "bsr", "rmat10": "esc"}.get(name)
    assert want is None or tbsr.choose_spgemm_path(ta, ta) == want


def test_large_product_count_stays_int64():
    """The chip_smoke FEM matrix: P = 2,395,136,000 products exceed int32.
    The port counts them in int64 and chooses the block path, as JAX does
    under x64."""
    a = nt.fem_block_csr(4096, dof=16, neighbors=6, bandwidth=24,
                         dtype=np.float32, seed=3)
    assert (a.shape[0], a.nnz) == (65536, 12_327_424)
    assert nt.spgemm_flops(a, a) == 4_790_272_000
    pairs, a_fill, _ = tbsr.block_stats(a, a)
    assert pairs == 6350 and a_fill < 64
    assert tbsr.choose_spgemm_path(a, a) == "bsr"


def test_spgemm_dispatch_matches_jax():
    """``method="auto"`` takes JAX's path (and its result), and a plan
    passed with ``method="bsr"`` raises, as in JAX."""
    for s in (_positive(_fem(24, 8, 3, 6, 1)),
              nt.rmat_csr(8, 4, seed=2).to_scipy()):
        ja, ta = JCSR.from_scipy(s), nt.CSR.from_scipy(s)
        path = jbsr.choose_spgemm_path(ja, ja)
        got = nt.spgemm(ta, ta, method="auto")
        want = j_spgemm(ja, ja, method="auto")
        assert got.nnz == want.nnz
        np.testing.assert_array_equal(got.col[: got.nnz].numpy(),
                                      np.asarray(want.col)[: want.nnz])
        np.testing.assert_allclose(got.val[: got.nnz].numpy(),
                                   np.asarray(want.val)[: want.nnz],
                                   rtol=1e-12, atol=1e-12)
        # the block path's C has no padded capacity, the window path's has
        assert (got.col.numel() == got.nnz) == (path == "bsr")
    plan = nt.spgemm_plan(ta, ta)
    with pytest.raises(ValueError, match="method='bsr'"):
        nt.spgemm(ta, ta, plan, method="bsr")
    with pytest.raises(ValueError, match="unknown method"):
        nt.spgemm(ta, ta, method="dense")


def test_plain_tile_products_keep_full_precision():
    """A caller's reduced float32 matmul setting does not reach the plain
    K9 (JAX runs it at Precision.HIGHEST), and is left as it was."""
    rng = np.random.default_rng(6)
    a = torch.from_numpy(rng.standard_normal((3, 64, 64)).astype(np.float32))
    pa = torch.tensor([0, 1, 2, 2], dtype=torch.int32)
    pc = torch.tensor([0, 0, 1, 1], dtype=torch.int32)
    start = torch.tensor([0, 2, 4], dtype=torch.int32)
    saved = torch.get_float32_matmul_precision()
    try:
        torch.set_float32_matmul_precision("medium")
        got = bsr_blocks.spgemm_bsr_blocks(a, a, pa, pa, pc, start).numpy()
        assert torch.get_float32_matmul_precision() == "medium"
    finally:
        torch.set_float32_matmul_precision(saved)
    a64 = a.double().numpy()
    want = np.stack([a64[0] @ a64[0] + a64[1] @ a64[1], 2 * a64[2] @ a64[2]])
    scale = np.stack([np.abs(a64[0]) @ np.abs(a64[0])
                      + np.abs(a64[1]) @ np.abs(a64[1]),
                      2 * np.abs(a64[2]) @ np.abs(a64[2])])
    assert (np.abs(got - want) <= 1e-6 * scale).all()


def test_precision_guard_survives_the_legacy_tf32_flag():
    """Turning the legacy TF32 flag on and off around the plain products
    (as a caller of the older API does) neither raises nor leaves the
    flag changed."""
    a = torch.ones(1, 64, 64)
    p = torch.zeros(1, dtype=torch.int32)
    start = torch.tensor([0, 1], dtype=torch.int32)
    flags = torch.backends.cuda.matmul
    saved = torch.get_float32_matmul_precision()
    try:
        for on in (True, False, True, False):
            flags.allow_tf32 = on
            c = bsr_blocks.spgemm_bsr_blocks(a, a, p, p, p, start)
            assert flags.allow_tf32 is on and float(c[0, 0, 0]) == 64.0
    finally:
        torch.set_float32_matmul_precision(saved)


def _tf32(x):
    """TF32 rounding as ``cvt.rna.tf32.f32`` does it: to nearest, ties
    away from zero, to 10 mantissa bits (float32's low 13 bits zeroed)."""
    bits = np.asarray(x, np.float32).view(np.uint32).astype(np.uint64)
    return ((bits + 0x1000) & 0xFFFFE000).astype(np.uint32).view(np.float32)


def test_tf32_rounding_model():
    """Ties (half a TF32 ulp, 2^-11 at 1) go away from zero, in both
    signs; other values to the nearest TF32 value."""
    x = np.array([1 + 2**-11, -(1 + 2**-11), 1 + 2**-12, 1 + 3 * 2**-12,
                  3 * 2**-20], np.float32)
    np.testing.assert_array_equal(
        _tf32(x), [1 + 2**-10, -(1 + 2**-10), 1, 1 + 2**-10, 3 * 2**-20])


@pytest.mark.parametrize("bs", [64, 256])
def test_three_tf32_products_keep_float32_accuracy(bs):
    """A numpy model of K9's float32 arithmetic on the card (3xTF32): each
    operand split x = hi + lo, hi = tf32(x), lo = tf32(x - hi), and the
    products lo*hi + hi*lo + hi*hi summed.  On FEM tiles it stays within
    1e-6 of |A_tile||B_tile| of the float64 products, where one TF32 pass
    (hi*hi alone) misses 1e-5: the reason K9 takes three passes, and its
    float32 bound is a third of the TF32 peak (the JAX kernel runs at
    Precision.HIGHEST)."""
    a = nt.fem_block_csr(64, dof=16, neighbors=4, bandwidth=8,
                         dtype=np.float32, seed=2)
    vals = np.random.default_rng(bs).standard_normal(a.nnz)
    a = a.with_values(torch.from_numpy(vals.astype(np.float32)))
    plan = tbsr.plan_spgemm_bsr(a, a, bs)
    ta, tb = plan.a_blocks.numpy(), plan.b_blocks.numpy()
    pa, pb, pc = (plan.pair_a.numpy(), plan.pair_b.numpy(),
                  plan.pair_c.numpy())

    def tiles(x, y):
        c = np.zeros((plan.n_c_blocks, bs, bs))
        np.add.at(c, pc, np.matmul(x[pa].astype(np.float64),
                                   y[pb].astype(np.float64)))
        return c

    exact, scale = tiles(ta, tb), tiles(np.abs(ta), np.abs(tb))
    ah, bh = _tf32(ta), _tf32(tb)
    al, bl = _tf32(ta - ah), _tf32(tb - bh)
    three = (tiles(al, bh) + tiles(ah, bl) + tiles(ah, bh)).astype(np.float32)
    one = tiles(ah, bh).astype(np.float32)
    live = scale > 0
    err3 = np.abs(three - exact)[live] / scale[live]
    err1 = np.abs(one - exact)[live] / scale[live]
    assert err3.max() <= 1e-6
    assert err1.max() > 1e-5


def test_k9_wrapper_refuses_bad_inputs():
    """Mismatched tiles or pair arrays raise; off the CPU the wrapper
    launches the kernel or raises, never the plain version."""
    a = torch.zeros(2, 64, 64)
    p = torch.zeros(1, dtype=torch.int32)
    start = torch.tensor([0, 1], dtype=torch.int32)
    with pytest.raises(TypeError):
        bsr_blocks.spgemm_bsr_blocks(a, a.double(), p, p, p, start)
    with pytest.raises(ValueError, match="differ in length"):
        bsr_blocks.spgemm_bsr_blocks(a, a, p, p.repeat(2), p, start)
    m = torch.zeros(2, 96, 96, device="meta")
    with pytest.raises(ValueError, match="multiple of 64"):
        bsr_blocks.spgemm_bsr_blocks(m, m, p, p, p, start)
    with pytest.raises(ValueError, match="must be on"):
        bsr_blocks.spgemm_bsr_blocks(a.to("meta"), a.to("meta"), p, p, p,
                                     start)
    assert bsr_blocks.spgemm_bsr_blocks.launches == 0


def test_plan_moves_to_a_device():
    (_, _), (ta, _), bs = _pair("fem24")
    moved = tbsr.plan_spgemm_bsr(ta, ta, bs).to("meta")
    assert moved.a_blocks.device.type == moved.c_pair_start.device.type \
        == moved.a_fill_gp.idx2d.device.type == "meta"


def test_cli_spgemm_auto_takes_the_block_path(capsys):
    from nsparse_tpu_torch.cli import main

    rc = main(["spgemm", "gen:fem:24:8", "--method", "auto", "--device",
               "cpu", "--trials", "1"])
    out = capsys.readouterr().out
    assert rc == 0, out
    assert "method: bsr (auto)" in out and "block pairs: 1" in out
    assert out.rstrip().endswith("pass")

"""The port's kernel modules against their JAX counterparts.

For each module that holds a kernel, the same numpy inputs go through the
JAX function (eager, in the index/reference form it takes off the TPU) and
through the port's wrapper on CPU tensors, which runs the kernel's plain
PyTorch version.  Data movement and expansion must match exactly; folds
at rtol 1e-12 (f64) and 1e-6 (f32) — no difference is expected, the bound
only leaves room for XLA CPU fusion.  The CUDA kernels themselves are held
against the same plain versions on the card by ``chip_smoke.py``.
"""

import types

import numpy as np
import pytest

import jax.numpy as jnp
import torch

import nsparse_tpu.ops.spgemm_window as jwin
from nsparse_tpu.formats.csr import CSR as JCSR
from nsparse_tpu.io.generate import rmat_csr as jrmat
from nsparse_tpu.ops.kernels import shuffle_pallas as jsh
from nsparse_tpu.ops.kernels.flat_gather import build_flat_gather_plan
from nsparse_tpu.ops.kernels.gather_pallas import gather_tiles8 as j_tiles8
from nsparse_tpu.ops.kernels.piecewise import build_bank as j_build_bank
from nsparse_tpu.ops.kernels.piecewise import piecewise_expand as j_expand
from nsparse_tpu.ops.kernels.runcopy import build_runcopy_plan as j_rc_plan
from nsparse_tpu.ops.kernels.runcopy import runcopy as j_runcopy
from nsparse_tpu.ops.kernels.window_fused import (
    _fused_reference as j_fused_ref,
)
from nsparse_tpu.ops.kernels.window_fused import fused_class_apply as j_fused
from nsparse_tpu.ops.spgemm import slab_class_reduce as j_slab_reduce
from nsparse_tpu.ops.spgemm import spgemm_plan as j_plan

import nsparse_tpu_torch as nt
import nsparse_tpu_torch.ops.spgemm_window as twin
import nsparse_tpu_torch.tune.kernelgen as tkg
from nsparse_tpu_torch.ops.kernels import (
    gather_tiles,
    piecewise,
    runcopy,
    shuffle,
    window_fused,
)
from nsparse_tpu_torch.ops.spgemm import slab_class_reduce
from test_torch_spgemm import _lift_ext

DTYPES = [np.float32, np.float64]
FOLD_RTOL = {np.float32: 1e-6, np.float64: 1e-12}


@pytest.fixture(scope="module")
def plans():
    """JAX and port window plans of R-MAT-8 (deep tiers, several classes),
    the port's in the v1 form that the JAX index-form plan takes."""
    ja = jrmat(8, edge_factor=8, dtype=np.float64, seed=2)
    ta = nt.rmat_csr(8, edge_factor=8, dtype=np.float64, seed=2)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(twin, "FUSED_BANK_BUDGET", 0)
        tp = nt.spgemm_plan(ta, ta, shuffle=True, layout="window")
    return ja, ta, j_plan(ja, ja, shuffle=True, layout="window"), tp


def _vals(n, dtype, seed):
    return np.random.default_rng(seed).standard_normal(n).astype(dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_gather_planned_shuffle(dtype):
    src = np.random.default_rng(0).permutation(5000).astype(np.int32)
    x = _vals(5000, dtype, 1)
    want = np.asarray(jsh.planned_shuffle(jsh.build_shuffle_plan(src),
                                          jnp.asarray(x)))
    got = shuffle.planned_shuffle(shuffle.build_shuffle_plan(src),
                                  torch.from_numpy(x))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("dtype", DTYPES)
def test_gather_tile_permutation(dtype):
    """The per-tile permutation, which K3 reads its products through: a
    fused class with no folds, no tiers and identity extraction and entry
    tables moves each tile exactly as the JAX tile_benes_apply does."""
    rng = np.random.default_rng(2)
    w = 256
    perms = np.concatenate([rng.permutation(w) for _ in range(8)])
    x = _vals(8 * w, dtype, 3)
    want = np.asarray(jsh.tile_benes_apply(jsh.build_tile_benes(perms, w),
                                           jnp.asarray(x)))
    ident = np.tile(np.arange(w), 8)
    plan = window_fused.build_fused_plan(w, 8 * w, 0, (), perms, [], ident,
                                         ident)
    got = window_fused.fused_class_apply(plan, torch.from_numpy(x))
    np.testing.assert_array_equal(got.numpy(), want)


def test_gather_zero_fills_outside_source():
    plan = shuffle.build_shuffle_plan(np.array([2, 5, 0, 9]), n_src=4)
    got = shuffle.planned_shuffle(plan, torch.tensor([1.0, 2.0, 3.0, 4.0]))
    np.testing.assert_array_equal(got.numpy(), [3.0, 0.0, 1.0, 0.0])


@pytest.mark.parametrize("dtype", DTYPES)
def test_expand_matches_jax(plans, dtype):
    ja, ta, jp, tp = plans
    a = _vals(ta.nnz, dtype, 4)
    b = _vals(ta.nnz, dtype, 5)
    want = np.asarray(j_expand(jp.pw, jnp.asarray(a), jnp.asarray(b)))
    got = piecewise.piecewise_expand(
        tp.win.expand, torch.from_numpy(a), torch.from_numpy(b)
    ).numpy()
    n = tp.win.expand.n
    np.testing.assert_array_equal(got, want[:n])
    assert not want[n:].any()  # the JAX arena's tail pad holds zeros


@pytest.mark.parametrize("dtype", DTYPES)
def test_fused_class_matches_jax(plans, dtype):
    """K3 against the JAX v1 pair it replaces: the class's tile
    permutation, then the fused reduction."""
    _, _, jp, tp = plans
    assert any(f.tier_vs for f in tp.win.fused)  # tiers exercised
    for ci, (jb, jf, tf) in enumerate(zip(jp.win.benes, jp.win.fused,
                                          tp.win.fused)):
        x = _vals(tf.slots, dtype, 10 + ci)
        want = np.asarray(j_fused(jf, jsh.tile_benes_apply(jb, jnp.asarray(x))))
        got = window_fused.fused_class_apply(tf, torch.from_numpy(x)).numpy()
        np.testing.assert_allclose(got, want, rtol=FOLD_RTOL[dtype], atol=0)


@pytest.mark.parametrize("dtype", DTYPES)
def test_runcopy_matches_jax(plans, dtype):
    _, _, jp, tp = plans
    src = _vals(tp.win.merge.n_src, dtype, 6)
    want = np.asarray(j_runcopy(jp.win.merge, jnp.asarray(src)))
    got = runcopy.runcopy(tp.win.merge, torch.from_numpy(src)).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("dtype", DTYPES)
def test_slab_class_reduce_matches_jax(monkeypatch, dtype):
    """The fallback pool's class reduction (plain ops on both sides), on a
    plan whose heavy row outgrows a window ladder capped at 2048 slots; a
    dense row and column make entry (7, 7) longer than one 512-product
    chunk, so the reduction runs two slab levels."""
    monkeypatch.setattr(jwin, "N_WIN_CLASSES", 2)
    monkeypatch.setattr(tkg, "N_WIN_CLASSES", 2)
    import scipy.sparse as sp

    rng = np.random.default_rng(11)
    m = 600
    s = sp.random(m, m, density=0.005, random_state=5, format="lil")
    s[7, :] = rng.standard_normal(m)
    s[:, 7] = rng.standard_normal((m, 1))
    s = sp.csr_matrix(s)
    jp = j_plan(JCSR.from_scipy(s), JCSR.from_scipy(s), shuffle=True,
                layout="window")
    tw = nt.spgemm_plan(nt.CSR.from_scipy(s), nt.CSR.from_scipy(s),
                        shuffle=True, layout="window").win
    assert tw.fb_shuffle is not None and tw.fb_lvl_idx  # two slab levels
    x = _vals(tw.fb_shuffle.n, dtype, 7)
    want = np.asarray(j_slab_reduce(jnp.asarray(x), jp.win.fb_levels,
                                    jp.win.fb_lvl_idx))
    got = slab_class_reduce(torch.from_numpy(x), tw.fb_levels,
                            tw.fb_lvl_idx).numpy()
    np.testing.assert_allclose(got, want, rtol=FOLD_RTOL[dtype], atol=0)


def test_wrappers_raise_off_cpu_without_cuda(plans):
    """A wrapper takes its plain version only for CPU tensors; any other
    device must launch the kernel or raise — never fall back."""
    _, ta, _, tp = plans
    w = tp.win.to("meta")
    a = ta.val.to("meta")
    calls = [
        lambda: shuffle.gather(a, w.fused[0].tile_idx),
        lambda: piecewise.piecewise_expand(w.expand, a, a),
        lambda: window_fused.fused_class_apply(
            w.fused[0], torch.zeros(w.fused[0].slots, device="meta")),
        lambda: runcopy.runcopy(
            w.merge, torch.zeros(w.merge.n_src, device="meta")),
    ]
    for call in calls:
        with pytest.raises(ValueError, match="must be on"):
            call()
    assert (shuffle.gather.launches, piecewise.piecewise_expand.launches,
            window_fused.fused_class_apply.launches,
            runcopy.runcopy.launches) == (0, 0, 0, 0)


def test_plan_guards_reject_bad_tables():
    with pytest.raises(ValueError, match="ascending"):
        runcopy.build_runcopy_plan([0, 0], [4, 4], 16, dst=[0, 2])
    with pytest.raises(ValueError, match="outside"):
        runcopy.build_runcopy_plan([14], [4], 16, dst=[0])
    with pytest.raises(ValueError, match="past b.val"):
        piecewise.build_expand_plan([0, 8], [0, 6], [8, 4], [0, 1], 16,
                                    nnz_a=2, nnz_b=9)
    with pytest.raises(ValueError, match="ascending"):
        piecewise.build_expand_plan([0, 8, 8], [0, 0, 0], [1, 1, 1],
                                    [0, 1, 2], 16, nnz_a=3, nnz_b=9)
    ok = dict(w=4, slots=8, lv=0, tier_vs=(), tier_idx=[])
    with pytest.raises(ValueError, match="window-local"):
        window_fused.build_fused_plan(
            **ok, tile_idx=np.array([0, 1, 2, 4] * 2), ext_idx=np.full(8, -1),
            entry_idx=np.zeros(8),
        )
    with pytest.raises(ValueError, match="window-local"):
        window_fused.build_fused_plan(
            **ok, tile_idx=np.zeros(8), ext_idx=np.full(8, -1),
            entry_idx=np.array([0, 1, 2, 7] * 2),
        )
    with pytest.raises(ValueError, match="window-local"):
        window_fused.build_fused_plan(
            **ok, tile_idx=np.zeros(8), ext_idx=np.array([0, 1, 2, 4] * 2),
            entry_idx=np.zeros(8),
        )


@pytest.mark.parametrize("dtype", DTYPES)
def test_build_bank_matches_jax(dtype):
    """K11's plain version against the JAX build_bank (its off-TPU roll
    form) bit for bit, on a table with -1 slots and an index past b.val."""
    rng = np.random.default_rng(8)
    b = _vals(3000, dtype, 9)
    b8_idx = rng.integers(-1, 3000, 4000).astype(np.int32)
    b8_idx[rng.random(4000) < 0.3] = -1
    rows = piecewise.bank_rows_for(b8_idx.size)
    want = np.asarray(j_build_bank(build_flat_gather_plan(b8_idx), rows,
                                   jnp.asarray(b)))
    got = piecewise.build_bank(torch.from_numpy(b8_idx), rows,
                               torch.from_numpy(b))
    assert got.shape == (piecewise.BANK_K * rows, 128)
    np.testing.assert_array_equal(got.numpy(), want)
    b8_idx[5] = 3000  # outside b.val: a zero, as a -1 slot
    got = piecewise.build_bank(torch.from_numpy(b8_idx), rows,
                               torch.from_numpy(b)).numpy().reshape(-1)
    assert got[piecewise.BIAS + 5] == 0


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("copies", [piecewise.BANK_K, 1])
def test_build_bank_to_the_bank_end_matches_jax(dtype, copies):
    """A table that runs to the last slot of a 64-row bank: each copy's
    tail wraps into the BIAS zeros, as in the JAX build_bank; one copy is
    the JAX bank's first (the flat table), bit for bit."""
    rows = 64
    n = rows * 128
    rng = np.random.default_rng(copies)
    b = _vals(7000, dtype, 14)
    b8_idx = rng.integers(-1, 7000, n - piecewise.BIAS).astype(np.int32)
    want = np.asarray(j_build_bank(build_flat_gather_plan(b8_idx), rows,
                                   jnp.asarray(b)))[: copies * rows]
    got = piecewise.build_bank(torch.from_numpy(b8_idx), rows,
                               torch.from_numpy(b), copies)
    assert got.shape == (copies * rows, 128)
    np.testing.assert_array_equal(got.numpy(), want)
    flat = got.numpy().reshape(copies, n)
    for k in range(copies):  # the last 8k slots of copy k: the BIAS zeros
        assert not flat[k, n - 8 * k:].any()
        assert flat[k, n - 8 * k - 1] == flat[0, n - 1]


@pytest.mark.parametrize("dtype", DTYPES)
def test_gather_tiles8_matches_jax(dtype):
    """K12's plain version against the JAX gather_tiles8 in interpret
    mode, with repeated and zero-tile sources."""
    rng = np.random.default_rng(12)
    src = _vals(20 * 1024, dtype, 13)
    src[-1024:] = 0
    ids = rng.integers(0, 20, 24).astype(np.int32)
    ids[[3, 7]] = 19
    want = np.asarray(j_tiles8(jnp.asarray(src).reshape(-1, 128),
                               jnp.asarray(ids), 24)).reshape(-1)
    got = gather_tiles.gather_tiles8(torch.from_numpy(src),
                                     torch.from_numpy(ids))
    np.testing.assert_array_equal(got.numpy(), want)
    out = gather_tiles.gather_tiles8(torch.from_numpy(src),
                                     torch.tensor([-1, 20, 2], dtype=torch.int32))
    assert not out[:2048].any()
    np.testing.assert_array_equal(out[2048:].numpy(), src[2048:3072])


def test_expand_pieces_picks_the_last_piece():
    """K2 piece mode's plain version on hand-made tables: each slot takes
    the last piece that starts at or before it; a pad subtile (every cut
    at 1024) is zeros."""
    bank = torch.arange(16 * 64 * 128, dtype=torch.float64).reshape(-1, 128)
    cuts = torch.tensor([0, 100, 1024, 1024, 1024, 1024], dtype=torch.int32)
    boffs = torch.tensor([3, 64 + 5, 0, 0, 0, 0], dtype=torch.int32)
    apv = torch.tensor([2.0, -1.0, 7.0, 7.0, 7.0, 7.0], dtype=torch.float64)
    out = torch.full((2048,), 9.0, dtype=torch.float64)
    tables = piecewise.merge_piece_tables([3], [cuts], [boffs])
    piecewise.expand_pieces(tables, apv, bank, out)
    p = torch.arange(1024, dtype=torch.float64)
    want = torch.where(p < 100, 2.0 * (3 * 128 + p), -(69 * 128 + p))
    assert torch.equal(out[:1024], want)
    assert not out[1024:].any()


def test_v2_wrappers_raise_off_cpu_without_cuda():
    """K11, K12, K2 piece mode and K3 v2 take their plain versions only
    for CPU tensors; any other device launches the kernel or raises."""
    a = nt.rmat_csr(8, edge_factor=8, dtype=np.float64, seed=2)
    w = nt.spgemm_plan(a, a, shuffle=True, layout="window").win
    assert w.fused_expand
    wm = w.to("meta")
    fp = wm.fused[0]
    val = a.val.to("meta")
    bank = torch.zeros(piecewise.BANK_K * w.bank_rows, 128, device="meta",
                       dtype=torch.float64)
    apv = torch.zeros(fp.apv_hi - fp.apv_lo, device="meta",
                      dtype=torch.float64)
    calls = [
        lambda: piecewise.build_bank(wm.b8_idx, w.bank_rows, val),
        lambda: gather_tiles.gather_tiles8(
            torch.zeros(2048, device="meta"),
            torch.zeros(2, dtype=torch.int32, device="meta")),
        lambda: piecewise.expand_pieces(
            piecewise.merge_piece_tables(
                [2], [w.fused[0].ecuts[:4]], [w.fused[0].eboffs[:4]]
            ).to("meta"), apv[:4], bank,
            torch.zeros(2048, device="meta", dtype=torch.float64)),
        lambda: window_fused.fused_class_apply(fp, bank=bank, apv=apv),
    ]
    for call in calls:
        with pytest.raises(ValueError, match="must be on"):
            call()
    assert (piecewise.build_bank.launches, gather_tiles.gather_tiles8.launches,
            piecewise.expand_pieces.launches,
            window_fused.fused_class_expand.launches) == (0, 0, 0, 0)


def _v2_tables(**bad):
    """A one-window, two-subtile v2 class (W = 2048, one step) with its
    pieces, one table entry replaced by ``bad``."""
    ecuts = np.array([0, 512, 0, 0], np.int64)
    eends = np.array([512, 1024, 1024, 1024], np.int64)
    eboffs = np.array([0, 1, 2, 0], np.int64)
    etrips = np.array([[0, 2], [2, 3]], np.int64)
    tables = dict(etrips=etrips, ecuts=ecuts, eboffs=eboffs, eends=eends)
    for key, (i, v) in bad.items():
        tables[key] = tables[key].copy()
        tables[key].reshape(-1)[i] = v
    return window_fused.ClassPieces(
        tables["etrips"], tables["ecuts"], tables["eboffs"], tables["eends"],
        j2_cap=4, blk=2048, apv_lo=0, apv_hi=4, bank_rows=64)


@pytest.mark.parametrize("bad,match", [
    (None, None),
    (dict(etrips=(3, 5)), "leave their step"),
    (dict(ecuts=(1, 1030)), "outside its subtile"),
    (dict(eends=(1, 1025)), "outside its subtile"),
    (dict(ecuts=(1, 400)), "overlap"),
    (dict(eboffs=(2, 16 * 64 - 7)), "outside the bank"),
])
def test_v2_table_checks_reject_bad_tables(bad, match):
    """build_fused_plan's v2 checks: pieces inside their step's region,
    ``cut <= end <= 1024``, no overlap, bank rows inside the bank; and the
    tile table must be a permutation per window."""
    w = 2048
    ident = np.arange(w)
    args = dict(w=w, slots=w, lv=0, tier_vs=(), tier_idx=[],
                tile_idx=ident, ext_idx=np.full(w, -1), entry_idx=ident)
    if bad is None:
        plan = window_fused.build_fused_plan(**args, pieces=_v2_tables())
        assert plan.expand and torch.equal(plan.tile_inv, plan.tile_idx)
        with pytest.raises(ValueError, match="not a permutation"):
            window_fused.build_fused_plan(
                **dict(args, tile_idx=np.zeros(w, np.int64)),
                pieces=_v2_tables())
        return
    with pytest.raises(ValueError, match=match):
        window_fused.build_fused_plan(**args, pieces=_v2_tables(**bad))


def test_piecewise_plan_guards():
    """build_piecewise_plan takes 8-aligned runs only; a bank beyond
    BANK_ROWS_MAX takes the unaligned mode (flat table offsets, no bank)."""
    with pytest.raises(ValueError, match="8-aligned"):
        piecewise.build_piecewise_plan([0, 12], [0, 8], [0, 1], 32, 2, 64)
    big = piecewise.build_piecewise_plan([0, 8], [0, 8], [0, 1], 32, 2,
                                         piecewise.BANK_ROWS_MAX * 128)
    assert (big.aligned, big.bank_rows) == (False, 0)
    # subtile 0: the offset of slot p of a run is BIAS + its table offset
    # minus its start, so runs 0 and 1 (table offsets 0 and 8, starts 0
    # and 8) read from BIAS on, and the pad run (start 32) from BIAS - 32
    assert big.boffs[1][:3].tolist() == [piecewise.BIAS] * 2 + [
        piecewise.BIAS - 32]
    assert big.cuts[1][:3].tolist() == [0, 8, 32]
    plan = piecewise.build_piecewise_plan([0, 8], [0, 8], [0, 1], 16, 2, 16)
    # subtile 0 holds the two runs and the pad run: the J = 4 class
    assert [int(i.numel()) for i in plan.ids] == [0, 8, 0, 0, 0, 0, 0]
    assert plan.arena_src.tolist() == [0] + [8] * 7


def _kfold_runs(seed):
    """Runs grouped by fold factor (K = 1, 2, 4, 8), sub-run strides at
    least the output length, as tests/test_runcopy.py makes them."""
    rng = np.random.default_rng(seed)
    src_off, lens, kfac, stride = [], [], [], []
    cursor = 0
    for k, count, lmax in ((1, 8, 600), (2, 6, 300), (4, 5, 150), (8, 4, 80)):
        for _ in range(count):
            ln = int(rng.integers(3, lmax))
            st = ln + int(rng.integers(0, 9))
            s0 = cursor + int(rng.integers(0, 33))
            src_off.append(s0)
            lens.append(ln)
            kfac.append(k)
            stride.append(st)
            cursor = s0 + st * k
    return [np.asarray(x, np.int64) for x in (src_off, lens, kfac, stride)]


def test_runcopy_kfold_matches_jax():
    """K4's K-fold mode: the destinations equal the JAX package's array
    for array, and the values the JAX kernel's (interpret mode) within
    rtol 1e-6 (the JAX kernel may add the K terms in another order); the
    plain version adds them in t order, so summing by hand in that order
    gives its values exactly.  float64 raises, as in JAX."""
    src_off, lens, kfac, stride = _kfold_runs(5)
    n_src = 1 << 16
    src = _vals(n_src, np.float32, 9)
    jp, jdst = j_rc_plan(src_off, lens, n_src, kfac=kfac, stride=stride)
    tp, tdst = runcopy.build_runcopy_plan(src_off, lens, n_src, kfac=kfac,
                                          stride=stride)
    np.testing.assert_array_equal(jdst, tdst)
    assert tp.n_out == jp.n_out
    got = runcopy.runcopy(tp, torch.from_numpy(src)).numpy()
    np.testing.assert_allclose(got, np.asarray(j_runcopy(jp, jnp.asarray(src))),
                               rtol=1e-6, atol=1e-6)
    want = np.zeros(tp.n_out, np.float32)
    for s0, ln, d, k, st in zip(src_off, lens, tdst, kfac, stride):
        for t in range(k):
            want[d : d + ln] += src[s0 + t * st : s0 + t * st + ln]
    np.testing.assert_array_equal(got, want)
    with pytest.raises(NotImplementedError, match="float32"):
        runcopy.runcopy(tp, torch.from_numpy(src.astype(np.float64)))
    with pytest.raises(ValueError, match="grouped"):
        runcopy.build_runcopy_plan([0, 8, 16], [4, 4, 4], 64, kfac=[1, 2, 1],
                                   stride=[0, 4, 0])
    with pytest.raises(ValueError, match="outside"):
        runcopy.build_runcopy_plan([0], [4], 8, kfac=[2], stride=[8])


def test_expand_pieces_flat_reads_the_table():
    """K2's flat mode reads ``table[boff + p]`` (row scale 1) where the
    piece mode reads ``bank[boff * 128 + p]``; K11 with one copy builds
    the flat table: the 8-aligned B table behind BIAS zeros."""
    b_val = torch.arange(1, 41, dtype=torch.float64)
    b8_idx = torch.tensor([0, 1, 2, -1, -1, -1, -1, -1] + list(range(3, 11)),
                          dtype=torch.int32)
    rows = piecewise.flat_table_rows(16)
    tbl = piecewise.build_bank(b8_idx, rows, b_val, 1).reshape(-1)
    assert tbl.numel() == rows * 128 and not tbl[: piecewise.BIAS].any()
    assert tbl[piecewise.BIAS : piecewise.BIAS + 16].tolist() == [
        1, 2, 3, 0, 0, 0, 0, 0, 4, 5, 6, 7, 8, 9, 10, 11]
    cuts = torch.tensor([0, 3, 1024, 1024], dtype=torch.int32)
    boffs = torch.tensor([piecewise.BIAS, piecewise.BIAS + 5, 0, 0],
                         dtype=torch.int32)
    apv = torch.tensor([2.0, -1.0, 5.0, 5.0], dtype=torch.float64)
    out = torch.full((2048,), 9.0, dtype=torch.float64)
    piecewise.expand_pieces_flat(
        piecewise.merge_piece_tables([2], [cuts], [boffs]), apv, tbl, out)
    p = torch.arange(1024)
    want = torch.where(p < 3, 2.0 * tbl[piecewise.BIAS + p],
                       -tbl[piecewise.BIAS + 5 + p])
    assert torch.equal(out[:1024], want)
    assert out[:4].tolist() == [2.0, 4.0, 6.0, -4.0]
    assert not out[1024:].any()


def test_flat_and_kfold_wrappers_raise_off_cpu_without_cuda():
    """The new wrappers take their plain versions only for CPU tensors."""
    meta = dict(device="meta")
    i32 = dict(meta, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA device"):
        piecewise.expand_pieces_flat(
            piecewise.merge_piece_tables(
                [2], [torch.zeros(2, dtype=torch.int32)],
                [torch.zeros(2, dtype=torch.int32)]).to("meta"),
            torch.zeros(2, **meta), torch.zeros(4096, **meta),
            torch.zeros(1024, **meta))
    plan, _ = runcopy.build_runcopy_plan([0], [4], 16, kfac=[2], stride=[8])
    with pytest.raises(ValueError, match="CUDA device"):
        runcopy.runcopy(plan.to("meta"), torch.zeros(16, **meta))
    assert piecewise.expand_pieces_flat.launches == 0
    assert runcopy.runcopy_kfold.launches == 0


# -- K3's extraction table and wide windows ---------------------------------


WIDE_W, WIDE_TIERS = 32768, (8192, 2048, 512)


def _wide_class(seed, expand):
    """A synthetic class of two W = 32768 windows (the widest the window
    planner builds): 3 fold levels, three radix-8 tiers, a random tile
    permutation and random tier sources per window, and an extraction of
    a random third of each pyramid into random output slots.  ``expand``
    adds v2 piece tables: 64 subtiles of 1-6 pieces each (a gap before the
    first), one step, pad entries past the pieces as the planner leaves
    them.  Returns (port plan arguments, pieces or None)."""
    w, n_win, lv = WIDE_W, 2, 3
    slots = w * n_win
    rng = np.random.default_rng(seed)
    pyr_len = sum(window_fused.level_widths(w, lv, WIDE_TIERS))
    tile = np.concatenate([rng.permutation(w) for _ in range(n_win)])
    tier_idx = [rng.integers(0, v, n_win * v) for v in WIDE_TIERS]
    ext = np.full(slots, -1, np.int64)
    entry = np.concatenate([rng.permutation(w) for _ in range(n_win)])
    for win in range(n_win):
        e_slots = rng.choice(w, w // 3, replace=False)
        ext[win * w + e_slots] = rng.choice(pyr_len, w // 3, replace=False)
    args = dict(w=w, slots=slots, lv=lv, tier_vs=WIDE_TIERS,
                tile_idx=tile, tier_idx=tier_idx, ext_idx=ext,
                entry_idx=entry)
    if not expand:
        return args, None
    j2_cap, n_sub, bank_rows = 512, slots // 1024, 64
    ecuts = np.zeros(j2_cap, np.int64)
    eends = np.full(j2_cap, 1024, np.int64)
    eboffs = np.zeros(j2_cap, np.int64)
    etrips = np.zeros((n_sub, 2), np.int64)
    q = 0
    for sub in range(n_sub):
        n = int(rng.integers(1, 7))
        bounds = np.sort(rng.choice(np.arange(8, 1025, 8), n + 1,
                                    replace=False))
        ecuts[q : q + n] = bounds[:-1]
        eends[q : q + n] = bounds[1:]
        eboffs[q : q + n] = rng.integers(0, 16 * bank_rows - 8, n)
        etrips[sub] = (q, q + n)
        q += n
    pieces = window_fused.ClassPieces(etrips, ecuts, eboffs, eends, j2_cap,
                                      slots, 0, j2_cap, bank_rows)
    return args, pieces


def _wide_products(pieces, bank, apv):
    """numpy: the v2 class's products in arena order (0 where no piece)."""
    e = np.zeros(pieces.etrips.shape[0] * 1024, bank.dtype)
    flat = bank.reshape(-1)
    for sub, (lo, hi) in enumerate(pieces.etrips):
        for q in range(lo, hi):
            p = np.arange(pieces.ecuts[q], pieces.eends[q])
            e[sub * 1024 + p] = flat[pieces.eboffs[q] * 128 + p] * apv[q]
    return e


@pytest.mark.parametrize("expand", [False, True], ids=["v1", "v2"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_fused_class_wide_windows_match_jax_reference(dtype, expand):
    """K3's plain version at W = 32768, through the composed extraction
    table, against the JAX ``_fused_reference`` (fed the same products in
    fold order, the plan's indices lifted to its class-global form) bit
    for bit, in both modes."""
    args, pieces = _wide_class(3, expand)
    plan = window_fused.build_fused_plan(**args, pieces=pieces)
    w, slots = args["w"], args["slots"]
    win0 = np.arange(slots) // w * w
    if expand:
        bank = _vals(16 * pieces.bank_rows * 128, dtype, 5).reshape(-1, 128)
        apv = _vals(pieces.j2_cap, dtype, 6)
        e = _wide_products(pieces, bank, apv)
        got = window_fused.fused_class_apply(
            plan, bank=torch.from_numpy(bank), apv=torch.from_numpy(apv))
    else:
        e = _vals(slots, dtype, 7)
        got = window_fused.fused_class_apply(plan, torch.from_numpy(e))
    n_win = slots // w
    ref = types.SimpleNamespace(
        w=w, slots=slots, lv=args["lv"],
        tier_meta=[(None, v, None) for v in WIDE_TIERS],
        ref_tier_idx=[np.asarray(t) + np.arange(n_win * v) // v * v
                      for t, v in zip(args["tier_idx"], WIDE_TIERS)],
        ref_ext_idx=_lift_ext(args["ext_idx"], w, args["lv"], WIDE_TIERS,
                              slots),
        ref_entry_idx=args["entry_idx"] + win0)
    fold = e[win0 + args["tile_idx"]]  # the products in fold-slot order
    want = np.asarray(j_fused_ref(ref, jnp.asarray(fold)))
    assert want.dtype == dtype
    np.testing.assert_array_equal(got.numpy(), want)


def test_extraction_table_composes_ext_and_entry(plans):
    """``pyr_dst`` inverts ``ext[entry[i]]``: per window, each pyramid
    value read names the one output slot that reads it; the others hold
    -1.  Two slots reading one value are refused, as is a window past
    MAX_WIDTH."""
    tp = plans[3]
    for fp in tp.win.fused:
        n_win, w = fp.n_win, fp.w
        ext = fp.ext_idx.numpy().astype(np.int64)
        entry = fp.entry_idx.numpy().astype(np.int64)
        dst = fp.pyr_dst.numpy().reshape(n_win, -1).astype(np.int64)
        assert fp.pyr_dst.dtype == torch.int16
        assert dst.shape[1] == fp.pyr_len
        win0 = np.arange(fp.slots) // w * w
        src = ext[win0 + entry].reshape(n_win, w)
        for win in range(n_win):
            read = np.flatnonzero(src[win] >= 0)
            np.testing.assert_array_equal(dst[win, src[win, read]], read)
            assert (dst[win] >= 0).sum() == read.size
    ok = dict(w=4, slots=8, lv=0, tier_vs=(), tier_idx=[],
              tile_idx=np.array([0, 1, 2, 3] * 2),
              entry_idx=np.array([0, 1, 2, 3] * 2))
    with pytest.raises(ValueError, match="read one pyramid value"):
        window_fused.build_fused_plan(
            **ok, ext_idx=np.array([0, 1, 1, -1] * 2))
    with pytest.raises(ValueError, match="exceed"):
        window_fused.build_fused_plan(
            w=65536, slots=65536, lv=0, tier_vs=(), tier_idx=[],
            tile_idx=np.zeros(65536), ext_idx=np.full(65536, -1),
            entry_idx=np.zeros(65536))


def test_v2_piece_subtiles():
    """``esub`` names each piece's window-local subtile (0 for pads), and
    the pieces of one window's subtiles must follow each other."""
    args, pieces = _wide_class(8, True)
    plan = window_fused.build_fused_plan(**args, pieces=pieces)
    esub = plan.esub.numpy()
    for sub, (lo, hi) in enumerate(pieces.etrips):
        assert (esub[lo:hi] == sub % 32).all()
    assert not esub[pieces.etrips[-1, 1]:].any()
    et = pieces.etrips.copy()
    et[5] = (et[5, 0] + 1, et[5, 1])  # a hole after subtile 4's pieces
    with pytest.raises(ValueError, match="not consecutive"):
        window_fused.build_fused_plan(**args, pieces=pieces._replace(
            etrips=et))


def _piece_plan(monkeypatch, flat):
    """The port's and the JAX package's piece plans of the global layout
    on B whose row degrees are multiples of 8 (where the JAX unaligned
    mode reads right), with pieces in several budget classes; ``flat``
    patches BANK_ROWS_MAX in both packages (the unaligned mode)."""
    import nsparse_tpu.ops.kernels.piecewise as jpw
    import scipy.sparse as sp

    if flat:
        monkeypatch.setattr(jpw, "BANK_ROWS_MAX", 1)
        monkeypatch.setattr(piecewise, "BANK_ROWS_MAX", 1)
    rng = np.random.default_rng(31)
    n = 400
    b_s = sp.lil_matrix((n, n))
    for r in range(n):
        deg = 8 * int(rng.choice([1, 2, 4, 12, 40]))
        b_s[r, rng.choice(n, size=deg, replace=False)] = \
            rng.standard_normal(deg)
    a_s = sp.csr_matrix(sp.random(300, n, density=0.03, random_state=2))
    b_s = sp.csr_matrix(b_s)
    jp = j_plan(JCSR.from_scipy(a_s), JCSR.from_scipy(b_s), shuffle=True,
                layout="global")
    tp = nt.spgemm_plan(nt.CSR.from_scipy(a_s), nt.CSR.from_scipy(b_s),
                        shuffle=True, layout="global")
    return jp, tp, a_s, b_s


@pytest.mark.parametrize("flat", [False, True], ids=["aligned", "flat"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_merged_piece_expansion_matches_jax(monkeypatch, dtype, flat):
    """K2's plain version over the merged tables of every piece class (one
    launch on the card) against the JAX piecewise_expand, slot for slot,
    in the aligned and the flat mode; the merged tables hold the classes'
    tables end to end."""
    jp, tp, a_s, b_s = _piece_plan(monkeypatch, flat)
    pw = tp.glob.pw
    assert pw.aligned == (not flat)
    assert sum(1 for i in pw.ids if i.numel()) >= 3  # several classes
    tables = pw.pieces
    assert [r[1] for r in tables.rows] == [
        j for j, i in zip(piecewise.J_CLASSES, pw.ids) if i.numel()]
    np.testing.assert_array_equal(
        tables.cuts.numpy(), np.concatenate([c.numpy() for c in pw.cuts]))
    assert tables.n_sub == pw.n_compact
    a = _vals(a_s.nnz, dtype, 12)
    b = _vals(b_s.nnz, dtype, 13)
    want = np.asarray(j_expand(jp.pw, jnp.asarray(a), jnp.asarray(b)))
    table = piecewise.build_table(pw, tp.glob.b8_idx, torch.from_numpy(b))
    got = piecewise.piecewise_expand(pw, torch.from_numpy(a),
                                     torch.from_numpy(b), bank=table)
    np.testing.assert_array_equal(got.numpy()[: want.size], want)

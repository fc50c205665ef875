"""The port's SpMV path against the JAX package: generators, oracles and
roofline, the ELL/DIA/BSR conversions, the DIA (K7), BSR (K8) and ELL
(K14) kernels' plain versions, the ``spmv`` dispatch over every format and
semiring, ``spmm``, the tuner and the ``spmv`` CLI.

Inputs are made with numpy from fixed seeds and go through both packages
(the port on CPU tensors, so its kernels run their plain versions).
Structures must be equal array for array.  Values: f64 at rtol 1e-12
(sums may be taken in another order), f32 at rtol 1e-6 against the JAX
Pallas kernels in interpret mode.  The CUDA kernels are held against the
same plain versions on the card by ``chip_smoke.py``.  K14's plain
version (the ELL SpMV in the kernel's order of adds) is held against the
JAX ELL SpMV within ``nsparse_tpu/utils/checking.py``'s tolerances, and
against a stand-in for the card that runs the kernel's C contract from
its slab table (``_K14Card``) bit for bit.
"""

import ctypes
import dataclasses

import numpy as np
import pytest
import scipy.sparse as sp

import jax.numpy as jnp
import torch

import nsparse_tpu.formats.ell as jellmod
from nsparse_tpu.formats.bsr import BSR as JBSR
from nsparse_tpu.formats.coo import COO as JCOO
from nsparse_tpu.formats.csr import CSR as JCSR
from nsparse_tpu.formats.dia import DIA as JDIA
from nsparse_tpu.formats.ell import ELL as JELL
from nsparse_tpu.io import generate as jgen
from nsparse_tpu.ops.spmv import spmm as j_spmm
from nsparse_tpu.ops.spmv import spmv as j_spmv
from nsparse_tpu.ops.spmv import spmv_bsr as j_spmv_bsr
from nsparse_tpu.ops.spmv import spmv_dia as j_spmv_dia
from nsparse_tpu.ops.kernels.dia_pallas import spmv_dia_pallas
from nsparse_tpu.ops.kernels.spmv_pallas import spmv_bsr_pallas
from nsparse_tpu.utils import checking as jchk
from nsparse_tpu.utils import roofline as jroof

import nsparse_tpu_torch as nt
import nsparse_tpu_torch.formats.ell as tellmod
from nsparse_tpu_torch.ops.kernels import cuda_lib
from nsparse_tpu_torch.ops.kernels import dia as k7
from nsparse_tpu_torch.ops.kernels import spmv_bsr as k8
from nsparse_tpu_torch.ops.kernels import spmv_ell as k14
from nsparse_tpu_torch.tune import autotune
from nsparse_tpu_torch.tune.plan import Plan, matrix_fingerprint
from nsparse_tpu_torch.utils import profiling
from nsparse_tpu_torch.utils import roofline as troof

from test_torch_gather import _same_plan

SEMIRINGS = ["plus_times", "min_plus", "max_plus", "max_times"]


def _j(a):
    """The JAX CSR of a port CSR."""
    return JCSR.from_scipy(a.to_scipy())


def _x(n, dtype=np.float64, seed=1):
    return np.random.default_rng(seed).standard_normal(n).astype(dtype)


def _hub_matrix(seed=9, m=600):
    """Power-law-ish rows: every 7th row a hub wider than the split
    width, some empty rows."""
    rng = np.random.default_rng(seed)
    rows, cols = [], []
    for r in range(m):
        d = 0 if r % 11 == 5 else (3 if r % 7 else 300)
        rows += [r] * d
        cols += list(rng.choice(m, size=d, replace=False))
    v = rng.standard_normal(len(rows))
    return nt.CSR.from_scipy(sp.csr_matrix((v, (rows, cols)), shape=(m, m)))


MATRICES = {
    "random": lambda: nt.random_csr(200, 150, 0.05, seed=2),
    "stencil": lambda: nt.stencil_csr(16, 16),
    "rmat": lambda: nt.rmat_csr(8, edge_factor=4, seed=3),
    "hubs": _hub_matrix,
}


def _wide_matrix(seed=5, m=3000):
    """Rows of 2 to 40 entries, every 97th row 2,500 wide: unsplit, its
    slab is 4,096 wide, and row 50 lies in one of 2,048."""
    rng = np.random.default_rng(seed)
    deg = np.where(np.arange(m) % 97 == 3, 2500, rng.integers(2, 40, m))
    deg[50] = 1500
    rows = np.repeat(np.arange(m), deg)
    cols = np.concatenate([rng.choice(m, size=d, replace=False)
                           for d in deg])
    return nt.CSR.from_scipy(sp.csr_matrix(
        (rng.standard_normal(rows.size), (rows, cols)), shape=(m, m)))


# ---------------------------------------------------------------------------
# generators, oracles, roofline
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_random_and_fem_generators_match_jax(dtype):
    for j, t in [
        (jgen.random_csr(90, 70, 0.07, dtype=dtype, seed=4),
         nt.random_csr(90, 70, 0.07, dtype=dtype, seed=4)),
        (jgen.fem_block_csr(40, dof=4, neighbors=3, bandwidth=6, dtype=dtype,
                            seed=5),
         nt.fem_block_csr(40, dof=4, neighbors=3, bandwidth=6, dtype=dtype,
                          seed=5)),
    ]:
        rpt, col, val = j.host_arrays()
        np.testing.assert_array_equal(rpt, t.rpt.numpy())
        np.testing.assert_array_equal(col[: j.nnz], t.col.numpy())
        np.testing.assert_array_equal(val[: j.nnz], t.val.numpy())
        assert (j.shape, j.nnz) == (t.shape, t.nnz)


def test_spmv_oracles_and_roofline_match_jax():
    a = nt.rmat_csr(7, edge_factor=4, seed=1)
    x = _x(a.shape[1])
    np.testing.assert_array_equal(nt.spmv_oracle(a, x),
                                  jchk.spmv_oracle(_j(a), x))
    np.testing.assert_array_equal(nt.spmv_abs_oracle(a, torch.from_numpy(x)),
                                  jchk.spmv_abs_oracle(_j(a), x))
    for kw in ({}, dict(val_bytes=8, idx_bytes=0, padded_nnz=5000)):
        assert troof.spmv_bytes(1234, 100, 90, **kw) == \
            jroof.spmv_bytes(1234, 100, 90, **kw)
    spec = troof.chip_specs("NVIDIA H100 80GB HBM3")
    jspec = dataclasses.replace(jroof.chip_specs(), hbm_gbps=spec.hbm_gbps)
    assert troof.spmv_roofline_gflops(1234, 100, 90, spec) == \
        pytest.approx(jroof.spmv_roofline_gflops(1234, 100, 90, spec=jspec))


# ---------------------------------------------------------------------------
# conversions
# ---------------------------------------------------------------------------


def _same_ell(j, t):
    assert (j.shape, j.widths, j.nnz) == (t.shape, t.widths, t.nnz)
    for name in ("vals", "cols", "lens"):
        for a, b in zip(getattr(j, name), getattr(t, name)):
            np.testing.assert_array_equal(np.asarray(a), b.numpy())
    np.testing.assert_array_equal(np.asarray(j.pos), t.pos.numpy())
    for name in ("split_rows", "split_slots"):
        a, b = getattr(j, name), getattr(t, name)
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_array_equal(np.asarray(a), b.numpy())
    for a, b in zip(j.cols_gp, t.cols_gp):
        _same_plan(a, b)
    _same_plan(j.pos_gp, t.pos_gp)
    assert (j.xsh is None) == (t.xsh is None)
    if j.xsh is not None:
        _same_plan(j.uniq_cols_gp, t.uniq_cols_gp)
        _same_plan(j.xfill_gp, t.xfill_gp)
        np.testing.assert_array_equal(np.asarray(j.xsh.idx), t.xsh.idx.numpy())


def _ell_from_jax(j):
    return nt.ELL.from_numpy(
        [np.asarray(v) for v in j.vals], [np.asarray(c) for c in j.cols],
        np.asarray(j.pos), j.shape, j.widths, j.nnz,
        [np.asarray(ln) for ln in j.lens],
        None if j.split_rows is None else np.asarray(j.split_rows),
        None if j.split_slots is None else np.asarray(j.split_slots),
        None if j.xsh is None else np.asarray(j.xsh.idx))


@pytest.mark.parametrize("sigma", [0, None, 1024, 64])
@pytest.mark.parametrize("name", ["hubs", "rmat", "stencil"])
def test_ell_from_csr_matches_jax(name, sigma):
    a = MATRICES[name]()
    kw = dict(min_width=4, max_slabs=5, sigma=sigma, split_width=64)
    j = JELL.from_csr(_j(a), **kw)
    t = nt.ELL.from_csr(a, **kw)
    if name == "hubs":
        assert t.split_rows is not None
    _same_ell(j, t)
    _same_ell(j, _ell_from_jax(j))


@pytest.mark.parametrize("xshuffle", [None, True])
def test_ell_xshuffle_tables_match_jax(xshuffle, monkeypatch):
    for mod in (jellmod, tellmod):
        monkeypatch.setattr(mod, "XSH_MIN_SLOTS", 1)
        monkeypatch.setattr(mod, "XSH_BAD_FRAC", 0.0)
    a = nt.random_csr(700, 5000, density=0.01, seed=13)
    j = JELL.from_csr(_j(a), xshuffle=xshuffle)
    t = nt.ELL.from_csr(a, xshuffle=xshuffle)
    assert t.xsh is not None
    _same_ell(j, t)
    _same_ell(j, _ell_from_jax(j))


def test_ell_xshuffle_gates():
    small = nt.random_csr(200, 2000, density=0.01, seed=13)
    assert nt.ELL.from_csr(small).padded_nnz < tellmod.XSH_MIN_SLOTS
    assert nt.ELL.from_csr(small).xsh is None
    assert nt.ELL.from_csr(small, xshuffle=True).xsh is None
    big = nt.random_csr(700, 5000, density=0.01, seed=13)
    assert nt.ELL.from_csr(big).xsh is not None  # irregular columns
    assert nt.ELL.from_csr(big, xshuffle=False).xsh is None
    assert JELL.from_csr(_j(big)).xsh is not None


@pytest.mark.parametrize("name", ["stencil", "random"])
def test_dia_from_csr_matches_jax(name):
    a = MATRICES[name]()
    kw = dict(max_diags=8, min_coverage=0.5) if name == "random" else {}
    try:
        j = JDIA.from_csr(_j(a), **kw)
    except ValueError:
        with pytest.raises(ValueError):
            nt.DIA.from_csr(a, **kw)
        return
    t = nt.DIA.from_csr(a, **kw)
    np.testing.assert_array_equal(np.asarray(j.vals), t.vals.numpy())
    assert (j.offsets, j.shape, j.nnz) == (t.offsets, t.shape, t.nnz)
    np.testing.assert_array_equal(t.off_t.numpy(), np.asarray(j.offsets))
    u = nt.DIA.from_numpy(np.asarray(j.vals), j.offsets, j.shape, j.nnz)
    np.testing.assert_array_equal(u.vals.numpy(), t.vals.numpy())


@pytest.mark.parametrize("blocksize", [(8, 128), (128, 128), (4, 8)])
def test_bsr_from_csr_matches_jax(blocksize):
    a = _hub_matrix(m=300)  # empty block rows at (4, 8)
    j = JBSR.from_csr(_j(a), blocksize=blocksize)
    t = nt.BSR.from_csr(a, blocksize=blocksize)
    for name in ("data", "block_col", "block_row", "block_rpt"):
        np.testing.assert_array_equal(np.asarray(getattr(j, name)),
                                      getattr(t, name).numpy())
    assert (j.shape, j.blocksize, j.nnz) == (t.shape, t.blocksize, t.nnz)
    u = nt.BSR.from_numpy(np.asarray(j.data), np.asarray(j.block_col),
                          np.asarray(j.block_row), np.asarray(j.block_rpt),
                          j.shape, j.blocksize, j.nnz)
    np.testing.assert_array_equal(u.data.numpy(), t.data.numpy())


def test_bsr_inserts_zero_tiles_for_empty_block_rows():
    m = np.zeros((40, 40))
    m[3, 5], m[35, 1] = 1.0, 2.0
    t = nt.BSR.from_csr(nt.CSR.from_scipy(sp.csr_matrix(m)), blocksize=(8, 8))
    assert (t.block_rpt.diff() >= 1).all()
    assert t.nblocks == 5


# ---------------------------------------------------------------------------
# the DIA and BSR kernels' plain versions against the Pallas kernels
# ---------------------------------------------------------------------------


def test_spmv_dia_matches_pallas_kernel():
    a = nt.stencil_csr(24, 20, dtype=np.float32)
    j = JDIA.from_csr(_j(a))
    x = _x(a.shape[1], np.float32)
    want = np.asarray(spmv_dia_pallas(j.vals, j.offsets, jnp.asarray(x),
                                      a.shape[0]))
    got = k7.spmv_dia(nt.DIA.from_csr(a).vals, j.offsets, torch.from_numpy(x),
                      a.shape[0])
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("shape", [(300, 300), (300, 420), (420, 300)])
def test_spmv_dia_f64_matches_jax(shape):
    """Rectangular shapes: terms past either edge contribute 0."""
    rng = np.random.default_rng(4)
    m, n = shape
    offs = [-130, -3, 0, 2, 77]
    dense = np.zeros(shape)
    for o in offs:
        i = np.arange(max(0, -o), min(m, n - o))
        dense[i, i + o] = rng.standard_normal(i.size)
    a = nt.CSR.from_scipy(sp.csr_matrix(dense))
    x = _x(n)
    want = np.asarray(j_spmv_dia(JDIA.from_csr(_j(a)), jnp.asarray(x)))
    got = nt.spmv(nt.DIA.from_csr(a), torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=1e-14)
    np.testing.assert_allclose(got.numpy(), dense @ x, rtol=1e-12,
                               atol=1e-12)


def test_spmv_bsr128_matches_pallas_kernel():
    a = nt.fem_block_csr(24, dof=8, neighbors=3, bandwidth=6,
                         dtype=np.float32, seed=2)
    x = _x(a.shape[1], np.float32)
    want = np.asarray(spmv_bsr_pallas(JBSR.from_csr(_j(a), (128, 128)),
                                      jnp.asarray(x), interpret=True))
    t = nt.BSR.from_csr(a, (128, 128))
    got = nt.spmv(t, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-5)
    np.testing.assert_array_equal(got.numpy(),
                                  k8.spmv_bsr(t, torch.from_numpy(x)).numpy())


def test_spmv_bsr_8x128_f64_matches_jax():
    a = nt.fem_block_csr(30, dof=5, neighbors=3, bandwidth=6, seed=3)
    x = _x(a.shape[1])
    want = np.asarray(j_spmv_bsr(JBSR.from_csr(_j(a)), jnp.asarray(x)))
    got = nt.spmv(nt.BSR.from_csr(a), torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=1e-13)


def test_kernel_wrappers_refuse_bad_inputs():
    a = nt.stencil_csr(8, 8)
    d = nt.DIA.from_csr(a)
    with pytest.raises(TypeError):
        k7.spmv_dia(d.vals, d.offsets, torch.zeros(64, dtype=torch.float32),
                    64)
    with pytest.raises(ValueError):
        k8.spmv_bsr(nt.BSR.from_csr(a), torch.zeros(64, dtype=torch.float64))


def test_ell_kernel_wrapper_refuses_bad_inputs(monkeypatch):
    """K14's wrapper refuses x of another dtype or length and slabs off a
    card before the kernel library is touched; no launch is counted."""
    def refuse():
        pytest.fail("the kernel library was touched before the checks")

    monkeypatch.setattr(cuda_lib.KERNELS, "get", refuse)
    monkeypatch.setattr(cuda_lib, "_RESOLVED", {})
    e = nt.ELL.from_csr(nt.stencil_csr(8, 8))
    before = k14.spmv_ell.launches
    with pytest.raises(TypeError, match="x is torch.float32"):
        k14.spmv_ell(e, torch.zeros(64, dtype=torch.float32))
    for bad in (torch.zeros(63, dtype=torch.float64),
                torch.zeros(64, 1, dtype=torch.float64)):
        with pytest.raises(ValueError, match="64 columns"):
            k14.spmv_ell(e, bad)
    meta = e.to("meta")
    for x in (torch.zeros(64, dtype=torch.float64, device="meta"),
              torch.zeros(64, dtype=torch.float64)):
        with pytest.raises(ValueError, match="must be on one CUDA device"):
            k14.spmv_ell(meta, x)
    e16 = dataclasses.replace(e, vals=tuple(v.half() for v in e.vals))
    with pytest.raises(TypeError, match="float32 or float64"):
        k14.slab_table(e16)
    assert k14.spmv_ell.launches == before


@pytest.mark.parametrize("fault", ["unsorted", "inner-pad"])
def test_ell_refuses_malformed_split_tables(fault):
    """K14 finds a block's split rows by search and stops at a row's
    first -1 chunk pad: the split rows must ascend and the pads trail."""
    j = JELL.from_csr(_j(_hub_matrix()), split_width=64)
    rows = np.asarray(j.split_rows).copy()
    slots = np.asarray(j.split_slots).copy()
    assert slots.shape[1] > 1 and (slots[:, 0] >= 0).all()
    if fault == "unsorted":
        rows = rows[::-1].copy()
    else:
        slots[0, 0] = -1
    with pytest.raises(ValueError, match="ascending"):
        nt.ELL.from_numpy(
            [np.asarray(v) for v in j.vals], [np.asarray(c) for c in j.cols],
            np.asarray(j.pos), j.shape, j.widths, j.nnz,
            [np.asarray(ln) for ln in j.lens], rows, slots)


# ---------------------------------------------------------------------------
# K14, the ELL SpMV kernel: its plain version against JAX, its C contract
# on a stand-in for the card
# ---------------------------------------------------------------------------


def _with_dtype(a, dtype):
    return a.with_values(torch.from_numpy(a.val.numpy().astype(dtype)))


def _k14_against_jax(a, dtype, **kw):
    """K14's plain version on the port's ELL against the JAX ELL SpMV of
    the same slabs, within ``checking.ans_check``'s tolerance of |A||x|;
    returns the port's ELL."""
    a = _with_dtype(a, dtype)
    t = nt.ELL.from_csr(a, **kw)
    j = JELL.from_csr(_j(a), **kw)
    x = _x(a.shape[1], dtype)
    want = np.asarray(j_spmv(j, jnp.asarray(x), use_pallas=False))
    got = k14.spmv_ell(t, torch.from_numpy(x)).numpy()
    assert got.dtype == dtype
    ok, nf = jchk.ans_check(got, want, dtype=dtype,
                            scale=jchk.spmv_abs_oracle(_j(a), x))
    assert ok, nf
    return t


@pytest.mark.parametrize("sigma", [0, 64, 1024, None])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("name", sorted(MATRICES))
def test_ell_kernel_plain_matches_jax(name, dtype, sigma):
    """Every matrix, both dtypes, every sort window; hub rows of 300
    entries split at 64 (five chunks) and unsplit."""
    for split_width in (64, None):
        t = _k14_against_jax(MATRICES[name](), dtype, min_width=2,
                             max_slabs=10, sigma=sigma,
                             split_width=split_width)
        if name == "hubs":
            assert (t.split_rows is not None) == (split_width is not None)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("split_width", [None, 1024])
def test_ell_kernel_plain_matches_jax_on_wide_slabs(split_width, dtype):
    """Slabs past 512 wide: a thread walks the whole of a row."""
    t = _k14_against_jax(_wide_matrix(), dtype, min_width=2,
                         split_width=split_width)
    assert max(t.widths) == (4096 if split_width is None else 1024)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("xshuffle", [False, True])
def test_ell_kernel_plain_matches_jax_with_and_without_xshuffle(
        xshuffle, dtype, monkeypatch):
    """The x-shuffle plans change nothing K14 reads."""
    for mod in (jellmod, tellmod):
        monkeypatch.setattr(mod, "XSH_MIN_SLOTS", 1)
        monkeypatch.setattr(mod, "XSH_BAD_FRAC", 0.0)
    t = _k14_against_jax(nt.random_csr(700, 5000, density=0.01, seed=13),
                         dtype, xshuffle=xshuffle)
    assert (t.xsh is not None) == xshuffle


@pytest.mark.parametrize("split_width", [4, 8, 32])
def test_ell_kernel_plain_matches_jax_on_many_chunks(split_width):
    """Split rows of up to 75 chunks: a row's extra chunks added in the
    order of its ``split_slots`` row."""
    t = _k14_against_jax(_hub_matrix(), np.float64, min_width=2,
                         split_width=split_width)
    assert t.split_slots.shape[1] == -(-300 // split_width) - 1


def test_ell_kernel_plain_empty_rows_and_matrix():
    m = np.zeros((30, 40))
    m[4, 7] = 3.0
    x = _x(40)
    for dense in (m, np.zeros((30, 40))):
        a = nt.CSR.from_scipy(sp.csr_matrix(dense))
        y = k14.spmv_ell(nt.ELL.from_csr(a), torch.from_numpy(x))
        np.testing.assert_array_equal(y.numpy(), dense @ x)
    a = nt.CSR.from_scipy(sp.csr_matrix(np.zeros((5, 0))))
    y = k14.spmv_ell(nt.ELL.from_csr(a), torch.zeros(0, dtype=torch.float64))
    np.testing.assert_array_equal(y.numpy(), np.zeros(5))


class _K14Card:
    """Runs K14's two C entry points on CPU tensors from their arguments
    alone, as the kernel's blocks and threads take them: the slab table's
    pointers are resolved among the ELL's tensors."""

    def __init__(self, ell):
        self.tensors = {t.data_ptr(): t for t in (*ell.vals, *ell.cols,
                                                  *ell.lens)}
        self.calls = []

    def launch(self, what, name, *args):
        sig = cuda_lib._SIGNATURES[name][:-1]
        assert len(args) == len(sig), name
        for a, kind in zip(args, sig):
            if kind is cuda_lib._P:
                assert (isinstance(a, torch.Tensor) and a.is_contiguous()) \
                    or a == 0, name
            elif kind is cuda_lib._I64_ARRAY:
                assert isinstance(a, ctypes.Array), name
            else:
                assert type(a) is int, name
        self.calls.append(name)
        getattr(self, name[len("nsp_spmv_ell_"):])(*args)

    def slabs(self, x, out, table, n_slabs, n_blocks):
        f = np.array(table[: k14.FIELDS * n_slabs], np.int64).reshape(
            n_slabs, k14.FIELDS)
        assert (np.diff(f[:, 6]) >= 0).all()
        for b in range(n_blocks):
            s = int(np.flatnonzero(f[:, 6] <= b)[-1])
            vp, cp, lp, rows, width, slot0, block0 = f[s].tolist()
            val, col, ln = (self.tensors[p] for p in (vp, cp, lp))
            r = (b - block0) * k14.BLOCK_THREADS \
                + torch.arange(k14.BLOCK_THREADS)
            live = r < rows
            rc = r.clamp(max=rows - 1)
            n = torch.where(live, ln[rc].long().clamp(max=width), 0)
            acc = torch.zeros(k14.BLOCK_THREADS, dtype=out.dtype)
            for w in range(int(n.max())):
                prod = val[w, rc] * x[col[w, rc].long()]
                acc = torch.where(w < n, acc + prod, acc)
            out[slot0 + r[live]] = acc[live]

    def rows(self, slot, pos, m, split_rows, split_slots, split_run,
             split_cols, y):
        rows = k14.BLOCK_THREADS
        for b, r0 in enumerate(range(0, m, rows)):
            split_of = [-1] * rows
            if torch.is_tensor(split_run):
                lo, hi = int(split_run[b]), int(split_run[b + 1])
                for k in range(lo, hi):
                    split_of[int(split_rows[k]) - r0] = k
            for t in range(min(rows, m - r0)):
                v = slot[int(pos[r0 + t])]
                if split_of[t] >= 0:
                    for c in range(split_cols):
                        s = int(split_slots[split_of[t], c])
                        if s < 0:
                            break
                        v = v + slot[s]
                y[r0 + t] = v


def _bits(t):
    return t.view(torch.int32 if t.dtype == torch.float32 else torch.int64)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("case", [
    ("hubs", dict(split_width=128)), ("hubs", dict(split_width=None)),
    ("rmat", dict(min_width=2, max_slabs=10)), ("stencil", dict(sigma=0)),
    ("random", dict(sigma=None, split_width=8)),
    ("wide", dict(min_width=2, split_width=None)),
    ("wide", dict(min_width=2, split_width=1024))],
    ids=["hubs-split128", "hubs-unsplit", "rmat", "stencil", "random-split8",
         "wide-unsplit", "wide-split1024"])
def test_ell_kernel_contract_equals_the_plain_version(case, dtype,
                                                      monkeypatch):
    """The slab table and both launches, run on the stand-in in the
    kernel's blocks, threads and order of adds, give the plain version's
    y bit for bit; the wrapper makes exactly the two launches, in spans
    ``spmv.slabs`` and ``spmv.rows``, and counts the call and its slots."""
    name, kw = case
    a = _with_dtype(_wide_matrix() if name == "wide" else MATRICES[name](),
                    dtype)
    e = nt.ELL.from_csr(a, **kw)
    x = torch.from_numpy(_x(a.shape[1], dtype))
    card = _K14Card(e)
    monkeypatch.setattr(cuda_lib, "validate",
                        lambda what, *args: (0, None, list(args)))
    monkeypatch.setattr(cuda_lib, "launch", card.launch)
    monkeypatch.setattr(k14.spmv_ell, "launches", 0)
    t = k14.slab_table(e)
    assert t.n_slots == sum(v.shape[1] for v in e.vals)
    assert t.slots == e.padded_nnz
    profiling.reset()
    with profiling.recording():
        got = k14._launch(e, x, t)
    snap = profiling.snapshot()
    profiling.reset()
    assert card.calls == ["nsp_spmv_ell_slabs", "nsp_spmv_ell_rows"]
    assert k14.spmv_ell.launches == 2
    assert snap["counters"] == {"spmv.ell.k14": 1,
                                "spmv.ell.k14.slots": e.padded_nnz}
    assert {"spmv.slabs", "spmv.rows"} <= set(snap["spans"])
    want = k14.spmv_ell_plain(e, x)
    assert torch.equal(_bits(got), _bits(want))
    ok, nf = nt.ans_check(got, nt.spmv_oracle(a, x.numpy()),
                          scale=nt.spmv_abs_oracle(a, x.numpy()))
    assert ok, nf


def test_ell_slab_table_takes_the_widest_slabs_first(monkeypatch):
    """The table lists the slabs widest first, each with its first slot
    in the ELL's own order and its first block, a block of 256 rows at
    every width."""
    monkeypatch.setattr(cuda_lib, "validate",
                        lambda what, *args: (0, None, list(args)))
    e = nt.ELL.from_csr(nt.rmat_csr(8, edge_factor=16, seed=3),
                        min_width=2, max_slabs=10)
    assert e.widths == (2, 4, 8, 16, 32, 64, 128, 256)
    t = k14.slab_table(e)
    f = np.array(t.table[:], np.int64).reshape(-1, k14.FIELDS)
    rows = [v.shape[1] for v in e.vals]
    order = np.argsort([-w for w in e.widths], kind="stable")
    np.testing.assert_array_equal(f[:, 4], np.asarray(e.widths)[order])
    np.testing.assert_array_equal(f[:, 3], np.asarray(rows)[order])
    np.testing.assert_array_equal(
        f[:, 5], np.concatenate([[0], np.cumsum(rows)[:-1]])[order])
    blocks = -(-f[:, 3] // 256)
    np.testing.assert_array_equal(f[:, 6], np.cumsum(blocks) - blocks)
    assert (t.n_slabs, t.n_blocks, t.n_slots) == (8, blocks.sum(), sum(rows))
    assert t.split_run is None
    wide = k14.slab_table(nt.ELL.from_csr(_wide_matrix(), min_width=2,
                                          split_width=None))
    f = np.array(wide.table[:], np.int64).reshape(-1, k14.FIELDS)
    np.testing.assert_array_equal(f[:3, 4], [4096, 2048, 64])
    np.testing.assert_array_equal(f[:3, 6], [0, 1, 2])
    # the second launch's blocks of 256 rows: each one's first split row
    e = nt.ELL.from_csr(_wide_matrix(), min_width=2, split_width=64)
    run = k14.slab_table(e).split_run
    want = np.searchsorted(e.split_rows.numpy(), np.arange(0, 3257, 256))
    np.testing.assert_array_equal(run.numpy(), want)
    assert run.dtype == torch.int32


# ---------------------------------------------------------------------------
# spmv over every format and semiring, spmm
# ---------------------------------------------------------------------------


def _formats(a):
    """(port, JAX) pairs of every format of ``a``."""
    ja = _j(a)
    out = [("csr", a, ja),
           ("ell", nt.ELL.from_csr(a, split_width=64),
            JELL.from_csr(ja, split_width=64)),
           ("ell-sigma0", nt.ELL.from_csr(a, sigma=0), JELL.from_csr(ja, sigma=0)),
           ("bsr8x128", nt.BSR.from_csr(a), JBSR.from_csr(ja)),
           ("bsr128", nt.BSR.from_csr(a, (128, 128)),
            JBSR.from_csr(ja, (128, 128)))]
    s = a.to_scipy().tocoo()
    out.append(("coo", nt.COO.from_arrays(s.row, s.col, s.data, s.shape),
                JCOO.from_arrays(s.row, s.col, s.data, s.shape)))
    try:
        out.append(("dia", nt.DIA.from_csr(a), JDIA.from_csr(ja)))
    except ValueError:
        pass
    return out


@pytest.mark.parametrize("semiring", SEMIRINGS)
@pytest.mark.parametrize("name", sorted(MATRICES))
def test_spmv_matches_jax(name, semiring):
    a = MATRICES[name]()
    x = _x(a.shape[1])
    checked = 0
    for fmt, t, j in _formats(a):
        if semiring != "plus_times" and fmt.startswith(("bsr", "coo")):
            with pytest.raises(NotImplementedError):
                nt.spmv(t, torch.from_numpy(x), semiring=semiring)
            continue
        want = np.asarray(j_spmv(j, jnp.asarray(x), use_pallas=False,
                                     semiring=semiring))
        got = nt.spmv(t, torch.from_numpy(x), semiring=semiring)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-12,
                                   atol=1e-12, err_msg=fmt)
        checked += 1
    assert checked >= 3


def test_ell_xshuffle_spmv_matches_jax(monkeypatch):
    """The x-shuffle path (K5 gathers, K1 permutation, K6 patches)
    against JAX with its Pallas gathers in interpret mode, f32."""
    import nsparse_tpu.ops.kernels.flat_gather as jfg
    import nsparse_tpu.ops.kernels.shuffle_pallas as jsh

    for mod in (jellmod, tellmod):
        monkeypatch.setattr(mod, "XSH_MIN_SLOTS", 1)
        monkeypatch.setattr(mod, "XSH_BAD_FRAC", 0.0)
    # one slab in row order, so the pos gather is a band and the fill a
    # narrow window (the wide window class costs tens of seconds in
    # interpret mode)
    a = nt.random_csr(300, 1000, density=0.03, seed=13, dtype=np.float32)
    x = _x(1000, np.float32)
    kw = dict(min_width=64, sigma=0, xshuffle=True)
    j = JELL.from_csr(_j(a), **kw)
    t = nt.ELL.from_csr(a, **kw)
    assert j.xsh is not None and t.xsh is not None
    assert "win1024" not in {
        k for gp in (t.pos_gp, t.uniq_cols_gp, t.xfill_gp)
        for k, v in gp.class_fracs.items() if v}
    monkeypatch.setattr(jfg, "FORCE_PALLAS", True)
    monkeypatch.setattr(jsh, "_FALLBACK_N", 1 << 30)  # index-form shuffle
    want = np.asarray(j_spmv(j, jnp.asarray(x)))
    got = nt.spmv(t, torch.from_numpy(x)).numpy()
    # the same products, summed in another order: f32 rounding, bounded
    # by |A||x|
    scale = nt.spmv_abs_oracle(a, x)
    assert (np.abs(got - want) <= 1e-6 * scale).all()
    ok, nf = nt.ans_check(got, nt.spmv_oracle(a, x), scale=scale)
    assert ok, nf


@pytest.mark.parametrize("fmt", ["csr", "bsr8x128", "bsr128"])
def test_spmm_matches_jax(fmt):
    a = nt.random_csr(60, 45, density=0.1, seed=13)
    x = np.random.default_rng(3).standard_normal((45, 7))
    t, j = {f: (t, j) for f, t, j in _formats(a)}[fmt]
    want = np.asarray(j_spmm(j, jnp.asarray(x)))
    got = nt.spmm(t, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("blocksize", [(8, 128), (128, 128)])
def test_bsr_products_keep_full_precision_under_reduced_matmul_modes(
        blocksize):
    """A caller's TF32 / bfloat16 matmul setting changes neither spmm_bsr
    nor the plain BSR SpMV (JAX runs both at Precision.HIGHEST), and the
    caller's setting is left as it was."""
    a = nt.fem_block_csr(24, dof=8, neighbors=3, bandwidth=6,
                         dtype=np.float32, seed=2)
    t = nt.BSR.from_csr(a, blocksize)
    x = np.random.default_rng(4).standard_normal(
        (a.shape[1], 3)).astype(np.float32)
    saved = torch.get_float32_matmul_precision()
    try:
        torch.set_float32_matmul_precision("medium")
        y_mm = nt.spmm(t, torch.from_numpy(x)).numpy()
        y_v = k8.spmv_bsr_plain(t, torch.from_numpy(x[:, 0])).numpy()
        assert torch.get_float32_matmul_precision() == "medium"
    finally:
        torch.set_float32_matmul_precision(saved)
    dense = a.to_scipy().toarray().astype(np.float64)
    scale = np.abs(dense) @ np.abs(x.astype(np.float64))
    err = np.abs(y_mm - dense @ x.astype(np.float64))
    assert (err <= 1e-6 * scale).all()
    assert (np.abs(y_v - dense @ x[:, 0].astype(np.float64))
            <= 1e-6 * scale[:, 0]).all()


def test_autotune_model_mode_moves_only_the_winner(monkeypatch):
    """Model mode scores the candidates on the host and moves only the
    chosen format to the device (``meta`` stands in for the card)."""
    moved = []
    for cls in (nt.CSR, nt.DIA, nt.ELL, nt.BSR):
        def to(self, device, _to=cls.to, _name=cls.__name__):
            moved.append(_name)
            return _to(self, device)
        monkeypatch.setattr(cls, "to", to)
    a = nt.stencil_csr(16, 16)
    fmt, plan = nt.autotune_spmv(a, measure=False, device="meta",
                                 max_bytes_ratio=1e6)
    assert len([s for s in autotune.SWEEP if s["fate"] == "scored"]) >= 9
    assert plan.format == "dia" and fmt.vals.device.type == "meta"
    assert moved == ["DIA"]


def test_spmv_empty_rows_and_matrix():
    m = np.zeros((30, 30))
    m[4, 7] = 3.0
    x = _x(30)
    for dense in (m, np.zeros((30, 30))):
        a = nt.CSR.from_scipy(sp.csr_matrix(dense))
        for fmt in (a, nt.ELL.from_csr(a), nt.BSR.from_csr(a, (128, 128))):
            np.testing.assert_allclose(
                nt.spmv(fmt, torch.from_numpy(x)).numpy(), dense @ x,
                rtol=1e-12)


# ---------------------------------------------------------------------------
# tuner and CLI
# ---------------------------------------------------------------------------


def test_plan_json_and_fingerprint(tmp_path):
    from nsparse_tpu.tune.plan import matrix_fingerprint as j_fp

    a = nt.rmat_csr(7, edge_factor=4, seed=2)
    assert matrix_fingerprint(a) == j_fp(_j(a))
    p = Plan(format="bsr", blocksize=(128, 128), chip="cpu",
             matrix_key=matrix_fingerprint(a), memory_bytes=12)
    p.save(str(tmp_path))
    assert Plan.load(str(tmp_path), p.matrix_key, "cpu") == p
    assert Plan.load(str(tmp_path), p.matrix_key, "other") is None


@pytest.mark.parametrize("name", ["stencil", "hubs"])
def test_autotune_model_mode_takes_smallest_footprint(name, tmp_path):
    a = MATRICES[name]()
    fmt, plan = nt.autotune_spmv(a, measure=False, device="cpu",
                                 cache_dir=str(tmp_path),
                                 max_bytes_ratio=1e6)
    scored = [s for s in autotune.SWEEP if s["fate"] == "scored"]
    assert len(scored) >= 9
    assert plan.memory_bytes == min(s["bytes"] for s in scored)
    assert autotune.footprint(fmt) == plan.memory_bytes
    if name == "stencil":
        assert plan.format == "dia"
    x = _x(a.shape[1])
    ok, nf = nt.ans_check(nt.spmv(fmt, torch.from_numpy(x)),
                          nt.spmv_oracle(a, x),
                          scale=nt.spmv_abs_oracle(a, x))
    assert ok, nf
    fmt2, plan2 = nt.autotune_spmv(a, measure=False, device="cpu",
                                   cache_dir=str(tmp_path))  # cached
    assert plan2 == plan and type(fmt2) is type(fmt)


def test_autotune_measure_mode_needs_a_card():
    with pytest.raises(RuntimeError, match="card"):
        nt.autotune_spmv(nt.stencil_csr(4, 4), measure=True, device="cpu")


@pytest.mark.parametrize("argv", [
    ["spmv", "gen:rmat:10:16", "--format", "ell"],
    ["spmv", "gen:stencil:32:32", "--format", "dia"],
    ["spmv", "gen:fem:32:8", "--format", "bsr"],
    ["spmv", "gen:stencil:32:16", "--format", "auto"],
    ["spmv", "gen:random:300:200:0.02", "--format", "csr"],
])
def test_cli_spmv_passes(argv, capsys):
    from nsparse_tpu_torch.cli import main

    rc = main(["--precision", "double", *argv, "--device", "cpu",
               "--trials", "2"])
    out = capsys.readouterr().out
    assert rc == 0, out
    assert "SpMV [" in out and out.rstrip().endswith("pass"), out


@pytest.mark.parametrize("cmd", [["spmv", "gen:stencil:8:8"],
                                 ["spgemm", "gen:rmat:6:4"]])
def test_cli_refuses_cuda_without_a_card(cmd, monkeypatch):
    from nsparse_tpu_torch.cli import main

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        main(cmd)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        main([*cmd, "--device", "cuda"])

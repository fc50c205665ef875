"""The rest of the port's public API against the JAX package, on the CPU.

- CSR: ``from_dense``, ``from_coo``, the size properties, ``nnz_per_row``,
  ``nnz_max``, ``valid_mask`` and ``row_ids`` (padded tail -> M),
  ``with_capacity``, ``astype``, ``to_dense``, ``transpose``, ``==`` (a
  bool, through ``csr_allclose``) and ``hash``;
- ``to_dense`` of COO, ELL, DIA and BSR;
- ``read_mtx_coo`` and ``write_mtx`` both ways (the same text);
- ``ops.binning``, ``utils.hostmem``, ``io.suitesparse.fetch`` (from a
  cache directory; ``urlopen`` patched to raise, no socket opened);
- ``time_chained`` / ``time_marginal`` and ``profile_op`` on CPU tensors;
- the device checks (``ans_check_device``, ``check_spgemm_answer_device``,
  ``csr_allclose``), each passing on a matching answer and failing on a
  changed column or value;
- the CLI's ``spgemm --plan-cache``, ``spmv --profile``, ``spmv-xla`` and
  ``spgemm-xla`` with ``--device cpu``, and their refusal of
  ``--device cuda`` without a card;
- the exports: every ``__all__`` of the JAX package and its five
  subpackages is a subset of the port's.

Tolerances: values within ``checking.py``'s rtol (1e-8 in f64); integer
tables and dense matrices built by the same additions exactly.
"""

import glob
import importlib
import json
import os
import urllib.request

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import jax.numpy as jnp

import nsparse_tpu.utils.hostmem as jhm
from nsparse_tpu.formats.bsr import BSR as JBSR
from nsparse_tpu.formats.coo import COO as JCOO
from nsparse_tpu.formats.csr import CSR as JCSR
from nsparse_tpu.formats.dia import DIA as JDIA
from nsparse_tpu.formats.ell import ELL as JELL
from nsparse_tpu.io.matrix_market import read_mtx as j_read_mtx
from nsparse_tpu.io.matrix_market import read_mtx_coo as j_read_mtx_coo
from nsparse_tpu.io.matrix_market import write_mtx as j_write_mtx
from nsparse_tpu.ops.binning import bin_histogram as j_bin_histogram
from nsparse_tpu.ops.binning import bin_rows as j_bin_rows
from nsparse_tpu.ops.binning import flops_per_row as j_flops_per_row
from nsparse_tpu.utils.checking import ans_check_device as j_ans_check_device
from nsparse_tpu.utils.checking import csr_allclose as j_csr_allclose

import nsparse_tpu_torch as nt
import nsparse_tpu_torch.utils.hostmem as thm
from nsparse_tpu_torch.io import suitesparse
from nsparse_tpu_torch.io.matrix_market import read_mtx_coo
from nsparse_tpu_torch.ops.binning import (
    BIN_NUM,
    bin_histogram,
    bin_rows,
    flops_per_row,
)
from nsparse_tpu_torch.utils.checking import (
    ans_check_device,
    check_spgemm_answer_device,
    csr_allclose,
)
from nsparse_tpu_torch.utils.profiling import profile_op
from nsparse_tpu_torch.utils.timing import time_chained, time_marginal

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CIRCUIT = os.path.join(REPO, "data", "circuit_zipf.mtx")


def _pair(dtype=np.float64, scale=8, seed=3):
    """The same R-MAT matrix as a port CSR and a JAX CSR."""
    t = nt.rmat_csr(scale, edge_factor=8, dtype=dtype, seed=seed)
    return t, JCSR.from_scipy(t.to_scipy())


def _eq(want, got):
    np.testing.assert_array_equal(np.asarray(want), got.cpu().numpy())


# -- CSR ---------------------------------------------------------------------


def test_csr_constructors_match_jax():
    rng = np.random.default_rng(0)
    dense = rng.standard_normal((17, 13)) * (rng.random((17, 13)) < 0.2)
    j, t = JCSR.from_dense(dense), nt.CSR.from_dense(dense)
    _eq(j.rpt, t.rpt)
    _eq(j.col, t.col)
    _eq(j.val, t.val)
    assert nt.CSR.from_dense(torch.from_numpy(dense)) == t
    rows, cols = rng.integers(0, 9, 40), rng.integers(0, 11, 40)
    vals = rng.standard_normal(40)  # duplicates among them: summed
    jc = JCSR.from_coo(JCOO.from_arrays(rows, cols, vals, (9, 11)))
    tc = nt.CSR.from_coo(nt.COO.from_arrays(rows, cols, vals, (9, 11)))
    _eq(jc.rpt, tc.rpt)
    _eq(jc.col, tc.col)
    np.testing.assert_allclose(np.asarray(jc.val), tc.val.numpy(), rtol=0,
                               atol=0)


@pytest.mark.parametrize("pad", [0, 37])
def test_csr_row_methods_match_jax(pad):
    t, _ = _pair()
    rpt, col, val = t.host_arrays()
    j = JCSR.from_arrays(rpt, col, val, t.shape, pad_to=t.nnz + pad)
    t = t.with_capacity(t.nnz + pad)
    assert (t.capacity, t.nrows, t.ncols) == (j.capacity, j.nrows, j.ncols)
    _eq(j.nnz_per_row(), t.nnz_per_row())
    assert t.nnz_max() == j.nnz_max()
    _eq(j.valid_mask(), t.valid_mask())
    _eq(j.row_ids(), t.row_ids())
    assert t.row_ids().dtype == torch.int32
    _eq(j.to_dense(), t.to_dense())
    _eq(j.astype(jnp.float32).val, t.astype(np.float32).val)
    assert t.astype(torch.float32).dtype == torch.float32
    jt, tt = j.transpose(), t.transpose()
    _eq(jt.rpt, tt.rpt)
    _eq(np.asarray(jt.col)[: jt.nnz], tt.col)
    _eq(np.asarray(jt.val)[: jt.nnz], tt.val)


def test_with_capacity_pads_and_cuts():
    t, _ = _pair()
    big = t.with_capacity(t.nnz + 100)
    assert big.capacity == t.nnz + 100 and big.nnz == t.nnz
    assert not big.col[t.nnz:].any() and not big.val[t.nnz:].any()
    back = big.with_capacity(0)  # never below nnz
    assert back.capacity == t.nnz
    assert torch.equal(back.col, t.col) and torch.equal(back.val, t.val)
    assert big == t


def test_csr_eq_is_a_bool_and_tolerant():
    t, j = _pair()
    assert (t == t) is True
    same = nt.CSR.from_scipy(t.to_scipy())
    assert (t == same) is True and t is not same
    nudged = t.with_values(t.val * (1 + 1e-12))
    assert t == nudged and j_csr_allclose(j, JCSR.from_scipy(
        nudged.to_scipy()))
    off = t.val.clone()
    off[5] += 1.0
    assert (t == t.with_values(off)) is False
    col = t.col.clone()
    col[0] = (col[0] + 1) % t.shape[1]
    moved = nt.CSR(rpt=t.rpt, col=col, val=t.val, shape=t.shape, nnz=t.nnz)
    assert csr_allclose(t, moved) == j_csr_allclose(
        j, JCSR.from_scipy(moved.to_scipy())) is False
    assert t != t.with_values(off)
    assert (t == "a matrix") is False
    assert hash(t) != hash(same) and len({t, same}) == 2


def test_to_dense_of_every_format_matches_jax():
    t, j = _pair()
    dense = t.to_scipy().toarray()
    rows, cols, vals = sp.find(t.to_scipy())
    tcoo = nt.COO.from_arrays(rows, cols, vals, t.shape, pad_to=t.nnz + 9)
    jcoo = JCOO.from_arrays(rows, cols, vals, t.shape, pad_to=t.nnz + 9)
    _eq(jcoo.valid_mask(), tcoo.valid_mask())
    _eq(jcoo.to_dense(), tcoo.to_dense())
    _eq(JELL.from_csr(j).to_dense(), nt.ELL.from_csr(t).to_dense())
    _eq(JBSR.from_csr(j, (8, 128)).to_dense(),
        nt.BSR.from_csr(t, (8, 128)).to_dense())
    _eq(JBSR.from_csr(j, (16, 16)).to_dense(),
        nt.BSR.from_csr(t, (16, 16)).to_dense())
    s = nt.stencil_csr(9, 7, dtype=np.float64)
    _eq(JDIA.from_csr(JCSR.from_scipy(s.to_scipy())).to_dense(),
        nt.DIA.from_csr(s).to_dense())
    np.testing.assert_array_equal(t.to_dense().numpy(), dense)


def test_ell_to_dense_adds_split_rows():
    t, _ = _pair()
    ell = nt.ELL.from_csr(t, split_width=16)
    assert ell.split_rows is not None
    np.testing.assert_allclose(ell.to_dense().numpy(),
                               t.to_scipy().toarray(), rtol=1e-12, atol=0)


# -- Matrix Market ------------------------------------------------------------


def test_write_mtx_same_text_and_reads_back_both_ways(tmp_path):
    t, j = _pair()
    tp, jp = str(tmp_path / "port.mtx"), str(tmp_path / "jax.mtx")
    nt.write_mtx(tp, t)
    j_write_mtx(jp, j)
    with open(tp) as a, open(jp) as b:
        assert a.read() == b.read()
    back = j_read_mtx(tp)
    _eq(back.rpt, t.rpt)
    _eq(np.asarray(back.col)[: back.nnz], t.col)
    _eq(np.asarray(back.val)[: back.nnz], t.val)
    assert nt.read_mtx(jp) == t and nt.read_mtx(jp).val.equal(t.val)
    t32 = t.astype(np.float32)
    nt.write_mtx(tp, t32)
    j_write_mtx(jp, JCSR.from_scipy(t32.to_scipy()))
    with open(tp) as a, open(jp) as b:
        assert a.read() == b.read()


@pytest.mark.parametrize("name", ["test.mtx", "lshape_laplace.mtx"])
def test_read_mtx_coo_matches_jax(name):
    path = os.path.join(REPO, "data", name)
    j = j_read_mtx_coo(path, pad_to=None)
    t = read_mtx_coo(path)
    assert (t.shape, t.nnz, t.capacity) == (j.shape, j.nnz, j.capacity)
    for f in ("row", "col", "val"):
        _eq(getattr(j, f), getattr(t, f))
    assert nt.CSR.from_coo(t) == nt.read_mtx(path)
    padded = read_mtx_coo(path, dtype=np.float32, pad_to=t.nnz + 5)
    assert padded.capacity == t.nnz + 5


# -- binning, host memory, SuiteSparse ----------------------------------------


def test_binning_matches_jax():
    t, j = _pair(scale=9)
    got = flops_per_row(t, t)
    assert got.dtype == torch.int64 and got.shape == (t.shape[0],)
    _eq(j_flops_per_row(j, j), got)
    assert int(got.sum()) * 2 == nt.spgemm_flops(t, t)
    sizes = got.numpy()
    for min_size, nb in ((32, BIN_NUM), (4, 3), (1, 9)):
        for a, b in zip(j_bin_rows(sizes, min_size, nb),
                        bin_rows(sizes, min_size, nb)):
            np.testing.assert_array_equal(a, b)
            assert b.dtype == np.int32
        for a, b in zip(j_bin_histogram(sizes, min_size, nb),
                        bin_histogram(sizes, min_size, nb)):
            np.testing.assert_array_equal(a, b)


def test_hostmem_matches_jax(monkeypatch):
    assert thm.tune_host_memory() is thm.tune_host_memory()  # idempotent
    for mod in (thm, jhm):
        monkeypatch.setattr(mod, "_done", False)
    monkeypatch.setenv("NSPARSE_THP", "keep")
    assert thm.tune_host_memory() is False is jhm.tune_host_memory()
    monkeypatch.delenv("NSPARSE_THP")
    assert thm.tune_host_memory() == jhm.tune_host_memory()


def _no_network(*args, **kwargs):
    raise OSError("network disabled in tests")


def test_fetch_reads_the_cache_and_never_downloads(tmp_path, monkeypatch):
    monkeypatch.setattr(urllib.request, "urlopen", _no_network)
    t, _ = _pair()
    nt.write_mtx(str(tmp_path / "west0479.mtx"), t)
    got = suitesparse.fetch("HB/west0479", cache_dir=str(tmp_path))
    assert got == t and got.dtype == torch.float64
    assert suitesparse.fetch("HB/west0479", str(tmp_path),
                             dtype=np.float32).dtype == torch.float32
    with pytest.raises(RuntimeError, match="place absent.mtx in"):
        suitesparse.fetch("HB/absent", cache_dir=str(tmp_path / "sub"))
    with pytest.raises(ValueError, match="Group/Name"):
        suitesparse.fetch("west0479", cache_dir=str(tmp_path))
    assert suitesparse._DEFAULT_CACHE.endswith(
        os.path.join(".cache", "nsparse_tpu_torch", "suitesparse"))


# -- timing and profiling -----------------------------------------------------


def test_time_chained_and_marginal_on_cpu():
    a = nt.stencil_csr(16, 16, dtype=np.float64)
    x = torch.ones(a.shape[1], dtype=torch.float64)

    def step(c, i):
        return nt.spmv(a, c) * 0.25

    def step_aux(c, i, aux):
        return nt.spmv(aux, c) * 0.25

    for ms in (time_chained(step, x, iters=4, reps=2),
               time_marginal(step, x, iters_lo=1, iters_hi=4, reps=2),
               time_marginal(step_aux, x, iters_lo=1, iters_hi=3, reps=2,
                             aux=a)):
        assert np.isfinite(ms) and ms >= 0


def test_profile_op_writes_a_trace(tmp_path):
    a = nt.stencil_csr(16, 16, dtype=np.float64)
    x = torch.ones(a.shape[1], dtype=torch.float64)
    out, ms, tdir = profile_op(nt.spmv, a, x, trace_dir=str(tmp_path / "t"),
                               iters=2)
    assert torch.equal(out, nt.spmv(a, x)) and ms > 0
    (trace,) = glob.glob(os.path.join(tdir, "*.json"))
    with open(trace) as f:
        assert json.load(f)["traceEvents"]


# -- device checks ------------------------------------------------------------


def test_ans_check_device_matches_jax():
    rng = np.random.default_rng(1)
    ref = rng.standard_normal(300)
    scale = np.abs(ref) + 1.0
    for dt in (np.float32, np.float64):
        y = ref.astype(dt).copy()
        y[[3, 70]] += 0.5
        got = ans_check_device(torch.from_numpy(y), ref, dtype=dt,
                               scale=scale)
        want = j_ans_check_device(jnp.asarray(y), ref, dtype=dt, scale=scale)
        assert got == (False, 2) == tuple(want)
        assert ans_check_device(torch.from_numpy(ref.astype(dt)), ref) \
            == (True, 0)


def test_check_spgemm_answer_device_passes_and_fails():
    t, _ = _pair()
    c = nt.spgemm(t, t)
    ref, scale = nt.spgemm_oracle(t, t), nt.spgemm_abs_oracle(t, t)
    assert check_spgemm_answer_device(c, ref, abs_ref=scale)
    val = c.val.clone()
    val[4] *= 1.001
    assert not check_spgemm_answer_device(c.with_values(val), ref, scale)
    col = c.col.clone()
    col[2] = (col[2] + 1) % c.shape[1]
    moved = nt.CSR(rpt=c.rpt, col=col, val=c.val, shape=c.shape, nnz=c.nnz)
    assert not check_spgemm_answer_device(moved, ref, scale)
    assert not nt.check_spgemm_answer(moved, ref, abs_ref=scale)
    assert csr_allclose(c, nt.CSR.from_scipy(ref))
    assert not csr_allclose(c.with_values(val), nt.CSR.from_scipy(ref))


# -- the CLI ------------------------------------------------------------------


def _cli(argv, capsys):
    from nsparse_tpu_torch.cli import main

    rc = main(["--precision", "single", *argv, "--device", "cpu"])
    return rc, capsys.readouterr().out


def test_cli_spgemm_plan_cache(tmp_path, capsys):
    argv = ["spgemm", CIRCUIT, "--plan-cache", str(tmp_path), "--trials", "1"]
    rc1, out1 = _cli(argv, capsys)
    rc2, out2 = _cli(argv, capsys)
    assert (rc1, rc2) == (0, 0), out1 + out2
    assert "symbolic (host plan" in out1 and "[cache hit]" not in out1
    assert "[cache hit]" in out2
    assert out1.rstrip().endswith("pass") and out2.rstrip().endswith("pass")
    assert [f for f in os.listdir(tmp_path)] == [
        "spgemm_2bd49ff01d96b918_2bd49ff01d96b918_torch_v2.npz"]


def test_cli_spmv_profile(tmp_path, capsys):
    rc, out = _cli(["spmv", "gen:stencil:32:32", "--format", "dia",
                    "--profile", str(tmp_path), "--trials", "2"], capsys)
    assert rc == 0 and f"trace written to {tmp_path}" in out, out
    assert glob.glob(str(tmp_path / "*.json"))


@pytest.mark.parametrize("cmd,line", [("spmv-xla", "SpMV [torch.sparse_csr"),
                                      ("spgemm-xla",
                                       "SpGEMM [torch.sparse_csr")])
def test_cli_library_yardsticks(cmd, line, capsys):
    rc, out = _cli([cmd, CIRCUIT, "--trials", "2"], capsys)
    assert rc == 0 and line in out and out.rstrip().endswith("pass"), out


def test_cli_spgemm_xla_reports_a_refusal(capsys, monkeypatch):
    def refuse(self, other):
        raise RuntimeError("library refused")

    monkeypatch.setattr(torch.Tensor, "__matmul__", refuse)
    rc, out = _cli(["spgemm-xla", "gen:rmat:6:4", "--trials", "1"], capsys)
    assert rc == 1 and "unsupported on this device (library refused)" in out


@pytest.mark.parametrize("cmd", [["spmv-xla", "gen:stencil:8:8"],
                                 ["spgemm-xla", "gen:rmat:6:4"],
                                 ["spgemm", "gen:rmat:6:4", "--plan-cache",
                                  "unused"],
                                 ["rap", "--devices", "4", "--n", "256"]])
def test_cli_new_commands_refuse_cuda_without_a_card(cmd, monkeypatch):
    from nsparse_tpu_torch.cli import main

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        main(cmd)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        main([*cmd, "--device", "cuda"])


def test_cli_rap_on_the_host(capsys):
    """``rap`` over a virtual mesh of 4 shards on the host: R = P^T, P the
    4:1 aggregation, A the stencil, checked against scipy."""
    rc, out = _cli(["rap", "--devices", "4", "--n", "256"], capsys)
    lines = out.strip().splitlines()
    assert rc == 0, out
    assert lines[0] == "mesh: 4 shards on cpu (virtual mesh)"
    assert "R(64x256) @ A(256x256, nnz=1246) @ P(256x64) over a 4-device " \
        "mesh" in out
    assert "halo R.A.P: nnz(RAP)=" in lines[-1] and "pass" in lines[-1]


# -- exports ------------------------------------------------------------------


@pytest.mark.parametrize("sub", ["", ".formats", ".io", ".ops", ".tune",
                                 ".utils", ".parallel"])
def test_exports_cover_the_jax_package(sub):
    j = importlib.import_module("nsparse_tpu" + sub)
    t = importlib.import_module("nsparse_tpu_torch" + sub)
    assert set(j.__all__) <= set(t.__all__), set(j.__all__) - set(t.__all__)
    for name in t.__all__:
        assert getattr(t, name) is not None
    for name in set(j.__all__) & {"spmv", "spgemm"}:
        assert callable(getattr(t, name))

"""The port's host side against the JAX package: import hygiene, matrix
generators, the host symbolic planner (native and numpy), Matrix Market
reading and the CSR container."""

import os
import subprocess
import sys

import numpy as np
import pytest
import scipy.sparse as sp

from nsparse_tpu.io.generate import rmat_csr as jrmat
from nsparse_tpu.io.generate import stencil_csr as jstencil
from nsparse_tpu.io.matrix_market import read_mtx as j_read_mtx
from nsparse_tpu.native import spgemm_plan_host as j_plan_host

import nsparse_tpu_torch as nt
from nsparse_tpu_torch.io.matrix_market import read_mtx_arrays_numpy
from nsparse_tpu_torch.native import (
    HOST_LIB,
    spgemm_plan_host,
    spgemm_plan_host_numpy,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_import_pulls_in_no_jax():
    code = (
        "import sys, nsparse_tpu_torch, nsparse_tpu_torch.cli, "
        "nsparse_tpu_torch.utils.timing, nsparse_tpu_torch.utils.roofline, "
        "nsparse_tpu_torch.ops.spmv, nsparse_tpu_torch.tune.autotune, "
        "nsparse_tpu_torch.tune.plan, nsparse_tpu_torch.formats.ell, "
        "nsparse_tpu_torch.formats.dia, nsparse_tpu_torch.formats.bsr, "
        "nsparse_tpu_torch.formats.coo, "
        "nsparse_tpu_torch.ops.kernels.flat_gather, "
        "nsparse_tpu_torch.ops.kernels.gather_tiles, "
        "nsparse_tpu_torch.ops.kernels.dia, "
        "nsparse_tpu_torch.ops.kernels.spmv_bsr, "
        "nsparse_tpu_torch.ops.kernels.bsr_blocks, "
        "nsparse_tpu_torch.ops.spgemm_bsr, "
        "nsparse_tpu_torch.tune.spgemm_cache, "
        "nsparse_tpu_torch.utils.profiling, "
        "nsparse_tpu_torch.utils.hostmem, "
        "nsparse_tpu_torch.io.suitesparse, "
        "nsparse_tpu_torch.ops.binning, "
        "nsparse_tpu_torch.parallel, nsparse_tpu_torch.parallel.mesh, "
        "nsparse_tpu_torch.parallel.partition, "
        "nsparse_tpu_torch.parallel.spmv, nsparse_tpu_torch.parallel.halo, "
        "nsparse_tpu_torch.parallel.spgemm, "
        "nsparse_tpu_torch.parallel.spgemm_halo, "
        "nsparse_tpu_torch.parallel.spgemm_window; "
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.') "
        "or m.startswith('nsparse_tpu.') or m == 'nsparse_tpu']; "
        "print(bad); sys.exit(1 if bad else 0)"
    )
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def test_port_names_no_jax_package_path():
    """No file of the port imports the JAX package or builds from its
    directory (its C++ sources are the port's own copies)."""
    import re

    pkg = os.path.join(REPO, "nsparse_tpu_torch")
    imports = re.compile(r"^\s*(from|import)\s+nsparse_tpu(\.|\s|$)", re.M)
    path_literal = re.compile(r"[\"']nsparse_tpu[\"'/]")
    seen = 0
    for root, _, files in os.walk(pkg):
        for f in files:
            if not f.endswith((".py", ".cu", ".cuh", ".cpp")):
                continue
            with open(os.path.join(root, f)) as fh:
                text = fh.read()
            seen += 1
            assert not imports.search(text), f
            assert not path_literal.search(text), f
    assert seen > 20
    for src in ("planner.cpp", "mmio.cpp"):
        with open(os.path.join(pkg, "native", src), "rb") as a, \
                open(os.path.join(REPO, "nsparse_tpu", "native", src),
                     "rb") as b:
            assert a.read() == b.read(), src
    from nsparse_tpu_torch.native import _SRC_DIR

    assert os.path.samefile(_SRC_DIR, os.path.join(pkg, "native"))


def _same_csr(j, t):
    rpt, col, val = j.host_arrays()
    np.testing.assert_array_equal(rpt, t.rpt.numpy())
    np.testing.assert_array_equal(col[: j.nnz], t.col.numpy())
    np.testing.assert_array_equal(val[: j.nnz], t.val.numpy())
    assert (j.shape, j.nnz) == (t.shape, t.nnz)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_generators_match_jax(dtype):
    _same_csr(jrmat(9, edge_factor=8, dtype=dtype, seed=1),
              nt.rmat_csr(9, edge_factor=8, dtype=dtype, seed=1))
    _same_csr(jstencil(12, 9, dtype=dtype), nt.stencil_csr(12, 9, dtype=dtype))


@pytest.mark.parametrize("native", [True, False])
def test_host_planner_matches_jax(native):
    a = nt.rmat_csr(9, edge_factor=6, dtype=np.float64, seed=3)
    rpt, col, _ = a.host_arrays()
    deg = np.diff(rpt).astype(np.int64)
    args = (rpt, col.astype(np.int64), deg, rpt, col, deg, a.shape[0],
            a.shape[1], a.nnz)
    want = j_plan_host(*args)
    if native:
        assert HOST_LIB.get() is not None, "g++ build of planner.cpp failed"
        got = spgemm_plan_host(*args)
    else:
        got = spgemm_plan_host_numpy(*args)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(np.asarray(w), np.asarray(g))


def test_read_mtx_matches_jax():
    for name in ("test.mtx", "lshape_laplace.mtx"):
        path = os.path.join(REPO, "data", name)
        want = j_read_mtx(path)
        _same_csr(want, nt.read_mtx(path))
        rows, cols, vals, shape = read_mtx_arrays_numpy(path)
        _same_csr(want, nt.CSR.from_scipy(
            sp.coo_matrix((vals, (rows, cols)), shape=shape)))


def test_csr_roundtrip_and_devices():
    a = nt.rmat_csr(7, edge_factor=4, dtype=np.float32, seed=0)
    s = a.to_scipy()
    b = nt.CSR.from_scipy(s)
    _same_csr(jrmat(7, edge_factor=4, dtype=np.float32, seed=0), b)
    m = a.to("meta")
    assert m.val.device.type == "meta" and m.nnz == a.nnz
    with pytest.raises(ValueError):
        a.with_values(a.val[:-1])


def test_check_spgemm_answer_rejects_structure_and_values():
    a = nt.rmat_csr(7, edge_factor=4, dtype=np.float64, seed=5)
    ref = nt.spgemm_oracle(a, a)
    c = nt.spgemm(a, a)
    assert nt.check_spgemm_answer(c, ref)
    bad = c.with_values(c.val * (1 + 1e-6))
    assert not nt.check_spgemm_answer(bad, ref)
    other = nt.spgemm_oracle(a, nt.rmat_csr(7, edge_factor=4, seed=6))
    assert not nt.check_spgemm_answer(c, other)

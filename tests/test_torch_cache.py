"""The port's SpGEMM plan cache (``nsparse_tpu_torch/tune/spgemm_cache.py``)
against itself and the JAX package's cache.

- Each layout's plan, saved and loaded, gives C equal (``torch.equal``)
  to the unsaved plan's, and the loaded tree equals the saved one leaf
  for leaf (type, dtype, shape, values): window v2 and v1 (both with a
  fallback pool), global aligned and unaligned (``BANK_ROWS_MAX``
  patched), sort, and the device planner's sort plan.
- Leaf kinds round-trip as what they were (tensors of six dtypes, numpy
  arrays, ints, numpy integer scalars, nested tuples, strings, None); any
  other kind of leaf, or an unregistered dataclass, is refused.
- ``spgemm_plan_cached``: a miss then a hit; build options change the
  key; a version or format mismatch loads as None; the committed JAX plan
  file loads as None and stays byte-identical; a corrupted index table
  raises ValueError on load.
- The fingerprint and options parts of the file name equal the JAX
  package's, and the port's cached plan and the JAX cached plan give the
  same C (structure exactly, values within ``checking.py``'s rtol).
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from nsparse_tpu.formats.csr import CSR as JCSR
from nsparse_tpu.ops.spgemm import spgemm_numeric as j_numeric
from nsparse_tpu.tune.spgemm_cache import plan_cache_path as j_cache_path
from nsparse_tpu.tune.spgemm_cache import spgemm_plan_cached as j_cached

import nsparse_tpu_torch as nt
import nsparse_tpu_torch.ops.spgemm_window as twin
import nsparse_tpu_torch.tune.kernelgen as tkg
import nsparse_tpu_torch.tune.spgemm_cache as sc
from nsparse_tpu_torch.ops.kernels import piecewise as tpw
from nsparse_tpu_torch.utils.checking import ans_check

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_PLAN = os.path.join(
    REPO, "data", "plancache",
    "spgemm_2bd49ff01d96b918_2bd49ff01d96b918_v10.npz")


def _heavy_row(m=600):
    """A matrix whose dense row and column outgrow a two-class window
    ladder (the window plan gets a fallback pool) and make entry (7, 7)
    longer than one 512-product chunk (two slab levels)."""
    rng = np.random.default_rng(11)
    s = sp.random(m, m, density=0.005, random_state=5, format="lil")
    s[7, :] = rng.standard_normal(m)
    s[:, 7] = rng.standard_normal((m, 1))
    return nt.CSR.from_scipy(sp.csr_matrix(s))


def _plan(case, monkeypatch):
    """(A, plan) of one layout case."""
    if case in ("window-v2", "window-v1"):
        monkeypatch.setattr(tkg, "N_WIN_CLASSES", 2)
        if case == "window-v1":
            monkeypatch.setattr(twin, "FUSED_BANK_BUDGET", 0)
        a = _heavy_row()
        plan = nt.spgemm_plan(a, a, shuffle=True, layout="window")
        assert plan.win.fused_expand == (case == "window-v2")
        assert plan.win.fb_shuffle is not None
        assert (plan.win.pw is not None) == (case == "window-v2")
        return a, plan
    if case == "global-unaligned":
        monkeypatch.setattr(tpw, "BANK_ROWS_MAX", 1)
    if case.startswith("global"):
        a = _heavy_row()
        plan = nt.spgemm_plan(a, a, shuffle=True, layout="global")
        assert plan.glob.pw.aligned == (case == "global-aligned")
        assert len(plan.glob.slab_levels) == 2
        return a, plan
    a = nt.rmat_csr(9, edge_factor=8, dtype=np.float64, seed=3)
    if case == "device":
        return a, nt.spgemm_plan_device(a, a)
    plan = nt.spgemm_plan(a, a, shuffle=False)
    assert plan.layout == "sort" and plan.srt.av_gp is not None
    return a, plan


def _assert_same_tree(x, y, where="plan"):
    assert type(x) is type(y), (where, type(x), type(y))
    if isinstance(x, torch.Tensor):
        assert (x.dtype, x.shape, x.device) == (y.dtype, y.shape, y.device), \
            where
        assert torch.equal(x, y), where
    elif isinstance(x, np.ndarray):
        assert (x.dtype, x.shape) == (y.dtype, y.shape), where
        np.testing.assert_array_equal(x, y, err_msg=where)
    elif dataclasses.is_dataclass(x):
        for f in dataclasses.fields(x):
            _assert_same_tree(getattr(x, f.name), getattr(y, f.name),
                              f"{where}.{f.name}")
    elif isinstance(x, (tuple, list)):
        assert len(x) == len(y), where
        for i, (u, v) in enumerate(zip(x, y)):
            _assert_same_tree(u, v, f"{where}[{i}]")
    else:
        assert x == y, where


CASES = ["window-v2", "window-v1", "global-aligned", "global-unaligned",
         "sort", "device"]


@pytest.mark.parametrize("case", CASES)
def test_roundtrip_gives_equal_c(case, tmp_path, monkeypatch):
    a, plan = _plan(case, monkeypatch)
    path = sc.save_spgemm_plan(plan, str(tmp_path / "plan.npz"))
    assert not os.path.exists(path + ".tmp")
    loaded = sc.load_spgemm_plan(path)
    _assert_same_tree(plan, loaded)
    for dtype in (np.float64, np.float32):
        ad = a.astype(dtype)
        want = nt.spgemm_numeric(plan, ad, ad)
        got = nt.spgemm_numeric(loaded, ad, ad)
        assert torch.equal(want.val, got.val)
        assert torch.equal(want.col, got.col)
    assert nt.check_spgemm_answer(got, nt.spgemm_oracle(ad, ad),
                                  abs_ref=nt.spgemm_abs_oracle(ad, ad))


def test_leaf_kinds_roundtrip(tmp_path):
    tree = (
        torch.arange(5, dtype=torch.int32),
        torch.tensor([-1, 3], dtype=torch.int16),
        torch.arange(3, dtype=torch.int64).reshape(3, 1),
        torch.tensor([True, False]),
        torch.tensor([1.5, -2.0], dtype=torch.float32),
        torch.tensor(0.25, dtype=torch.float64),
        np.arange(4, dtype=np.int64),
        7, np.int64(8), np.int32(-9), True, 2.5, "band", None,
        (("win", 1024), ("band", 64)), (1, (2, 3)),
    )
    arrays = {}
    meta = sc._encode(tree, "p", arrays, sc._registry())
    path = str(tmp_path / "leaves.npz")
    np.savez(path, **arrays)
    with np.load(path, allow_pickle=False) as z:
        back = sc._decode(meta, z, sc._registry())
    _assert_same_tree(tree, back, "tree")
    assert type(back[7]) is int and type(back[8]) is np.int64


def test_unregistered_dataclass_and_other_leaves_refused(tmp_path):
    @dataclasses.dataclass
    class Stray:
        x: int

    with pytest.raises(TypeError, match="unregistered"):
        sc.save_spgemm_plan(Stray(1), str(tmp_path / "p.npz"))
    with pytest.raises(TypeError, match="cannot encode"):
        sc.save_spgemm_plan(([1, 2],), str(tmp_path / "p.npz"))
    assert not os.listdir(tmp_path)


def test_cached_miss_then_hit(tmp_path):
    a = nt.stencil_csr(16, 16, dtype=np.float64)
    p1, hit1 = sc.spgemm_plan_cached(a, a, str(tmp_path))
    p2, hit2 = sc.spgemm_plan_cached(a, a, str(tmp_path))
    assert (hit1, hit2) == (False, True)
    _assert_same_tree(p1, p2)
    assert torch.equal(nt.spgemm_numeric(p1, a, a).val,
                       nt.spgemm_numeric(p2, a, a).val)
    assert os.listdir(tmp_path) == [os.path.basename(
        sc.plan_cache_path(str(tmp_path), a, a))]


def test_plan_kwargs_change_the_key(tmp_path):
    a = nt.stencil_csr(12, 12, dtype=np.float64)
    d = str(tmp_path)
    keys = {sc.plan_cache_path(d, a, a),
            sc.plan_cache_path(d, a, a, plan_kwargs={"shuffle": False}),
            sc.plan_cache_path(d, a, a, plan_kwargs={"shuffle": True}),
            sc.plan_cache_path(d, a, a, chip="H100")}
    assert len(keys) == 4
    _, hit = sc.spgemm_plan_cached(a, a, d)
    _, hit_opts = sc.spgemm_plan_cached(a, a, d, shuffle=False)
    assert (hit, hit_opts) == (False, False)


def test_version_or_format_mismatch_loads_none(tmp_path, monkeypatch):
    a = nt.stencil_csr(8, 8, dtype=np.float64)
    path = sc.save_spgemm_plan(nt.spgemm_plan(a, a), str(tmp_path / "p.npz"))
    monkeypatch.setattr(sc, "PLAN_VERSION", sc.PLAN_VERSION + 1)
    assert sc.load_spgemm_plan(path) is None
    monkeypatch.undo()
    monkeypatch.setattr(sc, "PLAN_FORMAT", "another.package")
    assert sc.load_spgemm_plan(path) is None
    assert sc.load_spgemm_plan(str(tmp_path / "missing.npz")) is None


def test_malformed_tree_raises(tmp_path):
    a = nt.stencil_csr(8, 8, dtype=np.float64)
    path = sc.save_spgemm_plan(nt.spgemm_plan(a, a), str(tmp_path / "p.npz"))
    with np.load(path, allow_pickle=False) as z:
        arrays = {k: z[k] for k in z.files}
    meta = json.loads(bytes(arrays["__meta__"]).decode())
    del meta["tree"]["f"]["c_nnz"]
    arrays["__meta__"] = np.frombuffer(json.dumps(meta).encode(), np.uint8)
    np.savez(path, **arrays)
    with pytest.raises(ValueError, match="malformed plan encoding"):
        sc.load_spgemm_plan(path)


def test_jax_plan_file_loads_none_and_stays_put():
    with open(JAX_PLAN, "rb") as f:
        before = f.read()
    listing = sorted(os.listdir(os.path.dirname(JAX_PLAN)))
    assert sc.load_spgemm_plan(JAX_PLAN) is None
    assert sorted(os.listdir(os.path.dirname(JAX_PLAN))) == listing
    with open(JAX_PLAN, "rb") as f:
        assert f.read() == before


def _first(plan_arrays, prefix):
    """The first non-empty npz entry named ``prefix`` or ``prefix.<i>``."""
    for k in sorted(plan_arrays):
        if (k == prefix or k.startswith(prefix + ".")) \
                and plan_arrays[k].size:
            return k
    raise KeyError(prefix)


def _set(value, at=0):
    def fn(x):
        x.reshape(-1)[at] = value
        return x
    return fn


def _bump(x):
    x.reshape(-1)[0] += 1
    return x


# (layout case, npz entry, corruption): index tables the kernels read,
# and derived tables that must equal what their constructor derives
CORRUPT = [
    ("sort", "p.srt.av_gp.ids", _set(10**6)),
    ("sort", "p.srt.bp_rank", _set(10**8)),
    ("sort", "p.srt.uniq_bpos", _set(10**8)),
    ("sort", "p.srt.ends", _set(-5)),
    ("sort", "p.srt.apos", _set(10**8)),
    ("sort", "p.srt.av_gp.units", _bump),
    ("global-aligned", "p.glob.pw.boffs", lambda x: x * 0 + 10**7),
    ("global-aligned", "p.glob.pw.pieces.cls", _bump),
    ("global-aligned", "p.glob.lvl_idx", _set(10**6)),
    ("global-aligned", "p.glob.pw.ids", _set(10**6)),
    ("global-unaligned", "p.glob.pw.boffs", lambda x: x * 0 + 10**7),
    ("window-v2", "p.win.fused.0.pyr_dst", _bump),
    ("window-v2", "p.win.fused.0.esub", _bump),
    ("window-v2", "p.win.fused.0.eboffs", lambda x: x * 0 + 10**6),
    ("window-v2", "p.win.fused.0.tile_idx", _set(10**6)),
    ("window-v2", "p.win.merge.src_off", _set(10**9)),
    ("window-v2", "p.win.fb_lvl_idx", _set(10**6)),
    ("window-v2", "p.win.pw.fb_ids", _set(10**6)),
    ("window-v1", "p.win.expand.b_start", _set(10**8)),
    ("window-v1", "p.win.fused.0.ext_idx", _set(10**6)),
    ("device", "p.srt.out_pos", _set(10**8)),
]


@pytest.mark.parametrize("case,entry,corrupt", CORRUPT,
                         ids=[f"{c}:{e}" for c, e, _ in CORRUPT])
def test_corrupted_index_table_raises(case, entry, corrupt, tmp_path,
                                      monkeypatch):
    _, plan = _plan(case, monkeypatch)
    path = sc.save_spgemm_plan(plan, str(tmp_path / "plan.npz"))
    with np.load(path, allow_pickle=False) as z:
        arrays = {k: z[k] for k in z.files}
    if entry == "p.win.pw.fb_ids" and not arrays.get(entry, np.zeros(0)).size:
        # no run-dense subtile: name one past the arena instead
        arrays[entry] = np.zeros(1, np.int32)
        for k in ("p.win.pw.fb_bidx", "p.win.pw.fb_aidx"):
            arrays[k] = np.zeros(tpw.TILE, np.int32)
    key = _first(arrays, entry)
    arrays[key] = corrupt(arrays[key].copy())
    np.savez(path, **arrays)
    with pytest.raises(ValueError):
        sc.load_spgemm_plan(path)


def test_fingerprint_and_options_match_jax(tmp_path):
    path = os.path.join(REPO, "data", "circuit_zipf.mtx")
    ta = nt.read_mtx(path)
    ja = JCSR.from_scipy(ta.to_scipy())
    d = str(tmp_path)
    for kw in (None, {"shuffle": False}):
        want = os.path.basename(j_cache_path(d, ja, ja, plan_kwargs=kw))
        got = os.path.basename(sc.plan_cache_path(d, ta, ta, plan_kwargs=kw))
        assert want.endswith("_v10.npz")
        assert got.endswith(f"_torch_v{sc.PLAN_VERSION}.npz")
        assert want[: -len("_v10.npz")] == \
            got[: -len(f"_torch_v{sc.PLAN_VERSION}.npz")]
    assert os.path.basename(JAX_PLAN).startswith(
        os.path.basename(sc.plan_cache_path(d, ta, ta)).split("_torch")[0])


def test_port_and_jax_cached_plans_agree(tmp_path):
    """The sort layout (below 2^20 products), both caches in one
    directory: each package reads its own file, and the two Cs agree."""
    ta = nt.stencil_csr(24, 24, dtype=np.float64)
    ja = JCSR.from_scipy(ta.to_scipy())
    d = str(tmp_path)
    jp, jhit = j_cached(ja, ja, d)
    tp, thit = sc.spgemm_plan_cached(ta, ta, d)
    assert (jhit, thit) == (False, False) and tp.layout == "sort"
    assert len(os.listdir(d)) == 2
    jc = j_numeric(jp, ja, ja)
    tp2, hit = sc.spgemm_plan_cached(ta, ta, d)
    assert hit
    tc = nt.spgemm_numeric(tp2, ta, ta)
    jrpt, jcol, jval = jc.host_arrays()
    np.testing.assert_array_equal(jrpt, tc.rpt.numpy())
    np.testing.assert_array_equal(jcol[: jc.nnz], tc.col[: tc.nnz].numpy())
    ok, _ = ans_check(tc.val[: tc.nnz], jval[: jc.nnz], dtype=np.float64)
    assert ok

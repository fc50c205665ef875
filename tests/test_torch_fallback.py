"""K13 (``ops/kernels/fallback.py``): the window numeric's fallback segment
in one launch, held to the slab route it replaces.

The slab route (K1 into the slab, ``spgemm.slab_class_reduce``'s halving
adds, pad, K1 into segment order) is run here from the host plan's slab
tables, with the plain K1; the plain twin must equal it bit for bit at
every entry's slot, and C through the stage must equal C through the
slab route.  Plans: R-MAT at two scales (their own fallback pools, v2
and v1), a dense row and column whose entry (7, 7) takes two slab levels
(a window ladder of two classes), a hub entry of 300,000 products (three
slab levels), and a plan with no fallback row.  A stand-in for the card
(``_Card``) runs the C entry point's contract on CPU tensors, in the
kernel's own order of adds (a thread's leaves in bit-reversed order),
checked against the C signature.
"""

import ctypes
import dataclasses

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import nsparse_tpu_torch as nt
import nsparse_tpu_torch.ops.spgemm_window as sw
import nsparse_tpu_torch.tune.kernelgen as tkg
from nsparse_tpu_torch.ops.kernels import cuda_lib, fallback, shuffle
from nsparse_tpu_torch.ops.kernels.piecewise import expand_from_bank
from nsparse_tpu_torch.ops.spgemm import slab_class_reduce
from nsparse_tpu_torch.tune import spgemm_cache
from nsparse_tpu_torch.utils import profiling


def _heavy_row(m=600):
    """A dense row and column: entry (7, 7) has 600 products (two slab
    levels) once a two-class window ladder sends the row to the pool."""
    rng = np.random.default_rng(11)
    s = sp.random(m, m, density=0.005, random_state=5, format="lil")
    s[7, :] = rng.standard_normal(m)
    s[:, 7] = rng.standard_normal((m, 1))
    return nt.CSR.from_scipy(sp.csr_matrix(s))


def _hub(n=300_000):
    """A = a dense row 0 beside the identity, B = A^T: entry (0, 0) sums
    n products, past 512 chunks (three slab levels)."""
    rng = np.random.default_rng(3)
    rows = np.concatenate([np.zeros(n, np.int64), np.arange(n)])
    cols = np.concatenate([np.arange(n), np.arange(n)])
    s = sp.csr_matrix((rng.standard_normal(rows.size), (rows, cols)),
                      shape=(n, n))
    s.sum_duplicates()
    return nt.CSR.from_scipy(s), nt.CSR.from_scipy(s.T.tocsr())


# name: (A, B or None for A, window classes, the v1 form)
CASES = {
    "rmat12-v2": (lambda: nt.rmat_csr(12, edge_factor=16, seed=5), None,
                  None, False),
    "rmat13-v1": (lambda: nt.rmat_csr(13, edge_factor=8, seed=5), None,
                  None, True),
    "heavy-v2": (_heavy_row, None, 2, False),
    "heavy-v1": (_heavy_row, None, 2, True),
    "hub-v1": (lambda: _hub()[0], lambda: _hub()[1], None, True),
}
_PLANS = {}


def _case(name):
    """(A, B, host plan) of a case, built once per worker."""
    if name not in _PLANS:
        make_a, make_b, classes, v1 = CASES[name]
        saved = tkg.N_WIN_CLASSES, sw.FUSED_BANK_BUDGET
        try:
            if classes:
                tkg.N_WIN_CLASSES = classes
            if v1:
                sw.FUSED_BANK_BUDGET = 0
            a = make_a()
            b = make_b() if make_b else a
            plan = nt.spgemm_plan(a, b, shuffle=True, layout="window")
        finally:
            tkg.N_WIN_CLASSES, sw.FUSED_BANK_BUDGET = saved
        assert plan.win.fused_expand == (not v1)
        assert plan.win.fb is not None
        _PLANS[name] = (a, b, plan)
    return _PLANS[name]


def _values(a, b, dtype, seed=1):
    rng = np.random.default_rng(seed)
    a2 = a.with_values(torch.from_numpy(
        rng.standard_normal(a.nnz).astype(dtype)))
    b2 = a2 if b is a else b.with_values(torch.from_numpy(
        rng.standard_normal(b.nnz).astype(dtype)))
    return a2, b2


def _products(w, a, b):
    """The product arena the plan's fallback stage reads."""
    ops = sw.PLAIN_OPS
    if w.fused_expand:
        bank, _ = sw.v2_delivery(w, a.val, b.val, ops)
        return expand_from_bank(w.pw, a.val, bank, ops.gather, ops.pieces,
                                ops.tiles8, ops.pieces_flat, ops.scatter)
    return ops.expand(w.expand, a.val, b.val)


def _slab_segment(w, prod):
    """The slab route's segment (the stage this kernel replaces)."""
    fb_in = prod[w.fb_off : w.fb_off + w.fb_len]
    res = slab_class_reduce(shuffle.gather_plain(fb_in, w.fb_shuffle.idx),
                            w.fb_levels, w.fb_lvl_idx)
    n = w.merge.n_src - w.n_compact
    res = torch.nn.functional.pad(res, (0, max(n - res.numel(), 0)))
    return shuffle.gather_plain(res, w.fb_perm.idx)


def _entry_slots(w):
    """Which segment slots the merge reads: the fallback entries'."""
    src, lens = w.merge.src_off.long(), w.merge.len.long()
    at = torch.zeros(w.merge.n_src - w.n_compact, dtype=torch.bool)
    for s0, n in zip((src[src >= w.n_compact] - w.n_compact).tolist(),
                     lens[src >= w.n_compact].tolist()):
        at[s0 : s0 + n] = True
    return at


def _bits(t):
    return t.view(torch.int32 if t.dtype == torch.float32 else torch.int64)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("case", list(CASES))
def test_twin_equals_the_slab_route(case, dtype):
    """The plain twin's segment equals the slab route's bit for bit at
    every entry's slot, and holds +0.0 in the gaps."""
    a, b, plan = _case(case)
    a, b = _values(a, b, dtype)
    w = plan.win
    prod = _products(w, a, b)
    res = torch.full((w.merge.n_src,), float("nan"), dtype=a.val.dtype)
    seg = sw.fallback_segment(w, prod, res, sw.PLAIN_OPS)
    assert seg.data_ptr() == res[w.n_compact :].data_ptr()
    at = _entry_slots(w)
    assert int(at.sum()) > 0
    assert torch.equal(_bits(seg[at]), _bits(_slab_segment(w, prod)[at]))
    assert bool((seg[~at] == 0).all())


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("case", ["rmat12-v2", "heavy-v1", "hub-v1"])
def test_numeric_equals_the_slab_route(case, dtype):
    """C through ``spgemm_numeric`` equals C through the slab route (its
    segment copied into the merge buffer behind the class arenas), bit for
    bit, and the oracle."""
    a, b, plan = _case(case)
    a, b = _values(a, b, dtype, seed=2)
    w = plan.win
    c = nt.spgemm_numeric(plan, a, b)
    prod = _products(w, a, b)
    res = sw.merge_buffer(w, a.val)
    if w.fused_expand:
        bank, apv = sw.v2_delivery(w, a.val, b.val, sw.PLAIN_OPS)
        sw.v2_classes(w, bank, apv, res, sw.PLAIN_OPS)
    else:
        for (fp, out), (base, slots, _, _) in zip(sw._class_slices(w, res),
                                                  w.class_geom):
            sw.PLAIN_OPS.fused(fp, prod[base : base + slots], out=out)
    res[w.n_compact :] = _slab_segment(w, prod)
    assert torch.equal(_bits(c.val),
                       _bits(sw.merge_segments(plan, res, sw.PLAIN_OPS)))
    if case != "hub-v1":  # its oracle is a dense 300,000-column row
        assert nt.check_spgemm_answer(c, nt.spgemm_oracle(a, b),
                                      abs_ref=nt.spgemm_abs_oracle(a, b))


def test_plan_without_a_fallback_row():
    a = nt.rmat_csr(9, edge_factor=8, seed=4)
    plan = nt.spgemm_plan(a, a, shuffle=True, layout="window")
    assert plan.win.fb is None and plan.win.fb_shuffle is None
    with profiling.recording():
        profiling.reset()
        c = nt.spgemm_numeric(plan, a, a)
        assert "numeric.window.fallback" not in profiling.snapshot()["spans"]
    assert nt.check_spgemm_answer(c, nt.spgemm_oracle(a, a))


def test_tables_of_the_slab_levels():
    """The level-0 classes keep the slab's widths, member counts and
    slots (pads -1); a long entry is a run of the width-512 members: the
    heavy row's entry (7, 7) one of two chunks, the hub's one past 512
    chunks."""
    for case, nch in (("heavy-v1", [2]), ("hub-v1", [-(-300_000 // 512)])):
        w = _case(case)[2].win
        fb = w.fb
        assert fb.chunks.view(-1, 2)[:, 1].tolist() == nch
        assert [c[:3:2] for c in fb.classes if c[0] > 0] == \
            [tuple(c) for c in w.fb_levels[0]]
        assert fb.src.numel() == sum(L * n for L, n in w.fb_levels[0])
        assert fb.n_products == int((fb.src >= 0).sum())
        keep = fb.src >= 0
        assert torch.equal(fb.src[keep], w.fb_shuffle.idx[: keep.numel()][
            keep])


@pytest.mark.parametrize("case", ["heavy-v2", "rmat13-v1"])
def test_stage_counts_its_entries_and_products(case):
    a, b, plan = _case(case)
    with profiling.recording():
        profiling.reset()
        nt.spgemm_numeric(plan, a, b)
        counters = profiling.snapshot()["counters"]
    fb = plan.win.fb
    assert counters["numeric.window.fallback.entries"] == fb.n_out
    assert counters["numeric.window.fallback.products"] == fb.n_products
    assert fb.n_out == plan.win.merge.n_src - plan.win.n_compact


# -- the tables and their checks --------------------------------------------


def _corrupt(fb, field, edit):
    t = getattr(fb, field).clone()
    edit(t)
    return dataclasses.replace(fb, **{field: t})


CORRUPT = {
    "source-past-the-pool": lambda fb: _corrupt(
        fb, "src", lambda t: t.__setitem__(int((t >= 0).nonzero()[0]),
                                           fb.n_src)),
    "source-below-a-pad": lambda fb: _corrupt(
        fb, "src", lambda t: t.__setitem__(0, -2)),
    "slot-twice": lambda fb: _corrupt(
        fb, "dst", lambda t: t.__setitem__(
            int((t >= 0).nonzero()[1]), int(t[(t >= 0).nonzero()[0]]))),
    "slot-past-the-segment": lambda fb: _corrupt(
        fb, "dst", lambda t: t.__setitem__(int((t >= 0).nonzero()[0]),
                                           fb.n_out)),
    "chunk-past-its-class": lambda fb: _corrupt(
        fb, "chunks", lambda t: t.__setitem__(0, 10**6)),
    "warp-of-no-class": lambda fb: _corrupt(
        fb, "warps", lambda t: t.__setitem__(-2, len(fb.classes))),
    "warp-member-moved": lambda fb: _corrupt(
        fb, "warps", lambda t: t.__setitem__(-1, int(t[-1]) + 32)),
    "long-warps-not-first": lambda fb: dataclasses.replace(
        fb, warps=torch.roll(fb.warps, 2)),
    "product-count": lambda fb: dataclasses.replace(
        fb, n_products=fb.n_products + 1),
}


def test_derived_tables_pass_the_plan_check():
    for case in CASES:
        spgemm_cache.check_plan(_case(case)[2])


@pytest.mark.parametrize("what", list(CORRUPT))
def test_corrupted_tables_are_refused(what):
    plan = _case("heavy-v1")[2]
    bad = dataclasses.replace(
        plan, win=dataclasses.replace(plan.win, fb=CORRUPT[what](plan.win.fb)))
    with pytest.raises(ValueError):
        spgemm_cache.check_plan(bad)


@pytest.mark.parametrize("case", ["heavy-v2", "heavy-v1"])
def test_cached_plan_runs_and_gives_the_same_c(case, tmp_path):
    a, b, plan = _case(case)
    path = spgemm_cache.save_spgemm_plan(plan, str(tmp_path / "p.npz"))
    loaded = spgemm_cache.load_spgemm_plan(path)
    assert spgemm_cache._same(loaded.win.fb, plan.win.fb)
    assert torch.equal(nt.spgemm_numeric(loaded, a, b).val,
                       nt.spgemm_numeric(plan, a, b).val)


def test_plan_of_an_older_format_is_not_loaded(tmp_path, monkeypatch):
    """A file of the version before K13's table loads as None (a miss)."""
    plan = _case("heavy-v1")[2]
    monkeypatch.setattr(spgemm_cache, "PLAN_VERSION",
                        spgemm_cache.PLAN_VERSION - 1)
    path = spgemm_cache.save_spgemm_plan(plan, str(tmp_path / "old.npz"))
    monkeypatch.undo()
    assert spgemm_cache.load_spgemm_plan(path) is None


def test_device_copy_leaves_the_slab_tables_on_the_host():
    w = _case("heavy-v1")[2].win.to("meta")
    assert w.fb.src.device.type == "meta"
    assert w.fb_shuffle.idx.device.type == "cpu"
    assert all(t.device.type == "cpu" for t in w.fb_lvl_idx)
    assert w.fb_perm.idx.device.type == "cpu"


# -- one launch, and the kernel's contract on a stand-in ----------------------


@pytest.fixture(autouse=True)
def _keep_launch_counts():
    saved = fallback.fallback_sum.launches
    yield
    fallback.fallback_sum.launches = saved


@pytest.mark.parametrize("case", ["heavy-v2", "heavy-v1"])
def test_stage_is_one_launch(monkeypatch, case):
    """The whole fallback stage is one K13 launch (v1: nothing else; v2:
    the piece route's K1, K2 and K12 before it), whose arguments match
    the C signature."""
    a, b, plan = _case(case)
    seen = []
    monkeypatch.setattr(cuda_lib, "launch",
                        lambda what, name, *args: seen.append((name, args)))
    w = plan.win.to("meta")
    a_m, b_m = a.to("meta"), b.to("meta")
    res = sw.merge_buffer(w, a_m.val)
    if w.fused_expand:
        bank, _ = sw.v2_delivery(w, a_m.val, b_m.val)
        seen.clear()
        sw.v2_fallback(w, a_m.val, bank, res)
        assert sorted(n for n, _ in seen) == [
            "nsp_expand_pieces", "nsp_fallback_sum", "nsp_gather",
            "nsp_gather_tiles8"]
    else:
        sw.fallback_segment(w, torch.empty(w.expand.n, dtype=a.val.dtype,
                                           device="meta"), res)
        assert [n for n, _ in seen] == ["nsp_fallback_sum"]
    assert fallback.fallback_sum.launches == 1
    (_, args), = [s for s in seen if s[0] == "nsp_fallback_sum"]
    _Card.check_signature("nsp_fallback_sum", args)
    assert args[-1].data_ptr() == res[w.n_compact :].data_ptr()


class _Card:
    """Runs the C entry point's contract on CPU tensors, in the kernel's
    order of adds, and checks the arguments against the C signature."""

    def __init__(self):
        self.calls = []

    @staticmethod
    def check_signature(name, args):
        sig = cuda_lib._SIGNATURES[name][:-1]
        assert len(args) == len(sig), name
        for a, kind in zip(args, sig):
            if kind is cuda_lib._P:
                assert isinstance(a, torch.Tensor) and a.is_contiguous()
                assert a.dtype in (torch.int32, torch.float32,
                                   torch.float64), name
            elif kind is cuda_lib._I64_ARRAY:
                assert isinstance(a, ctypes.Array), name
            else:
                assert type(a) is int, name

    def launch(self, what, name, *args):
        self.check_signature(name, args)
        self.calls.append(name)
        getattr(self, name[len("nsp_"):])(*args)

    @staticmethod
    def fallback_sum(x, src, dst, chunks, warps, n_warps, classes, n_cls,
                     out):
        cls = [tuple(classes[4 * k : 4 * k + 4]) for k in range(n_cls)]
        warps = warps.view(-1, 2)[:n_warps].long()
        dst = dst.long()
        vals = torch.where(src >= 0, x[src.long().clamp(min=0)], 0)

        def slots(width, s0, cnt, m):
            t = torch.arange(width)
            return vals[s0 + t[None, :] * cnt + m[:, None]]

        def pairwise(m):  # adjacent leaves first: a thread's order
            while m.shape[1] > 1:
                m = m[:, 0::2] + m[:, 1::2]
            return m[:, 0]

        def halving(m):  # registers, then shuffles: a warp's order
            while m.shape[1] > 1:
                h = m.shape[1] // 2
                m = m[:, :h] + m[:, h:]
            return m[:, 0]

        def padded(v, width):
            return torch.cat([v, v.new_zeros(width - v.numel())])[None, :]

        w512 = [c for c in cls if c[0] == fallback.CHUNK]
        for k, (width, s0, cnt, m0) in enumerate(cls):
            first = warps[warps[:, 0] == k, 1]
            if width == fallback.LONG:
                for e in first[:: fallback.BLOCK_WARPS].tolist():
                    c0, nch = chunks.view(-1, 2)[e].tolist()
                    _, s512, cnt512, _ = w512[0]
                    cs = halving(slots(512, s512, cnt512,
                                       torch.arange(c0, c0 + nch)))
                    if nch > 512:
                        g = [halving(padded(cs[i : i + 512], 512))
                             for i in range(0, nch, 512)]
                        cs = torch.cat(g)
                    top = 1 << max(cs.numel() - 1, 0).bit_length()
                    out[dst[m0 + e]] = halving(padded(cs, top))[0]
                continue
            if width > fallback.THREAD_MAX:
                m = first
                out[dst[m0 + m]] = halving(slots(width, s0, cnt, m))
                continue
            m = (first[:, None] + torch.arange(32)).reshape(-1)
            j = dst[m0 + m]
            if width == fallback.GAP:
                out[j[j >= 0]] = 0
                continue
            log = width.bit_length() - 1
            rev = [int(format(r, f"0{log}b")[::-1], 2) if log else 0
                   for r in range(width)]
            sums = pairwise(slots(width, s0, cnt, m)[:, rev])
            out[j[j >= 0]] = sums[j >= 0]


@pytest.fixture
def card(monkeypatch):
    c = _Card()
    monkeypatch.setattr(cuda_lib, "validate",
                        lambda what, *args: (0, None, list(args)))
    monkeypatch.setattr(cuda_lib, "launch", c.launch)
    return c


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("case", list(CASES))
def test_kernel_contract_equals_the_twin(card, case, dtype):
    """The kernel's sums (a thread's leaves in bit-reversed pairwise
    order, a warp's halving, a long entry's chunk trees) on the stand-in
    equal the plain twin's bit for bit, on every slot of the segment."""
    a, b, plan = _case(case)
    a, b = _values(a, b, dtype, seed=3)
    w = plan.win
    prod = _products(w, a, b)[w.fb_off : w.fb_off + w.fb_len]
    fb = w.fb
    got = fallback._launch(fb, prod, torch.full((fb.n_out,), float("nan"),
                                                dtype=prod.dtype))
    assert card.calls == ["nsp_fallback_sum"]
    assert torch.equal(_bits(got), _bits(fallback.fallback_sum_plain(fb,
                                                                     prod)))


def test_wrapper_refuses_a_non_cuda_device(monkeypatch):
    """Off the CPU the wrapper launches on a card or raises, before the
    kernel library is touched; no launch is counted."""
    def refuse():
        pytest.fail("the kernel library was touched before the checks")

    monkeypatch.setattr(cuda_lib.KERNELS, "get", refuse)
    monkeypatch.setattr(cuda_lib, "_RESOLVED", {})
    fb = _case("heavy-v1")[2].win.fb.to("meta")
    before = fallback.fallback_sum.launches
    with pytest.raises(ValueError, match="must be on one CUDA device"):
        fallback.fallback_sum(fb, torch.zeros(fb.n_src, device="meta"))
    with pytest.raises(ValueError, match="products for a pool"):
        fallback.fallback_sum(fb, torch.zeros(fb.n_src - 1))
    assert fallback.fallback_sum.launches == before

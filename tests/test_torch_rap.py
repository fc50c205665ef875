"""``rap(r, a, p)``, the Galerkin product R·(A·P) on one device, and the
DIA SpMV of HPCG's 27-point operator, on the CPU, against the plain
float64 model in ``plain_hpcg.py``.

On the CPU both products take the device planner (as ``spgemm`` does);
the hash path they take on a card is run here through the stand-in for
the card of ``test_torch_spgemm_hash.py`` (``_Card``), for its host
reads and rows by route.  ``chip_smoke.py``'s ``hash_phase`` runs the
Galerkin product on the card.

Tolerances: an entry of R·(A·P) is a sum over at most 27 fine points of
sums over at most 27 neighbours; summed in floating point it errs by at
most about (27 + 27 + 3) u of |R||A||P| (u the unit roundoff; the 3 for
the inputs' own rounding to the dtype), so the limit is 64 u of that
scale; for random shapes, the two inner dimensions take the 27s' place.
A DIA row sums 27 terms: 32 u of |A||x|.
"""

import importlib

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import nsparse_tpu_torch as nt
import plain_hpcg as ph
from nsparse_tpu_torch.ops.binning import flops_per_row
from nsparse_tpu_torch.ops.kernels import spgemm_hash as sh
from nsparse_tpu_torch.parallel import make_mesh, rap_dist
from nsparse_tpu_torch.utils import profiling

DTYPES = (torch.float32, torch.float64)
# the module (``nsparse_tpu_torch.ops`` exports its function ``spgemm``)
tspg = importlib.import_module("nsparse_tpu_torch.ops.spgemm")


@pytest.fixture(autouse=True)
def _fresh_recorder():
    profiling.reset()
    yield
    profiling.reset()


def unit(dtype) -> float:
    return torch.finfo(dtype).eps / 2


def csr(dense: torch.Tensor, dtype) -> nt.CSR:
    return nt.CSR.from_dense(dense.to(dtype))


def level(n: int, seed: int, dtype):
    """(R, A, P) of one level of the hierarchy on an n³ grid, as the
    port's CSR in ``dtype``, and the dense float64 model of each."""
    a = ph.operator(n, seed)
    p = ph.interpolation(n)
    dense = (p.T.contiguous(), a, p)
    return tuple(csr(m, dtype) for m in dense), dense


def assert_product(c: nt.CSR, dense, dtype, terms: int):
    """C's structure is the model's pattern exactly; its values lie within
    (terms + 3) u of |R||A||P| of the float64 product."""
    value, scale, pattern = ph.galerkin(*dense)
    want = sp.csr_matrix(pattern.numpy())
    assert c.shape == tuple(pattern.shape)
    assert c.val.dtype == dtype
    assert torch.equal(c.rpt, torch.from_numpy(want.indptr).int())
    assert torch.equal(c.col[: c.nnz], torch.from_numpy(want.indices).int())
    rows = torch.repeat_interleave(torch.arange(c.shape[0]),
                                   c.rpt.long().diff())
    cols = c.col[: c.nnz].long()
    err = (c.val[: c.nnz].double() - value[rows, cols]).abs()
    limit = (terms + 3) * unit(dtype) * scale[rows, cols]
    assert bool((err <= limit).all()), float((err / scale[rows, cols]).max())


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("n", [4, 6, 8])
def test_rap_is_the_galerkin_product(n, dtype):
    """One level of HPCG's hierarchy with seeded coefficients: the coarse
    operator's structure exact, its values within 64 u of |R||A||P|."""
    (r, a, p), dense = level(n, 100 + n, dtype)
    c = nt.rap(r, a, p)
    assert_product(c, dense, dtype, 61)
    nc = (n + 1) // 2
    # the coarse operator is again a 27-point pattern
    assert c.nnz == (3 * nc - 2) ** 3


def test_rap_chains_the_hierarchy():
    """The output of one ``rap`` is the next level's operand: 8³ → 4³ →
    2³ → 1³ in float64, each level against the model's product of the
    previous model level."""
    a = nt.CSR.from_dense(ph.operator(8, 7))
    a_dense = ph.operator(8, 7)
    for n in (8, 4, 2):
        p_dense = ph.interpolation(n)
        p = csr(p_dense, torch.float64)
        r = csr(p_dense.T.contiguous(), torch.float64)
        a = nt.rap(r, a, p)
        assert_product(a, (p_dense.T, a_dense, p_dense), torch.float64, 61)
        a_dense = ph.galerkin(p_dense.T, a_dense, p_dense)[0]
    assert a.shape == (1, 1) and a.nnz == 1


def _random(shape, density, seed):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(sp.random(
        *shape, density=density, random_state=rng,
        data_rvs=rng.standard_normal).toarray())


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("k, m, n, l, density", [
    (7, 23, 17, 11, 0.2), (40, 64, 90, 30, 0.05), (1, 9, 5, 3, 0.5)])
def test_rap_on_random_rectangular_triples(k, m, n, l, density, dtype):
    """R (k×m), A (m×n), P (n×l) of random patterns and values: C is the
    model's product (sums of at most n, then m, terms)."""
    seed = k * 1000 + m
    dense = (_random((k, m), density, seed), _random((m, n), density,
                                                     seed + 1),
             _random((n, l), density, seed + 2))
    c = nt.rap(*(csr(x, dtype) for x in dense))
    assert_product(c, dense, dtype, m + n)


@pytest.mark.parametrize("what", ["shape", "dtype", "int", "device"])
def test_rap_refuses_what_it_cannot_multiply(what):
    (r, a, p), _ = level(4, 1, torch.float64)
    if what == "shape":
        r, p = p, r
        err, match = ValueError, "shape mismatch"
    elif what == "dtype":
        a = a.with_values(a.val.float())
        err, match = TypeError, "one dtype"
    elif what == "int":
        r, a, p = (m.with_values(m.val.int()) for m in (r, a, p))
        err, match = TypeError, "float32 or float64"
    else:
        p = p.to("meta")
        err, match = ValueError, "different devices"
    with profiling.recording():
        with pytest.raises(err, match=match):
            nt.rap(r, a, p)
    # refused before either product
    assert "rap.ap" not in profiling.snapshot()["spans"]


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_rap_equals_rap_dist_on_one_shard(dtype):
    """``rap`` and ``parallel.rap_dist`` on a mesh of one CPU shard give
    the same C: the structure equal, the values within 64 u of
    |R||A||P| of each other."""
    (r, a, p), dense = level(6, 3, dtype)
    c = nt.rap(r, a, p)
    d = rap_dist(r, a, p, make_mesh(1, device="cpu"))
    assert (c.shape, c.nnz) == (d.shape, d.nnz)
    assert torch.equal(c.rpt, d.rpt.to(c.rpt.device))
    assert torch.equal(c.col[: c.nnz], d.col[: d.nnz])
    scale = ph.galerkin(*dense)[1]
    rows = torch.repeat_interleave(torch.arange(c.shape[0]),
                                   c.rpt.long().diff())
    s = scale[rows, c.col[: c.nnz].long()]
    gap = (c.val[: c.nnz].double() - d.val[: d.nnz].double()).abs()
    assert bool((gap <= 64 * unit(dtype) * s).all())


def test_rap_records_its_spans_and_no_read_of_its_own():
    """Under ``recording()``: one ``rap`` span holding ``rap.ap`` and
    ``rap.rap`` (each one ``spgemm``), the counter ``rap.ap_nnz`` equal to
    nnz(A·P), and the host reads of the two products alone."""
    (r, a, p), _ = level(4, 2, torch.float64)
    with profiling.recording():
        ap = nt.spgemm(a, p)
        nt.spgemm(r, ap)
        alone = profiling.snapshot()["counters"]["sync"]
    profiling.reset()
    with profiling.recording():
        nt.rap(r, a, p)
    snap = profiling.snapshot()
    spans = snap["spans"]
    assert {n: spans[n]["count"] for n in ("rap", "rap.ap", "rap.rap",
                                           "spgemm")} == \
        {"rap": 1, "rap.ap": 1, "rap.rap": 1, "spgemm": 2}
    assert spans["rap"]["total_s"] >= spans["rap.ap"]["total_s"] + \
        spans["rap.rap"]["total_s"]
    assert spans["rap.ap"]["self_s"] < spans["rap.ap"]["total_s"]
    assert snap["counters"]["rap.ap_nnz"] == ap.nnz
    assert snap["counters"]["sync"] == alone


def _hash_spgemm(a, b):
    with profiling.span("spgemm"):
        return sh.spgemm_hash(a, b)


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_rap_through_the_hash_path_bins_a_galerkin_product(
        monkeypatch, dtype):
    """An 8³ Galerkin product through the hash pipeline (the card's
    entry points run by ``_Card`` on the CPU): four host reads, two a
    product; A·P's rows (at most 27 × 8 products) and R·(A·P)'s (64 to
    343) take the pwarp and warp routes in the symbolic phase, every row
    of both takes pwarp in the numeric phase (8 to 27 entries); the rows
    by route are the host's binning (``route_of``) of the sizes, and C
    is the device planner's."""
    from test_torch_spgemm_hash import _Card

    card = _Card()
    monkeypatch.setattr(sh.cuda_lib, "validate",
                        lambda what, *args: (0, None, list(args)))
    monkeypatch.setattr(sh.cuda_lib, "launch", card.launch)
    monkeypatch.setattr(tspg, "spgemm", _hash_spgemm)
    (r, a, p), dense = level(8, 5, dtype)
    with profiling.recording():
        c = tspg.rap(r, a, p)
    snap = profiling.snapshot()
    counters = snap["counters"]
    assert counters["sync"] == 4
    assert snap["spans"]["spgemm.hash.numeric"]["count"] == 2
    monkeypatch.undo()
    ap = nt.spgemm(a, p)
    assert counters["rap.ap_nnz"] == ap.nnz
    assert_product(c, dense, dtype, 61)
    used = {"symbolic": set(), "numeric": set()}
    want = {}
    for x, y, z in ((a, p, ap), (r, ap, c)):
        sizes = {"symbolic": flops_per_row(x, y).clamp(max=y.shape[1]),
                 "numeric": z.rpt.long().diff()}
        for phase in sh.PHASES:
            routes = sh.hash_routes(phase, y.shape[1], x.val.element_size())
            bins = sh.route_of(sizes[phase].numpy(), routes)
            for k, route in enumerate(routes):
                rows = int((bins == k).sum())
                key = f"spgemm_hash.rows.{phase}.{route.name}"
                want[key] = want.get(key, 0) + rows
                if rows:
                    used[phase].add(route.name)
    assert used == {"symbolic": {"pwarp", "warp"}, "numeric": {"pwarp"}}
    assert {k: v for k, v in want.items() if v} == {
        k: v for k, v in counters.items()
        if k.startswith("spgemm_hash.rows.") and v}


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("n", [6, 8])
def test_dia_from_diagonals(n, dtype):
    """The DIA a stencil code builds from its diagonals (the port's
    ``DIA`` type, values padded to 128 rows) equals ``DIA.from_csr`` of
    the operator, and its SpMV (K7's plain version on the CPU) is the
    model's shifted sums within 32 u of |A||x|."""
    size = n ** 3
    mp = -(-size // 128) * 128
    offsets, vals = ph.diagonals(n, ph.operator(n, 11))
    padded = torch.zeros(len(offsets), mp, dtype=dtype)
    padded[:, :size] = vals.to(dtype)
    dia = nt.DIA(vals=padded, offsets=offsets, shape=(size, size),
                 nnz=int((vals != 0).sum()),
                 off_t=torch.tensor(offsets, dtype=torch.int32))
    ref = nt.DIA.from_csr(csr(ph.operator(n, 11), dtype))
    assert dia.offsets == ref.offsets and dia.shape == ref.shape
    assert dia.nnz == ref.nnz == (3 * n - 2) ** 3
    assert torch.equal(dia.vals, ref.vals)
    assert torch.equal(dia.off_t, ref.off_t)
    x = torch.randn(size, generator=torch.Generator().manual_seed(n),
                    dtype=torch.float64).to(dtype)
    y = nt.spmv(dia, x)
    want, scale = ph.dia_spmv(offsets, vals, x)
    assert y.dtype == dtype and y.shape == (size,)
    assert bool(((y.double() - want).abs() <= 32 * unit(dtype) * scale)
                .all())
    dense = ph.operator(n, 11) @ x.double()
    assert torch.allclose(want, dense, rtol=0, atol=1e-12 * float(
        scale.max()))

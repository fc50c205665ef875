"""The yardstick's arithmetic on hand-worked small cases (CPU)."""

import types

import pytest
import torch

import harness
import reference
import yardstick

import nsparse_tpu_torch as nt


def csr(rows):
    """A reference.Csr from a dense list of rows."""
    d = torch.tensor(rows, dtype=torch.float32)
    nz = d.nonzero()
    rpt = torch.zeros(d.shape[0] + 1, dtype=torch.int32)
    rpt[1:] = torch.bincount(nz[:, 0], minlength=d.shape[0]).cumsum(0)
    return reference.Csr(rpt=rpt, col=nz[:, 1].int(), val=d[nz[:, 0], nz[:, 1]],
                         shape=tuple(d.shape))


def test_spgemm_least_work_by_hand():
    a = csr([[1, 1], [1, 1]])  # P = 8 products into nnz(C) = 4 entries
    assert reference.spgemm_symbolic(a, a) == (8, 4)
    # A and B: 4 values and 4 columns of 4 bytes, 3 row pointers: 44 B each
    assert yardstick.spgemm_work((2, 2), 4, (2, 2), 4, 4, 8, 4,
                                 structure=False) == (16, 44 + 44 + 16)
    # one-shot: C's columns and row pointers are written too
    assert yardstick.spgemm_work((2, 2), 4, (2, 2), 4, 4, 8, 4,
                                 structure=True) == (16, 44 + 44 + 44)


def test_spmv_least_work_by_hand():
    a = csr([[1, 2, 0], [0, 0, 3], [4, 0, 0]])
    # 4 entries (32 B), 4 row pointers (16 B), x and y (24 B)
    assert yardstick.spmv_work(a.shape, a.nnz, 4) == (8, 72)
    assert yardstick.spmv_work(a.shape, a.nnz, 8) == (8, 4 * 12 + 16 + 48)


def test_same_count_for_csr_and_ell():
    """The count takes the CSR's sizes, so a format's padding never moves
    it."""
    import scipy.sparse as sp

    m = sp.random(300, 300, density=0.02, random_state=1, format="csr",
                  dtype="float32")
    a = nt.CSR.from_scipy(m)
    ell = nt.ELL.from_csr(a, min_width=2, max_slabs=4, sigma=64)
    assert ell.padded_nnz > a.nnz
    assert yardstick.spmv_work(ell.shape, ell.nnz, 4) == \
        yardstick.spmv_work(a.shape, a.nnz, 4)


def test_least_seconds_takes_the_larger_bound():
    assert yardstick.least_seconds(2, 3.35e12, 4) == pytest.approx(1.0)
    assert yardstick.least_seconds(67e12, 1, 4) == pytest.approx(1.0)
    assert yardstick.least_seconds(34e12, 1, 8) == pytest.approx(1.0)


def test_union_and_idle_of_synthetic_intervals():
    iv = [(0.0, 1.0), (0.5, 2.0), (3.0, 4.0)]
    assert yardstick.union_seconds(iv, 0.0, 5.0) == pytest.approx(3.0)
    assert yardstick.union_seconds(iv, 0.75, 3.5) == pytest.approx(1.75)
    assert yardstick.idle_gaps(iv, 0.0, 5.0) == [(2.0, 3.0), (4.0, 5.0)]


def test_trace_summary_and_readers():
    ops = [(0.0, 1.0, "k1"), (0.5, 2.0, "k2"), (3.0, 4.0, "Memcpy HtoD")]
    spans = [(0.0, 2.5, "call"), (2.5, 5.0, "sync")]
    s = harness.trace_summary(ops, spans)
    assert (s.window_s, s.busy_s, s.kernels) == (5.0, 3.0, 2)
    assert s.breakdown["device_ops"][0] == ["k2", 1.5]
    assert s.breakdown["idle_gaps"][0] == ["sync (all gaps)", 2.0]
    # enqueue_ms reads the untraced window's calls, the rest the traced one
    run = types.SimpleNamespace(calls=[(0, 0.25), (1, 0.75)],
                                untraced=[(0, 0.001), (1, 0.003), (0, 0.002)],
                                window_s=4.0, ops=8e9, least_s=0.3,
                                prep_s=None, setup_s=1.0, trace=s)
    read = {m: harness.load("metrics", m).read(run) for m in (
        "gflops", "prep_s", "enqueue_ms", "launches_per_call",
        "kernel_roofline", "device_idle_pct")}
    assert read == pytest.approx({
        "gflops": 2.0, "prep_s": None, "enqueue_ms": 2.0,
        "launches_per_call": 1.0, "kernel_roofline": 10.0,
        "device_idle_pct": 40.0})
    run.trace = None
    assert harness.load("metrics", "kernel_roofline").read(run) is None
    # a quantity split by cells reads through its quantity's reader
    assert harness.reader("gflops.reuse").read(run) == pytest.approx(2.0)


def test_reference_by_hand():
    a = csr([[1, 2], [0, 3]])
    key, val, scale = reference.spgemm_ref(a, a)
    assert key.tolist() == [0, 1, 3]  # row * 2 + column
    assert val.tolist() == [1.0, 8.0, 9.0]
    y, _ = reference.spmv_ref(a, torch.tensor([1.0, -1.0]), "plus_times")
    assert y.tolist() == [-1.0, -3.0]
    y, _ = reference.spmv_ref(a, torch.tensor([1.0, float("inf")]),
                              "min_plus")
    assert y.tolist() == [2.0, float("inf")]


def test_tf32_rounds_to_ten_mantissa_bits():
    x = torch.tensor([1.0 + 2 ** -11, 1.0 + 2 ** -12, -3.0 - 2 ** -9,
                      float("inf")])
    assert reference.tf32(x).tolist() == [1.0 + 2 ** -10, 1.0,
                                          -3.0 - 2 ** -9, float("inf")]

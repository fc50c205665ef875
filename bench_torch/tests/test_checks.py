"""What decides ``correct``, driven through whole runs on the CPU at a
small scale (graph scale 8): the program passes; the control (the
reference in TF32, in the program's place) fails; and a run with the
timed path broken underneath fails, once for each fault a cell can have.
The same control runs on the card at each cell's own size through
``readings.py``."""

import dataclasses

import pytest
import torch

import readings

import nsparse_tpu_torch as nt

# (configuration, traffic mix) of each cell, by file; sssp's mix is run
# here though BENCHMARK.json leaves its cell out
CELLS = (("g500-s13", "spgemm-reuse"), ("g500-s21", "spmv"),
         ("g500-s15", "spgemm-oneshot"), ("g500-s21", "sssp"))
SCALE, SECONDS = 8, 0.2


def runs(cell, seeds=(), control_seeds=()):
    cfg, traffic = readings.read_files(*cell)
    return list(readings.readings(dict(cfg, scale=SCALE), traffic,
                                  list(seeds), list(control_seeds), SECONDS,
                                  "cpu"))


def entry(cell):
    """The program's function the mix's entry calls."""
    return {"spgemm_numeric": "spgemm_numeric", "spgemm": "spgemm",
            "spmv": "spmv"}[readings.read_files(*cell)[1]["entry"]]


@pytest.mark.parametrize("cell", CELLS, ids=[t for _, t in CELLS])
def test_program_passes_and_control_fails(cell):
    lines = runs(cell, seeds=(3_000_000_011,),
                 control_seeds=(3_000_000_021, 5))
    assert [ln["correct"] for ln in lines] == [True, False, False]


def _values(out):
    return out.val if isinstance(out, nt.CSR) else out


def _with_values(out, val):
    return dataclasses.replace(out, val=val) if isinstance(out, nt.CSR) \
        else val


def stale(fn):
    """A step that returns its state unchanged: each call hands back the
    previous call's answer."""
    last = []

    def f(*a, **k):
        out = fn(*a, **k)
        last.append(out)
        return last[-2] if len(last) > 1 else out
    return f


def half(fn):
    """Half of the batch left out: the second half of the rows is never
    computed (their values are 0)."""
    def f(*a, **k):
        out = fn(*a, **k)
        if isinstance(out, nt.CSR):
            v = out.val.clone()
            v[int(out.rpt[out.shape[0] // 2]):] = 0
            return _with_values(out, v)
        v = out.clone()
        v[v.numel() // 2:] = 0
        return v
    return f


def altered(fn):
    """An answer altered where it is produced: one finite value moved by a
    thousandth of its size."""
    def f(*a, **k):
        out = fn(*a, **k)
        v = _values(out).clone()
        i = int(torch.isfinite(v).nonzero()[len(v) // 3])
        v[i] += 1e-3 * max(abs(float(v[i])), 1.0)
        return _with_values(out, v)
    return f


def moved_entry(fn):
    """C's structure altered where it is produced: one entry's column
    moved to the next column."""
    def f(*a, **k):
        out = fn(*a, **k)
        col = out.col.clone()
        i = out.nnz // 2
        col[i] = (col[i] + 1) % out.shape[1]
        return dataclasses.replace(out, col=col)
    return f


FAULTS = [(c, f) for c in CELLS for f in (stale, half, altered)] + [
    (c, moved_entry) for c in CELLS if "spgemm" in c[1]]


@pytest.mark.parametrize("cell,fault", FAULTS,
                         ids=[f"{c[1]}-{f.__name__}" for c, f in FAULTS])
def test_a_broken_timed_path_is_not_correct(cell, fault, monkeypatch):
    name = entry(cell)
    monkeypatch.setattr(nt, name, fault(getattr(nt, name)))
    assert [ln["correct"] for ln in runs(cell, seeds=(3_000_000_031,))
            ] == [False]

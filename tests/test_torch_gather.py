"""The port's planned gather (K5 gather_subset, K6 scatter_tiles and
flat_gather) and windowed gather (K10) against the JAX package.

The same numpy inputs go through the JAX function and through the port's
wrappers on CPU tensors, which run the kernels' plain PyTorch versions.
Gather plans must be equal array for array, and moved values bit for bit:
the JAX Pallas kernels run in interpret mode (``FORCE_PALLAS``, as the
JAX package's own kernel tests run them), so their class routing, sentinel
handling and fallback patching are what the port is held to.  The CUDA
kernels are held against the same plain versions on the card by
``chip_smoke.py``.
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from nsparse_tpu.ops.kernels import flat_gather as jfg
from nsparse_tpu.ops.kernels.gather_pallas import scatter_tiles as j_scatter
from nsparse_tpu.ops.kernels.gather_pallas import (
    windowed_gather as j_windowed_gather,
)

import nsparse_tpu_torch as nt
from nsparse_tpu_torch.ops.kernels import cuda_lib, gather_tiles
from nsparse_tpu_torch.ops.kernels import flat_gather as tfg

DTYPES = [np.float32, np.float64]


def _indices(rng, s, classes):
    """Indices whose supertiles route to ``classes``, in order: "band1",
    "band16", "band128", "win128", "win1024" (16384 slots each: one band
    supertile, or two window supertiles), "fallback" (a wild supertile)
    and "sentinel" (a band supertile, half of it -1)."""
    parts = []
    for c in classes:
        if c.startswith("band"):
            d = int(c[4:])
            n = 16384
            parts.append(np.arange(n) + rng.integers(0, d, n) + 7)
        elif c.startswith("win"):
            w = int(c[3:])
            n = 16384
            base = np.repeat(rng.integers(0, s // 2048, n // 1024) * 2048,
                             1024)
            parts.append(base + rng.integers(0, w - 8, n))
        elif c == "fallback":
            parts.append(rng.integers(0, s, 16384))
        elif c == "sentinel":
            band = np.arange(16384) + 3
            band[rng.random(16384) < 0.5] = -1
            parts.append(band)
    return np.minimum(np.concatenate(parts), s - 1).astype(np.int32)


def _same_plan(j, t):
    np.testing.assert_array_equal(np.asarray(j.idx2d), t.idx2d.numpy())
    assert len(j.ids) == len(t.ids) == len(j.classes)
    for a, b in zip(j.ids, t.ids):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    for a, b in zip(j.bases, t.bases):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    np.testing.assert_array_equal(np.asarray(j.fb_ids), t.fb_ids.numpy())
    assert j.classes == t.classes and j.n == t.n
    assert j.class_fracs == t.class_fracs


@pytest.mark.parametrize("classes", [
    ("band1", "band16", "band128", "win128", "win1024", "fallback",
     "sentinel"),
    ("sentinel", "win1024", "fallback", "band16"),
    ("fallback",),
])
def test_flat_gather_plan_matches_jax(classes):
    rng = np.random.default_rng(len(classes))
    idx = _indices(rng, 200000, classes)
    idx = idx[: idx.size - 1000]  # a ragged tail
    _same_plan(jfg.build_flat_gather_plan(idx),
               tfg.build_flat_gather_plan(idx))


def test_flat_gather_plan_routes_every_class():
    rng = np.random.default_rng(0)
    idx = _indices(rng, 200000, ("band1", "band16", "band128", "win128",
                                 "win1024", "fallback"))
    fr = tfg.build_flat_gather_plan(idx).class_fracs
    assert all(fr[k] > 0 for k in fr), fr


def test_flat_gather_plan_from_jax_arrays():
    """``FlatGatherPlan.from_numpy`` on a JAX plan's arrays gives the plan
    the port builds itself, derived fallback tables included."""
    rng = np.random.default_rng(3)
    idx = _indices(rng, 100000, ("band16", "fallback", "win128"))
    j = jfg.build_flat_gather_plan(idx)
    got = tfg.FlatGatherPlan.from_numpy(
        np.asarray(j.idx2d), [np.asarray(i) for i in j.ids],
        [np.asarray(b) for b in j.bases], np.asarray(j.fb_ids), j.classes,
        j.n)
    want = tfg.build_flat_gather_plan(idx)
    _same_plan(j, got)
    np.testing.assert_array_equal(got.fb_idx.numpy(), want.fb_idx.numpy())
    np.testing.assert_array_equal(got.fb_pos.numpy(), want.fb_pos.numpy())


def test_flat_gather_plan_keeps_bases_on_the_host():
    """No kernel reads the per-unit bases, so ``to()`` leaves them on the
    host, also inside an ELL (``meta`` stands in for the card)."""
    rng = np.random.default_rng(5)
    plan = tfg.build_flat_gather_plan(
        _indices(rng, 100000, ("band16", "win128", "fallback")))
    moved = plan.to("meta")
    assert moved.idx2d.device.type == moved.fb_idx.device.type == "meta"
    assert all(i.device.type == "meta" for i in moved.ids)
    assert [b.device.type for b in moved.bases] == ["cpu"] * len(plan.bases)
    ell = nt.ELL.from_csr(nt.stencil_csr(16, 16), sigma=0).to("meta")
    assert ell.vals[0].device.type == ell.pos_gp.idx2d.device.type == "meta"
    assert all(b.device.type == "cpu" for gp in (ell.pos_gp, *ell.cols_gp)
               for b in gp.bases)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("with_other", [False, True])
def test_flat_gather_matches_jax_kernels(dtype, with_other, monkeypatch):
    """Band, window and fallback classes plus sentinels, against the JAX
    Pallas kernels in interpret mode (f64 through their two-plane
    route), exactly.  (The 1024-wide window class is left to the next
    test: its interpret-mode roll-scan takes tens of seconds.)"""
    monkeypatch.setattr(jfg, "FORCE_PALLAS", True)
    rng = np.random.default_rng(7)
    s = 60000
    idx = _indices(rng, s, ("band16", "win128", "fallback", "sentinel"))
    idx = idx[: idx.size - 300]
    src = rng.standard_normal(s).astype(dtype)
    other = rng.standard_normal(idx.size).astype(dtype) if with_other \
        else None
    jp = jfg.build_flat_gather_plan(idx)
    assert all(v > 0 for k, v in jp.class_fracs.items()
               if k in ("band16", "win128", "fallback")), jp.class_fracs
    want = np.asarray(jfg.flat_gather(
        jp, jnp.asarray(src), None if other is None else jnp.asarray(other)))
    got = tfg.flat_gather(tfg.build_flat_gather_plan(idx),
                          torch.from_numpy(src),
                          None if other is None else torch.from_numpy(other))
    assert got.dtype == torch.from_numpy(src).dtype
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("dtype", DTYPES)
def test_flat_gather_every_class_matches_jax(dtype):
    """Every class of the ladder (the JAX reference's index form off the
    TPU), with and without the fused multiply, exactly."""
    rng = np.random.default_rng(11)
    s = 200000
    idx = _indices(rng, s, ("band1", "band16", "band128", "win128",
                            "win1024", "fallback", "sentinel"))
    src = rng.standard_normal(s).astype(dtype)
    other = rng.standard_normal(idx.size).astype(dtype)
    jp = jfg.build_flat_gather_plan(idx)
    tp = tfg.build_flat_gather_plan(idx)
    for oth in (None, other):
        want = np.asarray(jfg.flat_gather(
            jp, jnp.asarray(src), None if oth is None else jnp.asarray(oth)))
        got = tfg.flat_gather(tp, torch.from_numpy(src),
                              None if oth is None else torch.from_numpy(oth))
        np.testing.assert_array_equal(got.numpy(), want)


def _class_slots(plan):
    """The flat slots of every class unit of a (JAX or port) plan, the
    classes in order (band: SUPER-slot supertiles, window: WIN_UNIT)."""
    slots = [np.zeros(0, np.int64)]
    for (kind, _), ids in zip(plan.classes, plan.ids):
        unit = tfg.SUPER if kind == "band" else tfg.WIN_UNIT
        ids = np.asarray(ids, np.int64)
        slots.append((ids[:, None] * unit + np.arange(unit)).reshape(-1))
    return np.concatenate(slots)


def _unit_slots(plan):
    units = plan.units.numpy().astype(np.int64)
    return (units[:, None] * tfg.WIN_UNIT + np.arange(tfg.WIN_UNIT)).reshape(-1)


@pytest.mark.parametrize("classes", [
    ("band1", "band16", "band128", "win128", "win1024", "fallback",
     "sentinel"),
    ("win1024", "band128", "sentinel", "win128", "band1"),
    ("fallback",),
], ids=["every-class", "classes-out-of-order", "fallback-only"])
def test_flat_gather_units_cover_the_class_units(classes):
    """The merged unit list that one K5 launch gathers covers exactly the
    slots of the per-class units, in class order (a band supertile is two
    WIN_UNIT units); a plan without class units has an empty list."""
    rng = np.random.default_rng(len(classes) + 20)
    plan = tfg.build_flat_gather_plan(_indices(rng, 200000, classes))
    assert plan.units.dtype == torch.int32
    np.testing.assert_array_equal(_unit_slots(plan), _class_slots(plan))
    assert (plan.units.numel() == 0) == (classes == ("fallback",))


def test_flat_gather_units_of_a_jax_plan():
    """``from_numpy`` on a JAX plan's arrays derives the same unit list
    from the JAX per-class ids."""
    rng = np.random.default_rng(21)
    idx = _indices(rng, 200000, ("band16", "win128", "fallback", "band1",
                                 "win1024"))
    j = jfg.build_flat_gather_plan(idx)
    got = tfg.FlatGatherPlan.from_numpy(
        np.asarray(j.idx2d), [np.asarray(i) for i in j.ids],
        [np.asarray(b) for b in j.bases], np.asarray(j.fb_ids), j.classes,
        j.n)
    np.testing.assert_array_equal(_unit_slots(got), _class_slots(j))
    np.testing.assert_array_equal(
        got.units.numpy(), tfg.build_flat_gather_plan(idx).units.numpy())


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("with_other", [False, True])
def test_flat_gather_one_subset_call_matches_jax(dtype, with_other,
                                                 monkeypatch):
    """The port's flat gather, through one ``gather_subset`` call over
    the merged units, equals the JAX flat gather whose Pallas kernels run
    once per class in interpret mode, exactly."""
    monkeypatch.setattr(jfg, "FORCE_PALLAS", True)
    rng = np.random.default_rng(23)
    s = 50000
    idx = _indices(rng, s, ("band1", "sentinel", "win128", "fallback"))
    idx = idx[: idx.size - 500]
    src = rng.standard_normal(s).astype(dtype)
    # ``other`` covers the n slots, not the padded supertiles
    other = rng.standard_normal(idx.size).astype(dtype) if with_other \
        else None
    jp = jfg.build_flat_gather_plan(idx)
    assert sum(1 for i in jp.ids if np.size(i)) > 1, jp.class_fracs
    want = np.asarray(jfg.flat_gather(
        jp, jnp.asarray(src), None if other is None else jnp.asarray(other)))
    tp = tfg.build_flat_gather_plan(idx)
    seen = []

    def spy(*args):
        seen.append(args)
        return gather_tiles.gather_subset(*args)

    monkeypatch.setattr(tfg, "gather_subset", spy)
    got = tfg.flat_gather(tp, torch.from_numpy(src),
                          None if other is None else torch.from_numpy(other))
    np.testing.assert_array_equal(got.numpy(), want)
    (_, _, ids, unit, _, oth), = seen
    assert ids is tp.units and unit == tfg.WIN_UNIT
    assert (oth is None) == (other is None)


@pytest.mark.parametrize("classes, k5, k6", [
    (("band16", "win128", "band1", "win1024"), 1, 0),
    (("band16", "fallback", "win128"), 1, 1),
    (("fallback",), 0, 1),
], ids=["four-classes", "classes-and-fallback", "fallback-only"])
def test_flat_gather_launches_k5_once_per_plan(monkeypatch, classes, k5, k6):
    """Off the CPU (``meta`` stands in for the card, ``launch`` stubbed),
    ``flat_gather`` launches K5 once for a plan with class units, however
    many classes it has, and not at all for a plan with none; the
    fallback tiles keep their K1 gathers and their K6 launch."""
    launched = []
    monkeypatch.setattr(cuda_lib, "launch",
                        lambda what, name, *args: launched.append(name))
    k1 = []

    def gather(x, idx):
        k1.append(idx)
        return torch.zeros(idx.numel(), dtype=x.dtype, device=x.device)

    monkeypatch.setattr(tfg, "gather", gather)
    rng = np.random.default_rng(25)
    plan = tfg.build_flat_gather_plan(_indices(rng, 200000, classes))
    before = gather_tiles.gather_subset.launches
    src = torch.zeros(200000, device="meta")
    out = tfg.flat_gather(plan.to("meta"), src,
                          torch.zeros(plan.n, device="meta"))
    assert out.shape == (plan.n,) and out.device.type == "meta"
    assert launched.count("nsp_gather_subset") == k5
    assert launched.count("nsp_scatter_tiles") == k6
    assert len(launched) == k5 + k6 and len(k1) == 2 * k6
    assert gather_tiles.gather_subset.launches - before == k5


@pytest.mark.parametrize("dtype", DTYPES)
def test_scatter_tiles_matches_jax(dtype):
    rng = np.random.default_rng(5)
    dst = rng.standard_normal((48, 128)).astype(dtype)
    vals = rng.standard_normal((3, 8, 128)).astype(dtype)
    ids = np.array([4, 0, 2], np.int32)
    want = np.asarray(j_scatter(jnp.asarray(dst.copy()), jnp.asarray(ids),
                                jnp.asarray(vals)))
    got = torch.from_numpy(dst.copy()).reshape(-1)
    out = gather_tiles.scatter_tiles(got, torch.from_numpy(ids),
                                     torch.from_numpy(vals), 1024)
    assert out is got  # in place
    np.testing.assert_array_equal(got.reshape(48, 128).numpy(), want)


@pytest.mark.parametrize("dtype", DTYPES)
def test_gather_subset_units(dtype):
    """K5's plain version: listed units only, zero for indices outside
    the source, ``other`` counted as 0 past its end, the rest of ``out``
    untouched."""
    rng = np.random.default_rng(9)
    unit, n_units = 256, 6
    src = rng.standard_normal(500).astype(dtype)
    idx = rng.integers(-3, 510, unit * n_units).astype(np.int32)
    other = rng.standard_normal(unit * 4 + 17).astype(dtype)
    out = np.full(unit * n_units, 7.0, dtype=dtype)
    ids = np.array([5, 1, 4], np.int32)
    got = gather_tiles.gather_subset(
        torch.from_numpy(src), torch.from_numpy(idx), torch.from_numpy(ids),
        unit, torch.from_numpy(out.copy()), torch.from_numpy(other))
    want = out.copy()
    o_pad = np.concatenate([other, np.zeros(out.size - other.size, dtype)])
    for u in ids:
        p = np.arange(u * unit, (u + 1) * unit)
        j = idx[p]
        v = np.where((j >= 0) & (j < src.size), src[np.clip(j, 0, 499)], 0)
        want[p] = v.astype(dtype) * o_pad[p]
    np.testing.assert_array_equal(got.numpy(), want)


def test_wrappers_refuse_mixed_dtypes():
    f32 = torch.zeros(1024, dtype=torch.float32)
    f64 = torch.zeros(1024, dtype=torch.float64)
    ids = torch.zeros(1, dtype=torch.int32)
    with pytest.raises(TypeError):
        gather_tiles.gather_subset(f64, ids.repeat(1024), ids, 1024, f32)
    with pytest.raises(ValueError):
        gather_tiles.scatter_tiles(f32, ids, f64, 1024)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("window", [32, 128, 256])
def test_windowed_gather_matches_jax(window, dtype):
    """K10's plain version against the JAX roll-scan kernel in interpret
    mode, bit for bit."""
    rng = np.random.default_rng(window)
    t = 16
    win = rng.standard_normal((t, max(window, 128))).astype(dtype)
    idx = rng.integers(0, window, (t, 128)).astype(np.int32)
    want = np.asarray(j_windowed_gather(jnp.asarray(win), jnp.asarray(idx),
                                        window, tile_rows=8))
    got = gather_tiles.windowed_gather(torch.from_numpy(win),
                                       torch.from_numpy(idx), window)
    assert got.dtype == torch.from_numpy(win).dtype
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(),
                                  np.take_along_axis(win, idx, 1))


@pytest.mark.parametrize("dtype", DTYPES)
def test_windowed_gather_wide_window_matches_jax(dtype):
    """K10's plain version against the JAX roll-scan kernel in interpret
    mode at window 512 (four lane groups; 8 rows), bit for bit."""
    rng = np.random.default_rng(512)
    win = rng.standard_normal((8, 512)).astype(dtype)
    idx = rng.integers(0, 512, (8, 128)).astype(np.int32)
    want = np.asarray(j_windowed_gather(jnp.asarray(win), jnp.asarray(idx),
                                        512, tile_rows=8))
    got = gather_tiles.windowed_gather(torch.from_numpy(win),
                                       torch.from_numpy(idx), 512)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("dtype", DTYPES)
def test_windowed_gather_window_not_dividing_128(dtype):
    """A window of 100 (neither a divisor nor a multiple of 128, which the
    TPU kernel refuses) in rows of 128 values: equal to
    ``np.take_along_axis``; the row's columns past the window are never
    read."""
    rng = np.random.default_rng(100)
    win = rng.standard_normal((8, 128)).astype(dtype)
    idx = rng.integers(0, 100, (8, 128)).astype(np.int32)
    got = gather_tiles.windowed_gather(torch.from_numpy(win),
                                       torch.from_numpy(idx), 100).numpy()
    np.testing.assert_array_equal(got, np.take_along_axis(win, idx, 1))
    win[:, 100:] = np.nan
    again = gather_tiles.windowed_gather(torch.from_numpy(win),
                                         torch.from_numpy(idx), 100).numpy()
    np.testing.assert_array_equal(again, got)


def test_windowed_gather_outside_the_window_gives_zero():
    """An index outside [0, window) gives 0 and reads nothing outside its
    row, also in a window narrower than the row."""
    rng = np.random.default_rng(2)
    win = rng.standard_normal((4, 128)).astype(np.float32)
    idx = rng.integers(-40, 80, (4, 128)).astype(np.int32)
    got = gather_tiles.windowed_gather(torch.from_numpy(win),
                                       torch.from_numpy(idx), 32).numpy()
    inside = (idx >= 0) & (idx < 32)
    want = np.where(inside, np.take_along_axis(win, np.clip(idx, 0, 31), 1),
                    0)
    np.testing.assert_array_equal(got, want)
    assert (~inside).any() and inside.any()


def test_windowed_gather_refuses_bad_inputs():
    win = torch.zeros(4, 128)
    idx = torch.zeros(4, 128, dtype=torch.int32)
    with pytest.raises(ValueError, match="idx"):
        gather_tiles.windowed_gather(win, idx[:, :64], 32)
    with pytest.raises(ValueError, match="outside"):
        gather_tiles.windowed_gather(win, idx, 256)
    with pytest.raises(ValueError, match="must be on"):
        gather_tiles.windowed_gather(win.to("meta"), idx, 32)
    assert gather_tiles.windowed_gather.launches == 0

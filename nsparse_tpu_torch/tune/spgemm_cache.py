"""SpGEMM plan serialization and on-disk cache (counterpart of
``nsparse_tpu/tune/spgemm_cache.py``).

The symbolic phase is one-time work per sparsity pattern (the reference
re-runs ``SpGEMM_Hash_Numeric`` on a saved structure).  This module keeps
that work across processes: a :class:`SpgemmPlan` of any layout, with
every sub-plan it holds, round-trips through one ``.npz`` file keyed by
the A and B fingerprints (``tune.plan.matrix_fingerprint``, the JAX
package's keys), a hash of the build options and the plan version.

Encoding: a recursive scheme over the plan dataclasses registered below
(any other dataclass is refused).  Tensors and numpy arrays are npz
entries; everything else (ints, strings, tuples, numpy scalars, None)
lives in one JSON metadata entry, which carries the port's format tag and
version.  Each leaf loads as the type and dtype it was saved as.

The JAX package's plan files (``spgemm_<A>_<B>_v<N>.npz``) hold other
plans; the port names its files ``spgemm_<A>_<B>[_<opts>]_torch_v<N>.npz``
and loads only files with its own tag, so a JAX file loads as None.

A plan read from a file is a new source of index tables, and the kernels
trust their index tables: :func:`load_spgemm_plan` checks every table
against what it indexes before returning, through the plan constructors'
own checks where they exist (a sub-plan whose derived tables differ
from what its constructor derives is refused), and raises ValueError
on a table that fails.

The plan's numeric form follows the module globals at build time
(``spgemm_window.FUSED_BANK_BUDGET`` picks the window form v2 or v1,
``piecewise.BANK_ROWS_MAX`` the aligned or flat pieces); they are not in
the key, as in the JAX package, so a cached plan loads in the form it was
saved in.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os

import numpy as np
import torch

from nsparse_tpu_torch.tune.plan import matrix_fingerprint

PLAN_FORMAT = "nsparse_tpu_torch.spgemm_plan"
# bump when SpgemmPlan or any nested plan changes incompatibly
PLAN_VERSION = 2  # 2: the window plan's fallback segment table (K13)


def _registry() -> dict:
    from nsparse_tpu_torch.ops.kernels.fallback import FallbackPlan
    from nsparse_tpu_torch.ops.kernels.flat_gather import FlatGatherPlan
    from nsparse_tpu_torch.ops.kernels.piecewise import (
        ExpandPlan,
        PieceTables,
        PiecewisePlan,
    )
    from nsparse_tpu_torch.ops.kernels.runcopy import RunCopyPlan
    from nsparse_tpu_torch.ops.kernels.shuffle import ShufflePlan
    from nsparse_tpu_torch.ops.kernels.window_fused import FusedClassPlan
    from nsparse_tpu_torch.ops.spgemm import (
        GlobalStructure,
        SortStructure,
        SpgemmPlan,
    )
    from nsparse_tpu_torch.ops.spgemm_window import WindowStructure

    return {c.__name__: c for c in (
        SpgemmPlan, SortStructure, GlobalStructure, WindowStructure,
        FusedClassPlan, ExpandPlan, PieceTables, PiecewisePlan, RunCopyPlan,
        ShufflePlan, FlatGatherPlan, FallbackPlan)}


def _encode(obj, name: str, arrays: dict, registry: dict):
    if obj is None:
        return {"k": "none"}
    if isinstance(obj, torch.Tensor):
        arrays[name] = obj.detach().cpu().numpy()
        return {"k": "tensor", "id": name}
    if isinstance(obj, np.ndarray):
        arrays[name] = obj
        return {"k": "ndarray", "id": name}
    if isinstance(obj, np.generic):
        return {"k": "npscalar", "dtype": obj.dtype.str, "v": obj.item()}
    if isinstance(obj, (bool, int, float, str)):
        return {"k": "val", "v": obj}
    if isinstance(obj, tuple):
        return {"k": "tup", "items": [
            _encode(o, f"{name}.{i}", arrays, registry)
            for i, o in enumerate(obj)]}
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        cls = type(obj).__name__
        if registry.get(cls) is not type(obj):
            raise TypeError(f"unregistered plan dataclass {cls}")
        return {"k": "dc", "c": cls, "f": {
            f.name: _encode(getattr(obj, f.name), f"{name}.{f.name}", arrays,
                            registry)
            for f in dataclasses.fields(obj)}}
    raise TypeError(f"cannot encode a plan leaf of type {type(obj).__name__}")


def _decode(meta, arrays, registry: dict):
    k = meta["k"]
    if k == "none":
        return None
    if k == "val":
        return meta["v"]
    if k == "npscalar":
        return np.dtype(meta["dtype"]).type(meta["v"])
    if k == "tup":
        return tuple(_decode(m, arrays, registry) for m in meta["items"])
    if k == "dc":
        cls = registry.get(meta["c"])
        if cls is None:
            raise ValueError(f"unregistered plan dataclass {meta['c']!r}")
        return cls(**{n: _decode(m, arrays, registry)
                      for n, m in meta["f"].items()})
    if k in ("tensor", "ndarray"):
        arr = arrays[meta["id"]]
        return torch.from_numpy(arr) if k == "tensor" else arr
    raise ValueError(f"bad plan encoding kind {k!r}")


def save_spgemm_plan(plan, path: str) -> str:
    """Write ``plan`` (and every sub-plan) to one uncompressed ``.npz``,
    atomically (a ``.tmp`` file, then ``os.replace``); returns ``path``."""
    arrays: dict = {}
    meta = _encode(plan, "p", arrays, _registry())
    arrays["__meta__"] = np.frombuffer(json.dumps({
        "format": PLAN_FORMAT, "version": PLAN_VERSION, "tree": meta,
    }).encode(), dtype=np.uint8)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
    os.replace(tmp, path)
    return path


def load_spgemm_plan(path: str):
    """The plan saved at ``path``, its tensors on the CPU (move it with
    ``plan.to(device)``); None when the file is missing or is not a plan
    of this package's format and version.  Raises ValueError when a table
    does not fit what it indexes."""
    from nsparse_tpu_torch.ops.spgemm import SpgemmPlan

    if not os.path.exists(path):
        return None
    with np.load(path, allow_pickle=False) as z:
        if "__meta__" not in z.files:
            return None
        meta = json.loads(bytes(z["__meta__"]).decode())
        if not isinstance(meta, dict) or meta.get("format") != PLAN_FORMAT \
                or meta.get("version") != PLAN_VERSION:
            return None
        try:
            plan = _decode(meta["tree"], z, _registry())
        except (KeyError, TypeError) as e:  # a tree that fits no plan
            raise ValueError(f"{path}: malformed plan encoding ({e})") from e
    if not isinstance(plan, SpgemmPlan):
        raise ValueError(f"{path} holds no SpgemmPlan")
    check_plan(plan)
    return plan


def plan_cache_path(directory: str, a, b, chip: str = "",
                    plan_kwargs: dict | None = None) -> str:
    """``<directory>/spgemm_<A>_<B>[_<chip>][_<opts>]_torch_v<N>.npz``:
    the fingerprints and the 8-hex hash of the build options as the JAX
    package forms them."""
    key = f"{matrix_fingerprint(a)}_{matrix_fingerprint(b)}"
    if chip:
        key += f"_{chip}"
    if plan_kwargs:
        enc = json.dumps(plan_kwargs, sort_keys=True, default=str)
        key += "_" + hashlib.sha1(enc.encode()).hexdigest()[:8]
    return os.path.join(directory,
                        f"spgemm_{key}_torch_v{PLAN_VERSION}.npz")


def spgemm_plan_cached(a, b, directory: str, **plan_kwargs):
    """``spgemm_plan(a, b, **plan_kwargs)`` through the cache in
    ``directory``; returns (plan, hit), the plan on the CPU."""
    from nsparse_tpu_torch.ops.spgemm import spgemm_plan

    path = plan_cache_path(directory, a, b, plan_kwargs=plan_kwargs)
    plan = load_spgemm_plan(path)
    if plan is not None:
        return plan, True
    plan = spgemm_plan(a, b, **plan_kwargs)
    save_spgemm_plan(plan, path)
    return plan, False


# -- checks of a loaded plan --------------------------------------------------


def _same(x, y) -> bool:
    """Equal trees: the same types, tensors of one dtype and shape equal
    element for element, equal values."""
    if type(x) is not type(y):
        return False
    if isinstance(x, torch.Tensor):
        return x.dtype == y.dtype and x.shape == y.shape \
            and torch.equal(x, y)
    if isinstance(x, np.ndarray):
        return x.dtype == y.dtype and np.array_equal(x, y)
    if dataclasses.is_dataclass(x):
        return all(_same(getattr(x, f.name), getattr(y, f.name))
                   for f in dataclasses.fields(x))
    if isinstance(x, tuple):
        return len(x) == len(y) and all(map(_same, x, y))
    return x == y


def _rebuilt(obj, built, what: str) -> None:
    if not _same(obj, built):
        raise ValueError(f"{what}: derived tables differ from its "
                         "constructor's")


def _inside(x: torch.Tensor, lo: int, hi: int, what: str) -> None:
    if x.numel() and not (int(x.min()) >= lo and int(x.max()) < hi):
        raise ValueError(f"{what} outside [{lo}, {hi})")


def _is_int32(*xs) -> None:
    for x in xs:
        if not isinstance(x, torch.Tensor) or x.dtype != torch.int32 \
                or x.dim() != 1:
            raise ValueError("plan index tables must be 1-D int32 tensors")


def _check_shuffle(p) -> None:
    _is_int32(p.idx)
    if p.idx.numel() != p.n:
        raise ValueError("shuffle plan length differs from its table")


def _check_runcopy(p) -> None:
    from nsparse_tpu_torch.ops.kernels.runcopy import build_runcopy_plan

    _is_int32(p.src_off, p.dst, p.len)
    if p.kfac is None and p.stride is None:
        built = build_runcopy_plan(p.src_off.numpy(), p.len.numpy(), p.n_src,
                                   dst=p.dst.numpy(), n_out=p.n_out)
    else:
        built, _ = build_runcopy_plan(p.src_off.numpy(), p.len.numpy(),
                                      p.n_src, kfac=p.kfac.numpy(),
                                      stride=p.stride.numpy())
    _rebuilt(p, built, "run copy plan")


def _check_expand(p) -> None:
    from nsparse_tpu_torch.ops.kernels.piecewise import build_expand_plan

    _is_int32(p.run_start, p.b_start, p.live_len, p.aidx)
    _rebuilt(p, build_expand_plan(p.run_start.numpy()[:-1], p.b_start.numpy(),
                                  p.live_len.numpy(), p.aidx.numpy(), p.n,
                                  p.nnz_a, p.nnz_b), "expansion plan")


def _check_flat_gather(p) -> None:
    from nsparse_tpu_torch.ops.kernels.flat_gather import (
        LANES,
        FlatGatherPlan,
    )

    if p.idx2d.dim() != 2 or p.idx2d.shape[1] != LANES:
        raise ValueError("flat gather indices must be (T, 128)")
    _is_int32(*p.ids, *p.bases, p.fb_ids)
    _rebuilt(p, FlatGatherPlan.from_numpy(
        p.idx2d.numpy(), [i.numpy() for i in p.ids],
        [b.numpy() for b in p.bases], p.fb_ids.numpy(), p.classes, p.n),
        "flat gather plan")


def _check_fallback(p) -> None:
    from nsparse_tpu_torch.ops.kernels.fallback import check_fallback_plan

    _is_int32(p.src, p.dst, p.chunks, p.warps)
    check_fallback_plan(p)


def _check_fused(p) -> None:
    from nsparse_tpu_torch.ops.kernels.window_fused import (
        ClassPieces,
        build_fused_plan,
    )

    _is_int32(p.tile_idx, p.tier_idx, p.ext_idx, p.entry_idx)
    n_win = p.slots // max(p.w, 1)
    cuts = np.cumsum([0] + [n_win * v for v in p.tier_vs])
    if p.w <= 0 or cuts[-1] != p.tier_idx.numel():
        raise ValueError("fused class tier tables have the wrong length")
    tier = p.tier_idx.numpy()
    pieces = None
    if p.etrips is not None:
        pieces = ClassPieces(
            p.etrips.numpy(), p.ecuts.numpy(), p.eboffs.numpy(),
            p.eends.numpy(), p.j2_cap, p.blk, p.apv_lo, p.apv_hi,
            p.bank_rows)
    _rebuilt(p, build_fused_plan(
        p.w, p.slots, p.lv, p.tier_vs, p.tile_idx.numpy(),
        [tier[lo:hi] for lo, hi in zip(cuts[:-1], cuts[1:])],
        p.ext_idx.numpy(), p.entry_idx.numpy(), pieces), "fused class plan")


def _check_piecewise(p) -> None:
    from nsparse_tpu_torch.ops.kernels.piecewise import (
        J_CLASSES,
        check_piecewise_plan,
        merge_piece_tables,
    )

    _is_int32(*p.ids, *p.cuts, *p.boffs, p.apv_idx, p.arena_src, p.fb_ids,
              p.fb_bidx, p.fb_aidx)
    check_piecewise_plan(p)
    _rebuilt(p.pieces, merge_piece_tables(J_CLASSES, p.cuts, p.boffs),
             "merged piece tables")
    sizes = np.cumsum([0] + [c.numel() for c in p.cuts])
    _rebuilt(p.apv_splits, tuple(zip(sizes[:-1].tolist(), sizes[1:].tolist())),
             "piecewise A-value splits")


_CHECKS = {
    "ShufflePlan": _check_shuffle,
    "RunCopyPlan": _check_runcopy,
    "ExpandPlan": _check_expand,
    "FlatGatherPlan": _check_flat_gather,
    "FusedClassPlan": _check_fused,
    "PiecewisePlan": _check_piecewise,
    "FallbackPlan": _check_fallback,
}


def _check_subplans(obj) -> None:
    """Every registered sub-plan in the tree, by its own check."""
    if isinstance(obj, tuple):
        for o in obj:
            _check_subplans(o)
    elif dataclasses.is_dataclass(obj):
        for f in dataclasses.fields(obj):
            _check_subplans(getattr(obj, f.name))
        check = _CHECKS.get(type(obj).__name__)
        if check is not None:
            check(obj)


def _check_slab(levels, lvl_idx, n_in: int, what: str) -> None:
    """The slab reduction (``spgemm.slab_class_reduce``): level 0 reads at
    most ``n_in`` values, each later level is fed by one index table into
    the previous level's CHUNK-class sums."""
    from nsparse_tpu_torch.ops.spgemm import CHUNK

    if len(lvl_idx) != max(len(levels) - 1, 0):
        raise ValueError(f"{what}: one index table per slab level past 0")
    _is_int32(*lvl_idx)
    need = n_in
    for li, classes in enumerate(levels):
        total = sum(L * cnt for L, cnt in classes)
        if any(L < 1 or L > CHUNK or L & (L - 1) or cnt < 0
               for L, cnt in classes) or total > need:
            raise ValueError(f"{what}: slab level {li} does not fit")
        if li + 1 < len(levels):
            chunk = [cnt for L, cnt in classes if L == CHUNK]
            _inside(lvl_idx[li], -1, chunk[0] if chunk else 0,
                    f"{what}: slab level {li + 1} index")
            need = lvl_idx[li].numel()


def _check_sort(plan, s) -> None:
    p, nnz, cap = plan.n_products, plan.c_nnz, plan.c_capacity
    _is_int32(s.apos, s.bpos, s.out_pos, s.ends)
    if not (s.apos.numel() == s.bpos.numel() == s.out_pos.numel() >= p) \
            or s.ends.numel() != cap or s.max_len < 0:
        raise ValueError("sort layout tables have the wrong length")
    _inside(s.apos[:p], 0, plan.nnz_a, "sort layout A index")
    _inside(s.bpos[:p], 0, plan.nnz_b, "sort layout B index")
    _inside(s.out_pos, 0, cap + 1, "sort layout C entry")
    ends = s.ends[:nnz].long()
    if nnz and (int(ends[0]) < 0 or int(ends[-1]) != p - 1
                or not bool((ends.diff() > 0).all())):
        raise ValueError("sort layout entry ends must ascend to the last "
                         "product")
    host = (s.av_gp, s.bv_gp, s.uniq_bpos, s.bp_rank)
    if all(x is None for x in host):
        return
    if any(x is None for x in host):
        raise ValueError("sort layout gather plans are incomplete")
    _is_int32(s.uniq_bpos, s.bp_rank)
    if s.av_gp.n < p or s.bv_gp.n < p or s.bp_rank.numel() < p:
        raise ValueError("sort layout gather plans are shorter than P")
    _inside(s.uniq_bpos, 0, plan.nnz_b, "sort layout distinct B index")
    _inside(s.bp_rank[:p], 0, s.bv_gp.n, "sort layout rank")


def _check_global(plan, g) -> None:
    pw = g.pw
    _is_int32(g.b8_idx)
    if pw.nnz_a != plan.nnz_a or pw.nnz_b != g.b8_idx.numel():
        raise ValueError("global layout pieces built for other tables")
    if g.asm_shuffle.n < plan.c_capacity:
        raise ValueError("global layout assembly shorter than C")
    _check_slab(g.slab_levels, g.lvl_idx, g.slab_shuffle.n, "global layout")


def _check_window(plan, w) -> None:
    if len(w.class_geom) != len(w.fused) or any(
            (slots, width, lv) != (fp.slots, fp.w, fp.lv)
            for (_, slots, width, lv), fp in zip(w.class_geom, w.fused)):
        raise ValueError("window class geometry differs from its classes")
    if sum(fp.slots for fp in w.fused) != w.n_compact \
            or w.merge.n_src < w.n_compact \
            or w.merge.n_out < plan.c_capacity:
        raise ValueError("window merge does not fit the class arenas and C")
    _is_int32(w.b8_idx, w.apv_idx)
    if w.fused_expand:
        if w.expand is not None or any(
                not fp.expand or fp.bank_rows != w.bank_rows
                or not 0 <= fp.apv_lo <= fp.apv_hi <= w.apv_idx.numel()
                for fp in w.fused):
            raise ValueError("v2 window classes do not match their bank")
        prod_len = w.pw.n_pad if w.pw is not None else 0
    else:
        e = w.expand
        if e is None or (e.nnz_a, e.nnz_b) != (plan.nnz_a, plan.nnz_b) \
                or any(fp.expand or base < 0 or base + fp.slots > e.n
                       for (base, *_), fp in zip(w.class_geom, w.fused)):
            raise ValueError("v1 window classes do not fit the product "
                             "arena")
        prod_len = e.n
    fb = (w.fb, w.fb_shuffle, w.fb_perm) \
        + ((w.pw,) if w.fused_expand else ())
    if all(x is None for x in fb):
        return
    if any(x is None for x in fb):
        raise ValueError("window fallback pool is incomplete")
    if w.fused_expand and w.pw.nnz_a != plan.nnz_a:
        raise ValueError("window fallback pieces built for another A")
    if w.fb_off < 0 or w.fb_off + w.fb_len > prod_len \
            or w.fb.n_src != w.fb_len \
            or w.fb_perm.n != w.merge.n_src - w.n_compact \
            or w.fb.n_out != w.fb_perm.n:
        raise ValueError("window fallback pool does not fit its arenas")
    _check_slab(w.fb_levels, w.fb_lvl_idx, w.fb_shuffle.n, "window fallback")


def check_plan(plan) -> None:
    """Raise ValueError unless every table of ``plan`` fits what it
    indexes (see the module docstring)."""
    m, n = plan.shape
    _is_int32(plan.c_rpt, plan.c_col)
    rpt = plan.c_rpt.long()
    if rpt.numel() != m + 1 or int(rpt[0]) != 0 \
            or int(rpt[-1]) != plan.c_nnz or bool((rpt.diff() < 0).any()) \
            or plan.c_capacity < plan.c_nnz or plan.n_products < 0:
        raise ValueError("plan rows do not match nnz(C)")
    _inside(plan.c_col[: plan.c_nnz], 0, n, "C column")
    structs = {"window": plan.win, "global": plan.glob, "sort": plan.srt}
    if plan.layout not in structs or any(
            (s is None) == (k == plan.layout) for k, s in structs.items()):
        raise ValueError(f"plan layout {plan.layout!r} without its "
                         "structure alone")
    _check_subplans(plan)
    {"window": _check_window, "global": _check_global,
     "sort": _check_sort}[plan.layout](plan, structs[plan.layout])

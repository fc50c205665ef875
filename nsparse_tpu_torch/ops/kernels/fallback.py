"""The window numeric's fallback segment in one launch, kernel K13
(``fallback_sum``).

Rows beyond every window's capability go to the fallback pool; the host
plan lays their products out as bin-padded slab classes
(``spgemm._build_slab_structure``), and ``spgemm.slab_class_reduce`` sums
each class by halving adds (the JAX package's route: XLA adds around
``shuffle_pallas.planned_shuffle``).  Those adds form a fixed pairwise
tree per entry: width L = its product count rounded up to a power of two
(at most 512), slot t added to t + L/2, then t + L/4 ... t + 1, slots past
the count +0.0; a longer entry is cut into 512-product chunks (each a
width-512 tree) whose sums are summed by the same rule.  K13 computes
those trees straight from the product arena, reading the slab's own
level-0 slots (their sources, pads as -1: :class:`FallbackPlan`, derived
once per pattern by :func:`fallback_from_slab`), and writes each total
to its slot of the merge buffer's fallback segment, so the segment
equals the slab route's bit for bit where an entry lands; the alignment
gaps take +0.0.
"""

from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from nsparse_tpu_torch.ops.kernels import cuda_lib
from nsparse_tpu_torch.utils.device import int32_tensor, to_device

CHUNK = 512          # the slab's chunk width (entries past it are chunked)
LONG = 0             # class width code: entries past CHUNK products
GAP = -1             # class width code: segment slots no entry fills
MAX_CLASSES = 12     # the level-0 widths 1 .. CHUNK, GAP and LONG
MAX_CHUNKS = CHUNK * CHUNK  # a long entry's chunks: two slab levels above 0
THREAD_MAX = 64      # widths summed a thread per member (wider: a warp)
BLOCK_WARPS = 8      # the kernel's warps a block: a long entry's warps


@dataclasses.dataclass(frozen=True)
class FallbackPlan:
    """The fallback segment from the slab's level-0 slots (K13).

    Members, in ``dst`` order: the level-0 members of the slab classes
    (an entry of at most CHUNK products, a chunk of a longer entry, or a
    pad member), then the segment's gap slots, then the entries past
    CHUNK products ("long" entries: their chunks are members of the
    width-CHUNK class).  A member's sum is the slab class's halving tree
    over its slots; a long entry's the tree of its chunk sums.

    Attributes:
      src: (slots,) int32 the level-0 slab: a class of width L and cnt
        members at slots ``[s0, s0 + L cnt)``, member m's slot t at
        ``s0 + t cnt + m`` (``slab_class_reduce``'s member-minor layout);
        the product's position in the pool's region of the product arena,
        -1 for a pad (+0.0).
      dst: (members,) int32 the segment slot each member's sum goes to,
        -1 for none (a chunk, a pad member, a pad of the gap list).
      chunks: (2 * long entries,) int32 first chunk (member of the
        width-CHUNK class) and chunk count of each long entry.
      warps: (2 * warps,) int32 class and first member of each warp's 32
        members (a long entry's warp: its one), in launch order.
      classes: ((width, first slot, members, first member), ...) on the
        host: the level-0 classes, then ``GAP`` and ``LONG`` where there
        are any.
      n_products: the pool's products (slots that are not pads).
      n_src: the length of the region ``src`` indexes; n_out: the
        segment's length.
    """

    src: torch.Tensor
    dst: torch.Tensor
    chunks: torch.Tensor
    warps: torch.Tensor
    classes: tuple
    n_products: int
    n_src: int
    n_out: int

    def to(self, device) -> "FallbackPlan":
        return to_device(self, device)


def tree_width(lens: np.ndarray) -> np.ndarray:
    """The slab tree width of entries of ``lens`` products: the count
    rounded up to a power of two (1 for 0 and 1), ``LONG`` past CHUNK."""
    lens = np.asarray(lens, dtype=np.int64)
    e = np.frexp((np.maximum(lens, 1) - 1).astype(np.float64))[1]
    return np.where(lens > CHUNK, LONG, np.int64(1) << e)


def _member_minor(table, off: int, width: int, cnt: int):
    """The (cnt, width) view of a member-minor slab class at ``off``."""
    return table[off : off + width * cnt].reshape(width, cnt).T


def fallback_from_slab(slab_src, levels, lvl_idx, entry_res, entry_seg,
                       real: np.ndarray, n_seg: int) -> FallbackPlan:
    """The plan of the fallback segment that the slab route fills.

    ``slab_src`` (the level-0 slab's source in the pool region, -1 = a
    zero), ``levels`` and ``lvl_idx`` are the slab layout
    (``spgemm._build_slab_structure``, as ``slab_class_reduce`` reads
    it); entry k's total lies at position ``entry_res[k]`` of the
    concatenated class sums and goes to segment slot ``entry_seg[k]``;
    ``real`` (one flag per pool slot) tells a product from a zero pad.
    The level-0 slots are kept as they are, pads as -1; an entry above
    level 0 becomes a long entry over a run of the width-CHUNK class's
    members.  Raises AssertionError where the slab's tree of an entry
    above level 0 is not the one the kernel derives from its chunk count.
    """
    n_src = real.size
    if len(levels) > 3:
        raise ValueError(f"fallback entries past {MAX_CHUNKS} chunks")
    lvl0 = tuple(levels[0]) if levels else ()
    p0 = sum(w * c for w, c in lvl0)
    s = np.asarray(slab_src[:p0], np.int64)
    inside = (s >= 0) & (s < n_src)
    keep = inside & real[np.where(inside, s, 0)]
    table = np.where(keep, s, -1)
    n0 = sum(c for _, c in lvl0)
    entry_res = np.asarray(entry_res, np.int64)
    entry_seg = np.asarray(entry_seg, np.int64)
    if entry_seg.size and (entry_seg.min() < 0 or entry_seg.max() >= n_seg
                           or np.bincount(entry_seg).max() > 1):
        raise AssertionError("fallback entries' segment slots collide")
    at0 = entry_res < n0
    dst0 = np.full(n0, -1, np.int64)
    dst0[entry_res[at0]] = entry_seg[at0]

    # each member above level 0: its first chunk (a member of the level-0
    # width-CHUNK class) and its chunk count, over its run of items (the
    # level below's width-CHUNK members)
    first = count = None
    if CHUNK in [w for w, _ in lvl0]:
        cnt512 = dict((w, c) for w, c in lvl0)[CHUNK]
        first, count = np.arange(cnt512), np.ones(cnt512, np.int64)
    res_base, longs = n0, []
    for li in range(1, len(levels)):
        lv, off = [], 0
        for w, cnt in levels[li]:
            items = _member_minor(np.asarray(lvl_idx[li - 1], np.int64),
                                  off, w, cnt)
            off += w * cnt
            live = items >= 0
            n_it = live.sum(axis=1)
            if not (live == (np.arange(w) < n_it[:, None])).all():
                raise AssertionError("fallback slab pads do not trail "
                                     "their entry")
            it = np.where(live, items, 0)
            f, n = first[it], np.where(live, count[it], 0)
            # item i + 1 starts where item i ends, which is whole
            run = (f[:, :-1] + n[:, :-1] == f[:, 1:]) \
                & (n[:, :-1] == CHUNK ** (li - 1))
            if not (run | ~live[:, 1:]).all():
                raise AssertionError("a fallback entry's chunks do not "
                                     "run on")
            lv.append(np.stack([f[:, 0], n.sum(axis=1), n_it,
                                np.full(cnt, w)], 1))
        lv = np.concatenate(lv)
        sel = (entry_res >= res_base) & (entry_res < res_base + len(lv))
        longs.append((entry_seg[sel], lv[entry_res[sel] - res_base], li))
        res_base += len(lv)
        w_l = [w for w, _ in levels[li]]
        if CHUNK in w_l:
            b = sum(c for _, c in levels[li][: w_l.index(CHUNK)])
            c = levels[li][w_l.index(CHUNK)][1]
            first, count = lv[b : b + c, 0], lv[b : b + c, 1]
    if sum(len(x[0]) for x in longs) != int((~at0).sum()) \
            or (entry_res < 0).any():
        raise AssertionError("a fallback entry outside the slab sums")
    l_dst = np.concatenate([x[0] for x in longs] + [np.zeros(0, np.int64)])
    lv = np.concatenate([x[1] for x in longs] + [np.zeros((0, 4), np.int64)])
    lvl = np.concatenate([np.full(len(x[0]), x[2]) for x in longs]
                         + [np.zeros(0, np.int64)])
    # the kernel's rule for a long entry: its chunk sums, a tree of their
    # count rounded up to a power of two, or past CHUNK chunks, chunks of
    # CHUNK chunk sums and a tree of those
    nch = lv[:, 1]
    top = np.where(nch > CHUNK, -(-nch // CHUNK), nch)
    if (nch < 2).any() or (nch > MAX_CHUNKS).any() \
            or (lvl != np.where(nch > CHUNK, 2, 1)).any() \
            or (lv[:, 2] != top).any() or (tree_width(top) != lv[:, 3]).any():
        raise AssertionError("a long fallback entry's slab tree is not the "
                             "kernel's")
    gaps = np.ones(n_seg, bool)
    gaps[entry_seg] = False
    gaps = np.flatnonzero(gaps)
    return build_fallback_plan(table, lvl0, dst0, gaps, lv[:, 0], nch,
                               l_dst, n_src, n_seg)


def build_fallback_plan(table, lvl0, dst0, gaps, l_first, l_count, l_dst,
                        n_src: int, n_out: int) -> FallbackPlan:
    """The plan from its parts: the level-0 slab ``table`` (-1 pads) of
    classes ``lvl0`` ((width, members), ...) with each member's segment
    slot ``dst0`` (-1 none), the ``gaps`` slots, and the long entries'
    first chunk, chunk count and slot.

    Warps: a class of width at most ``THREAD_MAX`` (and the gaps) takes
    one per 32 members, a wider one one per member with a slot, a long
    entry a block of ``BLOCK_WARPS``.  The long entries' blocks come
    first, then every other warp by the first segment slot it writes, so
    that warps running together read nearby products."""
    table = np.asarray(table, np.int64)
    dst = np.concatenate([np.asarray(dst0, np.int64),
                          np.asarray(gaps, np.int64),
                          np.full(-len(gaps) % 32, -1),
                          np.asarray(l_dst, np.int64)])
    parts = [(w, c) for w, c in lvl0]
    if len(gaps):
        parts.append((GAP, len(gaps) + (-len(gaps) % 32)))
    if len(l_dst):
        parts.append((LONG, len(l_dst)))
    classes, warps, keys = [], [], []
    s0 = m0 = 0
    for k, (w, cnt) in enumerate(parts):
        classes.append((int(w), s0 if w > 0 else 0, int(cnt), m0))
        d = dst[m0 : m0 + cnt]
        if w == LONG:
            first = np.repeat(np.arange(cnt), BLOCK_WARPS)
            key = np.full(first.size, -1)
        elif w > THREAD_MAX:
            first = np.flatnonzero(d >= 0)
            key = d[first]
        else:
            first = np.arange(0, cnt, 32)
            key = np.where(d >= 0, d, n_out).reshape(-1, 32).min(axis=1)
        warps.append(np.stack([np.full(first.size, k), first], 1))
        keys.append(key)
        s0 += max(int(w), 0) * int(cnt)
        m0 += int(cnt)
    warps = np.concatenate(warps) if warps else np.zeros((0, 2), np.int64)
    keys = np.concatenate(keys) if keys else np.zeros(0, np.int64)
    warps = warps[np.argsort(keys, kind="stable")]
    return FallbackPlan(
        src=int32_tensor(table), dst=int32_tensor(dst),
        chunks=int32_tensor(np.stack([l_first, l_count], 1).reshape(-1)),
        warps=int32_tensor(warps.reshape(-1)), classes=tuple(classes),
        n_products=int((table >= 0).sum()), n_src=int(n_src),
        n_out=int(n_out))


def check_fallback_plan(plan: FallbackPlan) -> None:
    """Raise ValueError unless every table of ``plan`` keeps the kernel
    inside its arrays and writes each segment slot once."""
    src, dst = plan.src.numpy(), plan.dst.numpy().astype(np.int64)
    chunks = plan.chunks.numpy().astype(np.int64).reshape(-1, 2)
    warps = plan.warps.numpy().astype(np.int64)
    if warps.size % 2 or len(plan.classes) > MAX_CLASSES:
        raise ValueError("fallback warps or classes malformed")
    warps = warps.reshape(-1, 2)
    if src.size and (int(src.min()) < -1 or int(src.max()) >= plan.n_src):
        raise ValueError(f"fallback sources outside [-1, {plan.n_src})")
    if int((src >= 0).sum()) != plan.n_products:
        raise ValueError("fallback product count differs from the slots")
    live = dst[dst >= 0]
    if (dst.size and int(dst.min()) < -1) or live.size != plan.n_out or (
            live.size and (int(live.max()) >= plan.n_out
                           or np.bincount(live).max() > 1)):
        raise ValueError("fallback members do not write each segment slot "
                         "once")
    if ((warps[:, 0] < 0) | (warps[:, 0] >= len(plan.classes))).any():
        raise ValueError("a fallback warp of no class")
    cnt512 = None
    for k, (w, s0, cnt, m0) in enumerate(plan.classes):
        if w not in (GAP, LONG) and (w < 1 or w > CHUNK or w & (w - 1)
                                     or s0 < 0 or s0 + w * cnt > src.size):
            raise ValueError("a fallback class outside the slots")
        if w == CHUNK:
            cnt512 = cnt
        if m0 < 0 or m0 + cnt > dst.size:
            raise ValueError("a fallback class outside the members")
        mine = warps[:, 0] == k
        if w == LONG:
            # the first warps, a block of each entry's in entry order
            want = np.repeat(np.arange(cnt), BLOCK_WARPS)
            ok = np.array_equal(np.flatnonzero(mine),
                                np.arange(want.size)) \
                and np.array_equal(warps[mine, 1], want)
            if not ok or chunks.shape[0] != cnt or cnt512 is None or (
                    chunks[:, 1] < 2).any() or (
                    chunks[:, 1] > MAX_CHUNKS).any() or (
                    chunks[:, 0] < 0).any() or (
                    chunks.sum(axis=1) > cnt512).any():
                raise ValueError("fallback long entries outside their "
                                 "chunks or blocks")
            continue
        want = np.flatnonzero(dst[m0 : m0 + cnt] >= 0) if w > THREAD_MAX \
            else np.arange(0, cnt, 32)
        if (w <= THREAD_MAX and cnt % 32) or not np.array_equal(
                np.sort(warps[mine, 1]), want):
            raise ValueError("fallback warps do not cover a class once")


def _halve(m):
    """Halving adds along the rows of ``m`` (a power-of-two width): column
    t plus column t + w/2, down to one column."""
    w = m.shape[1]
    while w > 1:
        w //= 2
        m = m[:, :w] + m[:, w : 2 * w]
    return m[:, 0]


def _tree(vals, starts, lens, width: int):
    """Width-``width`` halving trees over ``vals[starts[i] + t]``, t <
    ``lens[i]``, the other slots +0.0."""
    if vals.numel() == 0:
        return vals.new_zeros(starts.numel())
    t = torch.arange(width, device=vals.device)
    return _halve(torch.where(
        t < lens[:, None],
        vals[(starts[:, None] + t).clamp(max=vals.numel() - 1)], 0))


def tree_sums(vals, starts, lens):
    """Each entry's slab tree sum over ``vals[starts[i]:starts[i] +
    lens[i]]``: the plain PyTorch model of the kernel's sums."""
    out = vals.new_zeros(lens.numel())
    width = torch.from_numpy(tree_width(lens.cpu().numpy())).to(lens.device)
    for w in torch.unique(width).tolist():
        ids = torch.nonzero(width == w).squeeze(1)
        if w != LONG:
            out[ids] = _tree(vals, starts[ids], lens[ids], w)
            continue
        # chunk sums, then the same rule over each entry's chunk sums
        nch = (lens[ids] + CHUNK - 1) // CHUNK
        ent = torch.repeat_interleave(
            torch.arange(ids.numel(), device=vals.device), nch)
        first = torch.cumsum(nch, 0) - nch
        j = torch.arange(ent.numel(), device=vals.device) - first[ent]
        cs = _tree(vals, starts[ids][ent] + j * CHUNK,
                   (lens[ids][ent] - j * CHUNK).clamp(max=CHUNK), CHUNK)
        out[ids] = tree_sums(cs, first, nch)
    return out


def _segment(plan: FallbackPlan, like: torch.Tensor, out):
    if out is None:
        return torch.empty(plan.n_out, dtype=like.dtype, device=like.device)
    if out.numel() != plan.n_out or out.dtype != like.dtype \
            or out.device != like.device:
        raise ValueError(f"segment of {out.numel()} {out.dtype} on "
                         f"{out.device} for a plan of {plan.n_out} slots of "
                         f"{like.dtype} on {like.device}")
    return out


def fallback_sum_plain(plan: FallbackPlan, x: torch.Tensor,
                       out: torch.Tensor | None = None) -> torch.Tensor:
    """Plain PyTorch version of K13 over the same tables: each level-0
    class's (width, members) slots summed by halving adds (as
    ``slab_class_reduce`` sums its level 0), a long entry's chunk sums
    by :func:`tree_sums`, the gaps +0.0."""
    out = _segment(plan, x, out)
    dev = x.device
    src = plan.src.long()
    vals = torch.where(src >= 0, x[src.clamp(min=0)], 0) if x.numel() \
        else torch.zeros(src.numel(), dtype=x.dtype, device=dev)
    sums = torch.zeros(plan.dst.numel(), dtype=x.dtype, device=dev)
    chunk_sums = None
    for w, s0, cnt, m0 in plan.classes:
        if w == LONG:
            ch = plan.chunks.long().view(-1, 2)
            sums[m0 : m0 + cnt] = tree_sums(chunk_sums, ch[:, 0], ch[:, 1])
        elif w != GAP:
            m = _halve(vals[s0 : s0 + w * cnt].view(w, cnt).t())
            sums[m0 : m0 + cnt] = m
            if w == CHUNK:
                chunk_sums = m
    dst = plan.dst.long()
    live = dst >= 0
    out[dst[live]] = sums[live]
    return out


def fallback_sum(plan: FallbackPlan, x: torch.Tensor,
                 out: torch.Tensor | None = None) -> torch.Tensor:
    """K13: the (n_out,) fallback segment from the pool's products ``x``
    (the pool's region of the product arena), into ``out`` (the merge
    buffer's fallback segment) when given.

    CPU tensors take :func:`fallback_sum_plain`; CUDA tensors launch the
    kernel (``csrc/fallback_sum.cu``) or raise.
    """
    if x.numel() < plan.n_src:
        raise ValueError(f"{x.numel()} products for a pool of {plan.n_src}")
    if x.device.type == "cpu":
        return fallback_sum_plain(plan, x, out)
    return _launch(plan, x, _segment(plan, x, out))


def _launch(plan: FallbackPlan, x: torch.Tensor, out: torch.Tensor):
    """One launch of the kernel on the plan's tables (the class table as
    a host array)."""
    if plan.n_out:
        flat = [v for c in plan.classes for v in c]
        cuda_lib.launch("fallback_sum", "nsp_fallback_sum", x, plan.src,
                        plan.dst, plan.chunks, plan.warps,
                        plan.warps.numel() // 2,
                        (ctypes.c_int64 * len(flat))(*flat),
                        len(plan.classes), out)
        fallback_sum.launches += 1
    return out


fallback_sum.launches = 0

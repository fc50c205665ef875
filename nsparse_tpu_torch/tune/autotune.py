"""SpMV auto-tuner (counterpart of ``nsparse_tpu/tune/autotune.py``).

Builds candidate formats (DIA, CSR, ELL knob sweeps, BSR tile shapes),
scores each and keeps the best: by measured device time per SpMV (CUDA
events, measure mode) or by footprint, the bytes of the format's own
tensors (model mode, the reference's non-timed objective).
"""

from __future__ import annotations

import dataclasses
import sys
from typing import Iterable, Optional, Sequence

import numpy as np
import torch

from nsparse_tpu_torch.formats.bsr import BSR
from nsparse_tpu_torch.formats.csr import CSR
from nsparse_tpu_torch.formats.dia import DIA
from nsparse_tpu_torch.formats.ell import ELL
from nsparse_tpu_torch.ops.spmv import spmv
from nsparse_tpu_torch.tune.plan import Plan, chip_key, matrix_fingerprint

# Per-sweep audit trail: one entry per candidate with its fate ("measured"
# with its ms, "scored" with its bytes, or the stage that dropped it).
# Reset by each autotune_spmv call.
SWEEP: list = []


def build_format(a: CSR, plan: Plan):
    """The format ``plan`` names, built from ``a`` on the host."""
    if plan.format == "ell":
        return ELL.from_csr(a, min_width=plan.min_width,
                            max_slabs=plan.max_slabs, sigma=plan.sigma,
                            xshuffle=plan.xshuffle)
    if plan.format == "bsr":
        return BSR.from_csr(a, blocksize=plan.blocksize)
    if plan.format == "dia":
        return DIA.from_csr(a)
    return a


def footprint(fmt) -> int:
    """Bytes of every tensor a format holds (its plans included)."""
    if isinstance(fmt, torch.Tensor):
        return fmt.numel() * fmt.element_size()
    if isinstance(fmt, (tuple, list)):
        return sum(footprint(f) for f in fmt)
    if dataclasses.is_dataclass(fmt) and not isinstance(fmt, type):
        return sum(footprint(getattr(fmt, f.name))
                   for f in dataclasses.fields(fmt))
    return 0


def _cand_repr(plan: Plan) -> str:
    bits = [plan.format]
    if plan.format == "ell":
        bits.append(f"w{plan.min_width}x{plan.max_slabs}")
        if plan.sigma is not None:
            bits.append(f"s{plan.sigma}")
        if plan.xshuffle:
            bits.append("xsh")
    if plan.format == "bsr":
        bits.append("x".join(map(str, plan.blocksize)))
    return "-".join(bits)


def _log_drop(plan: Plan, stage: str, why) -> None:
    """Say why a candidate left the search (a broken format must not look
    like a lost race)."""
    SWEEP.append({"cand": _cand_repr(plan), "fate": stage})
    print(f"[autotune] dropped candidate {_cand_repr(plan)} at {stage}: "
          f"{why}", file=sys.stderr)


def default_candidates(a: CSR) -> Iterable[Plan]:
    cands = [
        Plan(format="dia"),  # build_format raises for non-diagonal matrices
        Plan(format="csr"),
        Plan(format="ell", min_width=8, max_slabs=8, sigma=1024),
        Plan(format="ell", min_width=8, max_slabs=8, sigma=0),
        Plan(format="ell", min_width=8, max_slabs=8, sigma=256),
        Plan(format="ell", min_width=8, max_slabs=8, sigma=None),
        Plan(format="ell", min_width=16, max_slabs=6),
        Plan(format="ell", min_width=8, max_slabs=4),
        Plan(format="ell", min_width=32, max_slabs=8, sigma=1024),
        Plan(format="ell", min_width=8, max_slabs=8, sigma=1024,
             xshuffle=True),
    ]
    m, _ = a.shape
    if a.nnz / max(m, 1) >= 4:  # BSR only for rows that can fill tiles
        for bs in ((8, 128), (8, 256), (128, 128)):
            cands.append(Plan(format="bsr", blocksize=bs))
    return cands


def autotune_spmv(a: CSR, x: Optional[torch.Tensor] = None,
                  candidates: Optional[Sequence[Plan]] = None,
                  measure: bool = True, trials: int = 5,
                  max_bytes_ratio: Optional[float] = None,
                  cache_dir: Optional[str] = None, device="cuda"):
    """Pick the best SpMV format for ``a`` on ``device``.

    Returns (format on ``device``, Plan).  ``measure=True`` times each
    candidate with CUDA events (it needs a card); ``measure=False``
    scores by footprint.  ``max_bytes_ratio`` drops candidates whose
    footprint exceeds that multiple of CSR's before scoring (default 8 in
    model mode, 128 in measure mode).
    """
    device = torch.device(device)
    if measure and device.type != "cuda":
        raise RuntimeError("measure mode times on a card; use measure=False")
    chip = chip_key(device)
    key = matrix_fingerprint(a)
    if cache_dir:
        cached = Plan.load(cache_dir, key, chip)
        if cached is not None:
            return build_format(a, cached).to(device), cached
    if measure:
        if x is None:
            x = torch.from_numpy(
                np.random.default_rng(0).standard_normal(a.shape[1]))
        x = x.to(device=device, dtype=a.dtype)
    csr_bytes = footprint(a)
    SWEEP.clear()
    cap = max_bytes_ratio if max_bytes_ratio is not None else (
        128.0 if measure else 8.0)

    from nsparse_tpu_torch.utils.timing import time_cuda

    best_fmt, best_plan, best_score = None, None, float("inf")
    for plan in (candidates or default_candidates(a)):
        try:
            fmt = build_format(a, plan)
        except ValueError as e:  # e.g. DIA of a matrix that is not banded
            _log_drop(plan, "build", e)
            continue
        fb = footprint(fmt)
        if fb > cap * csr_bytes:
            _log_drop(plan, "footprint", f"{fb} > {cap:g}x csr ({csr_bytes})")
            continue
        plan = dataclasses.replace(plan, memory_bytes=fb, chip=chip,
                                   matrix_key=key, isPlan=True)
        if measure:
            fmt = fmt.to(device)
            score = time_cuda(lambda: spmv(fmt, x), trials=trials)
            plan = dataclasses.replace(plan, measured_ms=score)
            SWEEP.append({"cand": _cand_repr(plan), "fate": "measured",
                          "ms_per_op": score})
        else:
            score = float(fb)
            SWEEP.append({"cand": _cand_repr(plan), "fate": "scored",
                          "bytes": fb})
        if score < best_score:
            best_fmt, best_plan, best_score = fmt, plan, score

    if best_plan is None:  # every candidate dropped: raw CSR
        best_fmt = a
        best_plan = Plan(format="csr", chip=chip, matrix_key=key, isPlan=True)
    # model mode scored host formats; only the winner goes to the device
    # (.to() of a tensor already there is a no-op)
    best_fmt = best_fmt.to(device)
    if cache_dir:
        best_plan.save(cache_dir)
    return best_fmt, best_plan

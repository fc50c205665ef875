#!/usr/bin/env python3
"""What K10's time is made of, on one card: variants of
``nsparse_tpu_torch/csrc/windowed_gather.cu`` and two floor probes, timed
on the windowed-gather shapes of ``chip_smoke.py`` (262,144 rows).

    python3 tools/k10_variants.py [PARENT]    # from the repository root

Each variant is the source with a few lines replaced (``VARIANTS``),
built with the kernels' nvcc flags into ``_build/`` and called through
its C entry point; the source as built runs its direct and thread
routes, every other variant the direct route it rewrites: 1, 2 or 4
outputs a lane, streaming hints on the index vectors and the 16-byte
stores (``__ldcs``/``__stcs``), and the window staged in shared memory
by 16-byte ``cp.async`` copies before the gather (buffers of 1 KB and 4
KB a row, run at the windows that fit).  ``PARENT``, the root of another
checkout (an unpacked ``git archive``), adds that tree's K10 as
``parent`` (on its own route rule's route, or its one route before the
rule).  Per case, in turns (the source as it is first and last), each
result is held to the plain version bit for bit and timed by CUDA events
beside the bound (distinct window values), the 32-byte sector floor and
two probes that measure a floor instead of assuming it:
  random  as many reads a row as K10, at indices drawn from a hash of the
          slot (uniform over the window, as the data's are), so the same
          distinct sectors in distribution with no wait for an index,
          plus the index and output streams;
  copy    the index stream copied to the outputs, no window read.
The route rule of ``gather_tiles.windowed_gather_route`` takes what
these runs show (the fastest route at each window size).
"""

import ctypes
import os
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

_F32_OUT = "constexpr int kOutF32 = 4;"
_F64_OUT = "constexpr int kOutF64 = 2;"
# streaming hints on the vector branches (the cases here are aligned)
_HINTS = [
    ("*reinterpret_cast<const int4*>(p)",
     "__ldcs(reinterpret_cast<const int4*>(p))"),
    ("*reinterpret_cast<const int2*>(p)",
     "__ldcs(reinterpret_cast<const int2*>(p))"),
    ("*reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);",
     "__stcs(reinterpret_cast<float4*>(p), "
     "make_float4(v[0], v[1], v[2], v[3]));"),
    ("*reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);",
     "__stcs(reinterpret_cast<float2*>(p), make_float2(v[0], v[1]));"),
    ("*reinterpret_cast<double2*>(p + k) = make_double2(v[k], v[k + 1]);",
     "__stcs(reinterpret_cast<double2*>(p + k), "
     "make_double2(v[k], v[k + 1]));"),
]
# the row's window copied to shared memory (16-byte chunks: the cases'
# rows are 16-byte aligned), then gathered from there
_STAGE_COPY = r"""  __shared__ __align__(16) T stage[kWarps][STAGE_BYTES / sizeof(T)];
  T* st = stage[threadIdx.x >> 5];
  for (int c = lane; c * 16 < window * static_cast<int>(sizeof(T));
       c += 32) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
        static_cast<unsigned>(__cvta_generic_to_shared(st)) + 16 * c),
        "l"(reinterpret_cast<const char*>(row) + 16 * c) : "memory");
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
"""
_STAGE_WAIT = """  asm volatile("cp.async.wait_group 0;\\n" ::: "memory");
  __syncwarp();
"""
_IP = "  const int32_t* ip = idx + t * kLanes + lane * kOut;\n"
_V = "  T v[turns<T>()][kOut];\n"


def staged(nbytes: int) -> list:
    """The direct route's window staged in an ``nbytes`` buffer a row."""
    return [(_IP, _STAGE_COPY.replace("STAGE_BYTES", str(nbytes)) + _IP),
            (_V, _STAGE_WAIT + _V), ("__ldg(row + jk)", "st[jk]")]


VARIANTS = {
    "as built": [],
    "f64 4 outputs a lane": [(_F64_OUT, "constexpr int kOutF64 = 4;")],
    "f32 2 outputs a lane": [(_F32_OUT, "constexpr int kOutF32 = 2;")],
    "1 output a lane": [(_F32_OUT, "constexpr int kOutF32 = 1;"),
                        (_F64_OUT, "constexpr int kOutF64 = 1;")],
    "streaming hints": _HINTS,
    "staged 1 KB": staged(1024),
    "staged 4 KB": staged(4096),
}
ORDER = ("as built", "f64 4 outputs a lane", "f32 2 outputs a lane",
         "1 output a lane", "streaming hints", "staged 1 KB", "staged 4 KB",
         "as built")
STAGE_CAP = {"staged 1 KB": 1024, "staged 4 KB": 4096}  # their buffers
ROUTES = {"direct": 0, "thread": 1}
# (window, dtype): f32 from one line (128 B) to 4 KB, f64 to 8 KB
CASES = ((32, np.float32), (128, np.float32), (256, np.float32),
         (512, np.float32), (1024, np.float32), (32, np.float64),
         (64, np.float64), (128, np.float64), (512, np.float64),
         (1024, np.float64))
ROWS = 262_144
TRIALS = 20
PROBES = r"""
// Floor probes for K10 (tools/k10_variants.py): a warp per row of 128
// outputs, a lane 4 of them, kWarps rows a block.
#include "common.cuh"

namespace {

constexpr int kWarps = 8;

__device__ __forceinline__ void put4(float* p, float a, float b, float c,
                                     float d) {
  __stcs(reinterpret_cast<float4*>(p), make_float4(a, b, c, d));
}

__device__ __forceinline__ void put4(double* p, double a, double b,
                                     double c, double d) {
  __stcs(reinterpret_cast<double2*>(p), make_double2(a, b));
  __stcs(reinterpret_cast<double2*>(p) + 1, make_double2(c, d));
}

// the index stream to the outputs, no window read
template <typename T>
__global__ void __launch_bounds__(32 * kWarps)
copy_probe(const int32_t* __restrict__ idx, int64_t rows,
           T* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int64_t t = static_cast<int64_t>(blockIdx.x) * kWarps +
                    (threadIdx.x >> 5);
  if (t >= rows) return;
  const int4 q = __ldcs(reinterpret_cast<const int4*>(idx + t * 128) + lane);
  put4(out + t * 128 + lane * 4, T(q.x), T(q.y), T(q.z), T(q.w));
}

__device__ __forceinline__ unsigned mix(unsigned x) {
  x ^= x >> 16; x *= 0x7feb352du; x ^= x >> 15; x *= 0x846ca68bu;
  return x ^ (x >> 16);
}

// K10's reads at hashed indices, uniform over the window (no index wait),
// beside the index and output streams
template <typename T>
__global__ void __launch_bounds__(32 * kWarps)
random_probe(const T* __restrict__ win, int64_t win_cols, int window,
             const int32_t* __restrict__ idx, int64_t rows,
             T* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int64_t t = static_cast<int64_t>(blockIdx.x) * kWarps +
                    (threadIdx.x >> 5);
  if (t >= rows) return;
  const int4 q = __ldcs(reinterpret_cast<const int4*>(idx + t * 128) + lane);
  const T* row = win + t * win_cols;
  const unsigned s = static_cast<unsigned>(t * 128 + lane * 4);
  const T a = __ldg(row + mix(s) % window);
  const T b = __ldg(row + mix(s + 1) % window);
  const T c = __ldg(row + mix(s + 2) % window);
  const T d = __ldg(row + mix(s + 3) % window);
  put4(out + t * 128 + lane * 4, a + T(q.x), b + T(q.y), c + T(q.z),
       d + T(q.w));
}

template <typename T>
int copy_entry(const void* idx, int64_t rows, void* out, void* stream) {
  copy_probe<T><<<nsp::blocks_for(rows, kWarps), 32 * kWarps, 0,
                  nsp::as_stream(stream)>>>(
      static_cast<const int32_t*>(idx), rows, static_cast<T*>(out));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int random_entry(const void* win, int64_t win_cols, int window,
                 const void* idx, int64_t rows, void* out, void* stream) {
  random_probe<T><<<nsp::blocks_for(rows, kWarps), 32 * kWarps, 0,
                    nsp::as_stream(stream)>>>(
      static_cast<const T*>(win), win_cols, window,
      static_cast<const int32_t*>(idx), rows, static_cast<T*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

NSP_EXPORT int probe_copy_f32(const void* i, int64_t r, void* o, void* s) {
  return copy_entry<float>(i, r, o, s);
}
NSP_EXPORT int probe_copy_f64(const void* i, int64_t r, void* o, void* s) {
  return copy_entry<double>(i, r, o, s);
}
NSP_EXPORT int probe_random_f32(const void* w, int64_t c, int n,
                                const void* i, int64_t r, void* o, void* s) {
  return random_entry<float>(w, c, n, i, r, o, s);
}
NSP_EXPORT int probe_random_f64(const void* w, int64_t c, int n,
                                const void* i, int64_t r, void* o, void* s) {
  return random_entry<double>(w, c, n, i, r, o, s);
}
"""

_P, _I64, _I32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int


def build(tag: str, text: str, entries: dict):
    """The library built from ``text``, its entry points typed."""
    from nsparse_tpu_torch.buildlib import BUILD_DIR, build_shared
    from nsparse_tpu_torch.ops.kernels.cuda_lib import (
        CSRC_DIR, NVCC_FLAGS, nvcc)

    src_dir = os.path.join(BUILD_DIR, "k10_variants")
    os.makedirs(src_dir, exist_ok=True)
    src = os.path.join(src_dir, f"windowed_gather_{tag}.cu")
    with open(src, "w") as f:
        f.write(text)
    try:
        lib = build_shared(f"libk10_{tag}", [src],
                           [nvcc(), *NVCC_FLAGS, "-I", CSRC_DIR], timeout=900)
    except subprocess.CalledProcessError as e:
        sys.exit(f"k10_variants: {tag} does not build:\n{e.stderr[-4000:]}")
    fns = {}
    for name, argtypes in entries.items():
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
        fns[name] = fn
    return fns


def variant_text(name: str, text: str) -> str:
    for old, new in VARIANTS[name]:
        if old not in text:
            sys.exit(f"k10_variants: {name}: {old!r} is not in the source")
        text = text.replace(old, new)
    return text


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        sys.exit("k10_variants: torch.cuda.is_available() is false")
    from nsparse_tpu_torch.ops.kernels.cuda_lib import CSRC_DIR
    from nsparse_tpu_torch.ops.kernels.gather_tiles import (
        windowed_gather_plain, windowed_gather_route)
    from nsparse_tpu_torch.utils.roofline import chip_specs
    from nsparse_tpu_torch.utils.timing import time_cuda

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(card, flush=True)
    k10 = [_P, _I64, _P, _I32, _I64, _P, _I32, _P]
    jobs = {}
    with open(os.path.join(CSRC_DIR, "windowed_gather.cu")) as f:
        text = f.read()
    for name in VARIANTS:
        jobs[name] = (re.sub(r"\W+", "_", name), variant_text(name, text),
                      {f"nsp_windowed_gather_{x}": k10
                       for x in ("f32", "f64")})
    jobs["probes"] = ("probes", PROBES, {
        **{f"probe_copy_{x}": [_P, _I64, _P, _P] for x in ("f32", "f64")},
        **{f"probe_random_{x}": [_P, _I64, _I32, _P, _I64, _P, _P]
           for x in ("f32", "f64")}})
    order = list(ORDER)
    parent_routes = False  # whether the parent's entry takes a route
    if len(sys.argv) > 1:
        with open(os.path.join(sys.argv[1], "nsparse_tpu_torch", "csrc",
                               "windowed_gather.cu")) as f:
            parent = f.read()
        parent_routes = "int route" in parent
        jobs["parent"] = ("parent", parent, {
            f"nsp_windowed_gather_{x}": k10 if parent_routes
            else k10[:6] + [_P] for x in ("f32", "f64")})
        order = ["parent"] + order + ["parent"]
    with ThreadPoolExecutor(len(jobs)) as pool:
        libs = dict(zip(jobs, pool.map(lambda j: build(*j), jobs.values())))

    dev = torch.device("cuda:0")
    bw = chip_specs(torch.cuda.get_device_name(0)).hbm_gbps * 1e9
    stream = torch.cuda.current_stream(dev).cuda_stream
    for w, dtype in CASES:
        rng = np.random.default_rng(w)
        win = torch.from_numpy(rng.standard_normal(
            (ROWS, max(w, 128)), dtype=dtype)).to(dev)
        idx = torch.from_numpy(rng.integers(0, w, (ROWS, 128)).astype(
            np.int32)).to(dev)
        want = windowed_gather_plain(win, idx, w)
        out = torch.empty_like(want)
        vb, sfx = win.element_size(), "f32" if dtype == np.float32 else "f64"
        rows = torch.arange(ROWS, device=dev)[:, None]
        j = idx.long()
        values = int(torch.unique(rows * w + j).numel())
        sectors = int(torch.unique((rows * win.shape[1] + j) * vb // 32)
                      .numel())
        streams = idx.numel() * (4 + vb)
        bound = (streams + values * vb) / bw * 1e3
        floor = (streams + sectors * 32) / bw * 1e3
        span = -(-w * vb // 32)
        rule = {v: k for k, v in ROUTES.items()}[windowed_gather_route(w, vb)]
        what = f"w {w} {sfx}"
        print(f"{what} [{card}]: bound {bound:.4f} ms, 32-byte sector floor "
              f"{floor:.4f} ms ({sectors / ROWS:.2f} of {span} sectors a "
              f"row); route rule: {rule}", flush=True)
        ptrs = (win.data_ptr(), win.shape[1], idx.data_ptr(), w, ROWS,
                out.data_ptr())
        runs = []
        for name in order:
            fn = libs[name][f"nsp_windowed_gather_{sfx}"]
            if name == "parent":
                route = (ROUTES[rule],) if parent_routes else ()
                runs.append((name, lambda fn=fn, r=route: fn(*ptrs, *r,
                                                             stream)))
                continue
            if w * vb > STAGE_CAP.get(name, w * vb):
                continue  # the window does not fit the variant's buffer
            if name != "as built":
                runs.append((name, lambda fn=fn: fn(*ptrs, ROUTES["direct"],
                                                    stream)))
                continue
            for r in ROUTES:
                runs.append((f"{name}, {r}", lambda fn=fn, r=r: fn(
                    *ptrs, ROUTES[r], stream)))
        probes = libs["probes"]
        runs.append(("probe: random", lambda: probes[f"probe_random_{sfx}"](
            win.data_ptr(), win.shape[1], w, idx.data_ptr(), ROWS,
            out.data_ptr(), stream)))
        runs.append(("probe: copy", lambda: probes[f"probe_copy_{sfx}"](
            idx.data_ptr(), ROWS, out.data_ptr(), stream)))
        for label, run in runs:
            out.fill_(float("nan"))
            rc = run()
            if rc:
                sys.exit(f"k10_variants: {what} {label}: CUDA error {rc}")
            torch.cuda.synchronize()
            ok = "" if label.startswith("probe") else \
                "  equal" if torch.equal(out, want) else "  DIFFERS"
            ms = time_cuda(run, trials=TRIALS)
            print(f"  {what} {label} [{card}]: {ms:.4f} ms by CUDA events "
                  f"({100 * bound / ms:.0f}% of the bound, "
                  f"{100 * floor / ms:.0f}% of the sector floor){ok}",
                  flush=True)
            if "DIFFERS" in ok:
                sys.exit(f"k10_variants: {what} {label} differs from the "
                         "plain version")


if __name__ == "__main__":
    main()

"""Builds shared libraries at first use into the package's ``_build/``.

Both native parts of the port go through here: the host planner (g++ on
the port's ``native/*.cpp``) and the Hopper kernels (nvcc on
``csrc/*.cu``).  A library is named by a hash of its sources and flags, so
an edited source builds anew; a file lock keeps concurrent processes (test
workers) from building the same library twice, and the compiler writes to
a temporary name that is renamed into place only when it succeeded.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import subprocess

from nsparse_tpu_torch.utils import profiling

PKG_DIR = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(PKG_DIR, "_build")


def build_shared(name: str, sources, cmd_prefix, timeout: float, deps=()):
    """Compile ``sources`` into ``_build/<name>-<hash>.so`` if missing and
    return the loaded ``ctypes.CDLL``.

    ``cmd_prefix`` is the compiler command without output and sources, e.g.
    ``["g++", "-O3", "-shared", "-fPIC"]``; ``deps`` are headers the
    sources include (hashed, not compiled).  Raises
    ``subprocess.CalledProcessError`` (with the compiler's output) or
    ``FileNotFoundError`` when the compiler is missing.

    Recorded (``utils.profiling``) as the span ``build`` and the counter
    ``build.compiled`` or ``build.cached``.
    """
    with profiling.span("build"):
        h = hashlib.sha256(" ".join(cmd_prefix).encode())
        for src in (*sources, *deps):
            with open(src, "rb") as f:
                h.update(f.read())
        os.makedirs(BUILD_DIR, exist_ok=True)
        path = os.path.join(BUILD_DIR, f"{name}-{h.hexdigest()[:16]}.so")
        with open(os.path.join(BUILD_DIR, f"{name}.lock"), "w") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)
            try:
                compiled = not os.path.exists(path)
                profiling.count("build.compiled" if compiled
                                else "build.cached")
                if compiled:
                    tmp = f"{path}.{os.getpid()}.tmp"
                    try:
                        subprocess.run(
                            [*cmd_prefix, "-o", tmp, *sources], check=True,
                            capture_output=True, text=True, timeout=timeout,
                        )
                        os.replace(tmp, path)
                    finally:
                        if os.path.exists(tmp):
                            os.remove(tmp)
            finally:
                fcntl.flock(lock, fcntl.LOCK_UN)
        return ctypes.CDLL(path)

"""SuiteSparse collection access by ``Group/Name`` (counterpart of
``nsparse_tpu/io/suitesparse.py``).

``fetch`` reads ``<Name>.mtx`` from the cache directory; without it, it
downloads ``<Group>/<Name>.tar.gz`` from the collection's mirror, caches
the extracted ``.mtx`` and reads that.  Offline, place ``<Name>.mtx`` in
the cache directory: the cache is looked at before the network, and a
failed download raises an error that names the file and the directory.
"""

from __future__ import annotations

import io
import os
import tarfile
import urllib.request

from nsparse_tpu_torch.formats.csr import CSR
from nsparse_tpu_torch.io.matrix_market import read_mtx

_BASE = "https://suitesparse-collection-website.herokuapp.com/MM"
_DEFAULT_CACHE = os.path.join(
    os.path.expanduser("~"), ".cache", "nsparse_tpu_torch", "suitesparse")


def fetch(name: str, cache_dir: str | None = None, dtype=None) -> CSR:
    """Load ``Group/Name`` (e.g. ``"HB/west0479"``) as CSR (float64 when
    ``dtype`` is None), from ``cache_dir`` (default
    ``~/.cache/nsparse_tpu_torch/suitesparse``) or the collection."""
    if "/" not in name:
        raise ValueError(f"expected 'Group/Name', got {name!r}")
    group, mname = name.split("/", 1)
    cache_dir = cache_dir or _DEFAULT_CACHE
    path = os.path.join(cache_dir, f"{mname}.mtx")
    if not os.path.exists(path):
        os.makedirs(cache_dir, exist_ok=True)
        url = f"{_BASE}/{group}/{mname}.tar.gz"
        try:
            with urllib.request.urlopen(url, timeout=60) as r:
                blob = r.read()
        except Exception as e:  # any failure to download: say what to do
            raise RuntimeError(
                f"cannot fetch {name} ({e}); offline? place {mname}.mtx "
                f"in {cache_dir}") from e
        with tarfile.open(fileobj=io.BytesIO(blob), mode="r:gz") as tf:
            member = next(m for m in tf.getmembers()
                          if m.name.endswith(f"{mname}.mtx"))
            data = tf.extractfile(member).read()
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            f.write(data)
        os.replace(tmp, path)
    return read_mtx(path, dtype=dtype)

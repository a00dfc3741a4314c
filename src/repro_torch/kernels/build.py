"""Build the package's CUDA sources at first use and load them with ctypes.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for Hopper (``sm_90a``) into
a shared library with a plain C interface::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -Xptxas -v -o <build>/<name>.<hash>.so csrc/<name>.cu

The library's file name carries a hash of the source and of every header
under ``csrc/`` (``*.cuh``, ``*.h``; a source may include any of them), so
an edited source or header is rebuilt and an unchanged one is loaded as it
is.  Builds go to ``build/repro_torch_kernels/`` at the repository root
(``REPO/build`` is ignored by git).  A missing ``nvcc`` or a failed compile
raises; there is no fallback.  ``ptxas``'s register and shared-memory report
is kept beside each library as ``<name>.<hash>.log``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, Tuple

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_loaded: Dict[str, ctypes.CDLL] = {}


def sources() -> Tuple[str, ...]:
    """Names of every CUDA source the package ships."""
    return tuple(sorted(p.stem for p in CSRC.glob("*.cu")))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): "
                       "the CUDA kernels cannot be built")


def headers() -> Tuple[Path, ...]:
    """Every header under ``csrc/``, in a fixed order."""
    return tuple(sorted(p for pat in ("*.cuh", "*.h") for p in CSRC.glob(pat)))


def library_path(name: str) -> Path:
    """``<build>/<name>.<hash>.so``: the hash covers the source and every
    header under ``csrc/`` (names and contents)."""
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for hdr in headers():
        h.update(hdr.name.encode() + b"\0" + hdr.read_bytes())
    return BUILD_DIR / f"{name}.{h.hexdigest()[:16]}.so"


def _start(name: str):
    """Start compiling ``name`` unless its library for this source exists;
    returns ``(library path, process or None)``."""
    lib = library_path(name)
    if lib.exists():
        return lib, None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    return lib, (proc, tmp)


def _finish(name: str, lib: Path, job) -> None:
    if job is None:
        return
    proc, tmp = job
    out, _ = proc.communicate()
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed on {name}.cu (exit {proc.returncode}):\n{out}")
    lib.with_suffix(".log").write_text(out)
    os.replace(tmp, lib)            # atomic: a concurrent loader sees all or nothing


def build(names: Iterable[str] = ()) -> float:
    """Compile the named sources (default: all) in parallel, one ``nvcc``
    each, all started together.  Returns the wall seconds the builds took
    (0 when every library was already built)."""
    names = tuple(names) or sources()
    t0 = time.perf_counter()
    jobs = [(n, *_start(n)) for n in names]
    for name, lib, job in jobs:
        _finish(name, lib, job)
    return time.perf_counter() - t0


def build_log(name: str) -> str:
    """``nvcc``'s output (``ptxas -v``) from the build of ``name``'s current source."""
    log = library_path(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        build([name])
        lib = _loaded[name] = ctypes.CDLL(str(library_path(name)))
    return lib

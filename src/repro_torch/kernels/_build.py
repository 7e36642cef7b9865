"""Build the port's CUDA kernels with ``nvcc`` and load them with ``ctypes``.

Each kernel is one ``.cu`` source with a plain C interface, compiled for
Hopper (``-gencode arch=compute_90a,code=sm_90a``) into a shared library
under ``build/`` at the repository root.  The library's file name carries
a hash of its source, so an edited kernel rebuilds and an unchanged one is
reused.  Nothing is built at import time: ``load`` builds on first use.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent
_ROOT = _PKG.parents[2]                 # src/repro_torch/kernels -> repo root
BUILD_DIR = _ROOT / "build"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                       "machine with the CUDA toolkit")


def build(source: str) -> tuple[Path, float, str]:
    """Compile ``source`` (a ``.cu`` path relative to this package) unless
    an up-to-date library exists.  Returns (library, seconds, nvcc output);
    seconds is 0.0 when the library was reused.  Raises with nvcc's output
    if the build fails."""
    src = _PKG / source
    digest = hashlib.sha1(src.read_bytes()).hexdigest()[:12]
    lib = BUILD_DIR / f"lib{src.stem}-{digest}.so"
    if lib.exists():
        return lib, 0.0, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    t0 = time.perf_counter()
    proc = subprocess.run([nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
                          capture_output=True, text=True)
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {source} "
                           f"(exit {proc.returncode}):\n{log}")
    os.replace(tmp, lib)
    return lib, time.perf_counter() - t0, log


@functools.lru_cache(maxsize=None)
def load(source: str) -> ctypes.CDLL:
    """The kernel library built from ``source``, built on first use."""
    return ctypes.CDLL(str(build(source)[0]))

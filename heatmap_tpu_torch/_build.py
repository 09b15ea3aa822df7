"""Build and load the port's CUDA kernels.

Each ``csrc/*.cu`` source that a module names is compiled on first use with
``nvcc`` for Hopper (``sm_90a``) into a shared library with a plain C
interface, and loaded with ``ctypes``.  The library lands in
``build/heatmap_tpu_torch/`` under the repository root, named by the hash of
its source and flags, so an edited source is rebuilt and an unchanged one is
loaded as it is.  A missing ``nvcc`` or a failed build raises: no caller
gets a plain version in place of a kernel.

Kernels are compiled with ``-fmad=false`` and without fast math, so that
their float arithmetic rounds op by op as their plain PyTorch versions do.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parent
BUILD_DIR = PKG_DIR.parent / "build" / "heatmap_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC")

_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}


class KernelBuildError(RuntimeError):
    pass


def find_nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None:
        cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
        if cand.exists():
            nvcc = str(cand)
    if nvcc is None:
        raise KernelBuildError("nvcc not found (PATH, CUDA_HOME, "
                               "/usr/local/cuda/bin): cannot build kernels")
    return nvcc


def library_path(source: str) -> Path:
    """Where ``source`` (a path relative to the package) builds to."""
    src = PKG_DIR / source
    h = hashlib.sha256(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{src.stem}-{h.hexdigest()[:16]}.so"


def build(source: str) -> Path:
    """Compile ``source`` unless a library of the same hash exists."""
    out = library_path(source)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(PKG_DIR / source)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise KernelBuildError(
            f"nvcc failed for {source} (exit {proc.returncode}):\n"
            f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return out


def load(source: str) -> ctypes.CDLL:
    """The loaded library of ``source``, built first if needed."""
    with _lock:
        lib = _loaded.get(source)
        if lib is None:
            lib = ctypes.CDLL(str(build(source)))
            _loaded[source] = lib
        return lib


# every kernel source of the package, built together by ``build_all``
KERNEL_SOURCES = ("hexgrid/csrc/snap_geometry.cu",)


def build_all() -> dict[str, Path]:
    """Build every kernel source at once (one ``nvcc`` each, started
    together); raises on the first failure."""
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(max_workers=len(KERNEL_SOURCES)) as pool:
        futs = {s: pool.submit(build, s) for s in KERNEL_SOURCES}
        return {s: f.result() for s, f in futs.items()}

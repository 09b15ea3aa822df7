"""Build and load the port's CUDA kernels and its native host codecs.

Each ``csrc/*.cu`` source that a module names is compiled on first use with
``nvcc`` for Hopper (``sm_90a``) into a shared library with a plain C
interface, and loaded with ``ctypes``.  The host C++ codecs
(``native/*.cpp``: the JSON-lines decoder, the Kafka record codec with its
CRC32C, the BSON encoders of tile and position ops, the f64 H3 snap) build
with ``g++``
into one library, ``NATIVE_LIB``, with the reference's flags.  Every
library lands in ``build_dir()``: the directory ``HEATMAP_NATIVE_CACHE``
names, read at each build as the reference reads it, else
``build/heatmap_tpu_torch/`` under the repository root.  It is named by
the hash of its sources and flags, so an edited source is rebuilt and an
unchanged one is loaded as it is.  A missing compiler or a failed
build raises with the command and its output: no caller gets a plain
version in place of a kernel or a codec.

Kernels are compiled with ``-fmad=false`` and without fast math, so that
their float arithmetic rounds op by op as their plain PyTorch versions do.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import shutil
import subprocess
import threading
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parent
BUILD_DIR = PKG_DIR.parent / "build" / "heatmap_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC")
# the reference's g++ command (heatmap_tpu/native/__init__.py); SSE4.2 is
# the hardware CRC32C of kafka_codec.cpp
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17") + (
    ("-msse4.2",) if platform.machine().lower() in ("x86_64", "amd64")
    else ())
# the host C++ codecs, one library (``load(NATIVE_LIB)``)
NATIVE_LIB = "native"
NATIVE_SOURCES = ("native/decoder.cpp", "native/tile_ops.cpp",
                  "native/kafka_codec.cpp", "native/positions_ops.cpp",
                  "native/h3_snap.cpp")

_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}
# libraries this process has built or loaded (``load`` of a source not
# loaded before): the compile tracker's probe (obs.runtimeinfo)
_n_loads = 0


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


def find_gxx() -> str:
    gxx = shutil.which("g++")
    if gxx is None:
        raise KernelBuildError("g++ not found on PATH: cannot build the "
                               "native host codecs")
    return gxx


def _sources(source: str) -> tuple[str, ...]:
    return NATIVE_SOURCES if source == NATIVE_LIB else (source,)


def build_dir() -> Path:
    """Where libraries build: ``HEATMAP_NATIVE_CACHE`` when set and not
    empty, else ``BUILD_DIR``."""
    return Path(os.environ.get("HEATMAP_NATIVE_CACHE") or BUILD_DIR)


def library_path(source: str) -> Path:
    """Where ``source`` (a path relative to the package, or ``NATIVE_LIB``)
    builds to."""
    native = source == NATIVE_LIB
    h = hashlib.sha256()
    for src in _sources(source):
        h.update((PKG_DIR / src).read_bytes())
    h.update(" ".join(GXX_FLAGS if native else NVCC_FLAGS).encode())
    stem = NATIVE_LIB if native else Path(source).stem
    return build_dir() / f"{stem}-{h.hexdigest()[:16]}.so"


def build(source: str) -> Path:
    """Compile ``source`` unless a library of the same hash exists."""
    out = library_path(source)
    if out.exists():
        return out
    srcs = [str(PKG_DIR / s) for s in _sources(source)]
    cmd = ([find_gxx(), *GXX_FLAGS] if source == NATIVE_LIB
           else [find_nvcc(), *NVCC_FLAGS]) + srcs
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run([*cmd, "-o", str(tmp)], capture_output=True,
                          text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise KernelBuildError(
            f"build of {source} failed (exit {proc.returncode}): "
            f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return out


def load(source: str) -> ctypes.CDLL:
    """The loaded library of ``source``, built first if needed.  Loaded
    with ``RTLD_LOCAL`` (ctypes' default), so its symbols never bind to
    another library that exports the same names."""
    global _n_loads
    with _lock:
        lib = _loaded.get(source)
        if lib is None:
            lib = ctypes.CDLL(str(build(source)))
            _loaded[source] = lib
            _n_loads += 1
        return lib


def loads() -> int:
    """Libraries built or loaded by this process so far."""
    return _n_loads


# every kernel source of the package, built together by ``build_all``
KERNEL_SOURCES = ("hexgrid/csrc/snap_cell.cu",
                  "infer/csrc/kalman_rounds.cu")


def build_all() -> dict[str, tuple[Path, float]]:
    """Build every kernel source and the native library at once (one
    compiler each, started together); {source: (library, seconds)}.
    Raises on the first failure."""
    import time
    from concurrent.futures import ThreadPoolExecutor

    def timed(source):
        t0 = time.monotonic()
        return build(source), time.monotonic() - t0

    names = (*KERNEL_SOURCES, NATIVE_LIB)
    with ThreadPoolExecutor(max_workers=len(names)) as pool:
        futs = {s: pool.submit(timed, s) for s in names}
        return {s: f.result() for s, f in futs.items()}

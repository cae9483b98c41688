"""Build ``adaa_tpu_torch/csrc/*.cu`` with nvcc (and the host library
``csrc/*.cpp`` with the host C++ compiler) and load them with ctypes.

Each source is a file with a plain C interface (no PyTorch headers), so
a build takes seconds. A ``.cu`` source is compiled for ``sm_90a``
(Hopper), a ``.cpp`` one with ``g++`` (``CXX``), into
``adaa_tpu_torch/_build/lib<name>.so`` at first use, and again whenever
the source or any header beside it (``csrc/*.cuh`` for a ``.cu``) is
newer than the library. Each build writes a temporary file of its own
process and renames it into place, so processes that build at once (test
workers) never load half a library. Nothing is built when the package
is imported: the CPU tests import every module on machines without
``nvcc``.
"""
from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict

PKG_DIR = Path(__file__).resolve().parent.parent
SRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
# the flags of the JAX package's native/Makefile
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-Wall", "-shared")

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def nvcc_path() -> str:
    """nvcc from PATH, else under CUDA_HOME (default /usr/local/cuda)."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError(f"nvcc not found on PATH or at {path}")
    return str(path)


def cxx_path() -> str:
    """The host C++ compiler: ``CXX``, else ``g++`` from PATH."""
    found = shutil.which(os.environ.get("CXX", "g++"))
    if not found:
        raise RuntimeError("no host C++ compiler: g++ not found on PATH (set CXX)")
    return found


def stale(lib: Path, src: Path) -> bool:
    """Whether ``lib`` is missing or older than ``src`` or, for a ``.cu``
    source, a header (``*.cuh``) in its directory, which every kernel may
    include."""
    if not lib.exists():
        return True
    headers = src.parent.glob("*.cuh") if src.suffix == ".cu" else ()
    newest = max(p.stat().st_mtime for p in (src, *headers))
    return lib.stat().st_mtime < newest


def source(name: str, src_dir: Path = SRC_DIR) -> Path:
    """The host source ``<src_dir>/<name>.cpp`` if there is one, else ``<name>.cu``."""
    cpp = src_dir / f"{name}.cpp"
    return cpp if cpp.exists() else src_dir / f"{name}.cu"


def build(name: str, src_dir: Path = SRC_DIR, build_dir: Path = BUILD_DIR) -> Path:
    """Compile ``<src_dir>/<name>.cu`` (nvcc) or ``<name>.cpp`` (the host
    compiler) unless the library is up to date.

    The compiler's output (for nvcc, ``-Xptxas -v``: registers, shared
    memory, spills) is kept beside the library as ``lib<name>.log``.
    """
    src = source(name, src_dir)
    lib = build_dir / f"lib{name}.so"
    if not stale(lib, src):
        return lib
    build_dir.mkdir(parents=True, exist_ok=True)
    tmp = build_dir / f"lib{name}.{os.getpid()}.so"
    if src.suffix == ".cu":
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
    else:
        cmd = [cxx_path(), *CXX_FLAGS, "-o", str(tmp), str(src)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    (build_dir / f"lib{name}.log").write_text(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"{Path(cmd[0]).name} failed ({proc.returncode}) for {src}:\n{proc.stderr[-4000:]}"
        )
    os.replace(tmp, lib)  # atomic: a concurrent loader never sees half a file
    return lib


def build_all(names) -> Dict[str, float]:
    """Build several sources at once, one compiler process each; the
    seconds each build took, by name (about 0 for a library that was up
    to date)."""

    def timed(name: str):
        t0 = time.perf_counter()
        build(name)
        return name, time.perf_counter() - t0

    with ThreadPoolExecutor(max_workers=len(names)) as pool:
        return dict(pool.map(timed, names))


def load(name: str) -> ctypes.CDLL:
    """The built library for ``csrc/<name>.cu`` (or ``.cpp``), building it
    on first use."""
    with _LOCK:
        if name not in _LIBS:
            _LIBS[name] = ctypes.CDLL(str(build(name)))
        return _LIBS[name]


def build_log(name: str) -> str:
    path = BUILD_DIR / f"lib{name}.log"
    return path.read_text() if path.exists() else ""

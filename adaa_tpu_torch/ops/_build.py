"""Build ``adaa_tpu_torch/csrc/*.cu`` with nvcc and load them with ctypes.

Each source is a file with a plain C interface (no PyTorch headers), so
a build takes seconds. It is compiled for ``sm_90a`` (Hopper) into
``adaa_tpu_torch/_build/lib<name>.so`` at first use, and again whenever
the source or any header beside it (``csrc/*.cuh``) is newer than the
library. Nothing is built when the package
is imported: the CPU tests import every module on machines without
``nvcc``.
"""
from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
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


def stale(lib: Path, src: Path) -> bool:
    """Whether ``lib`` is missing or older than ``src`` or a header
    (``*.cuh``) in ``src``'s directory, which every source may include."""
    if not lib.exists():
        return True
    newest = max(p.stat().st_mtime for p in (src, *src.parent.glob("*.cuh")))
    return lib.stat().st_mtime < newest


def build(name: str, src_dir: Path = SRC_DIR, build_dir: Path = BUILD_DIR) -> Path:
    """Compile ``<src_dir>/<name>.cu`` unless the library is up to date.

    The compiler's output (``-Xptxas -v``: registers, shared memory,
    spills) is kept beside the library as ``lib<name>.log``.
    """
    src = src_dir / f"{name}.cu"
    lib = build_dir / f"lib{name}.so"
    if not stale(lib, src):
        return lib
    build_dir.mkdir(parents=True, exist_ok=True)
    tmp = build_dir / f"lib{name}.{os.getpid()}.so"
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    (build_dir / f"lib{name}.log").write_text(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}) for {src}:\n{proc.stderr[-4000:]}"
        )
    os.replace(tmp, lib)  # atomic: a concurrent loader never sees half a file
    return lib


def build_all(names) -> None:
    """Build several sources at once, one nvcc process each."""
    with ThreadPoolExecutor(max_workers=len(names)) as pool:
        list(pool.map(build, names))


def load(name: str) -> ctypes.CDLL:
    """The built library for ``csrc/<name>.cu``, building it on first use."""
    with _LOCK:
        if name not in _LIBS:
            _LIBS[name] = ctypes.CDLL(str(build(name)))
        return _LIBS[name]


def build_log(name: str) -> str:
    path = BUILD_DIR / f"lib{name}.log"
    return path.read_text() if path.exists() else ""

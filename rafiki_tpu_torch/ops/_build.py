"""Build and load the port's CUDA kernels (``csrc/*.cu``).

Each source compiles with ``nvcc`` into a shared library with a plain C
interface, loaded through ``ctypes`` — seconds to build, where a source
that includes PyTorch's headers takes minutes. The build happens at first
use, into ``build/rafiki_tpu_torch/`` beside the package (a directory
``.gitignore`` lists), and again whenever the source or a header of
``csrc/`` (``*.cuh``, which sources share) is newer than the library.
Nothing here is imported or compiled when a module is imported: the CPU
tests import every module on hosts without ``nvcc``.

There is no fallback: a missing ``nvcc`` or a failed build raises, and a
kernel wrapper that asked for the library raises with it.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Sequence

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "rafiki_tpu_torch"
#: Hopper only: keep the ``a`` (wgmma/setmaxnreg live only in sm_90a)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    """``nvcc`` from ``PATH``, else from ``$CUDA_HOME`` or the toolkit's
    standard prefix; raises ``RuntimeError`` when there is none."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): the "
        "CUDA kernels cannot be built on this host")


def lib_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}.so"


def build(name: str, extra_flags: Sequence[str] = ()) -> str:
    """Compile ``csrc/<name>.cu`` into ``build/.../lib<name>.so`` and
    return nvcc's output (``-Xptxas -v`` in ``extra_flags`` makes it
    report registers, shared memory and spills). Writes to a temporary
    name and renames, so a concurrent loader never sees half a file."""
    nvcc = nvcc_path()
    src = CSRC / f"{name}.cu"
    out = lib_path(name)
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc, *NVCC_FLAGS, *extra_flags, "-o", str(tmp), str(src)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed building {src.name} "
                           f"(exit {proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, out)
    return proc.stdout + proc.stderr


def library(name: str) -> ctypes.CDLL:
    """The loaded ``lib<name>.so``, built first if it is missing or
    older than its source or a shared header."""
    with _lock:
        lib = _libs.get(name)
        if lib is not None:
            return lib
        out = lib_path(name)
        src = CSRC / f"{name}.cu"
        newest = max(f.stat().st_mtime
                     for f in (src, *CSRC.glob("*.cuh")))
        if not out.is_file() or out.stat().st_mtime < newest:
            build(name)
        lib = ctypes.CDLL(str(out))
        _libs[name] = lib
        return lib

"""Build the port's CUDA kernels from ``csrc/`` at first use.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by ``nvcc``
into its own shared library under ``opticalflow_tpu_torch/_build/`` (listed
in ``.gitignore``), then loaded with ``ctypes``.  The library's file name
carries a digest of the sources and flags, so an edited kernel is rebuilt
and a built one is reused.  Nothing is built when this module is imported:
the CPU-only test machine has no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable

__all__ = ["KERNEL_SOURCES", "build", "load_library", "nvcc_path",
           "BUILD_DIR"]

_PKG = Path(__file__).resolve().parent.parent
CSRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
KERNEL_SOURCES = ("correlation_fwd",)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_loaded: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on PATH,
    else the toolkit's default install location."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [os.path.join(home, "bin", "nvcc")] if home else []
    found = shutil.which("nvcc")
    if found:
        candidates.append(found)
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME or put nvcc on PATH): the port's CUDA "
        "kernels are built from opticalflow_tpu_torch/csrc at first use")


def _library_path(name: str) -> Path:
    h = hashlib.sha256()
    h.update(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC_DIR.glob("*.cu*")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names: Iterable[str] = KERNEL_SOURCES) -> Dict[str, Path]:
    """Compile every named kernel that is not built yet, one ``nvcc`` per
    source, all started together.  Returns {name: library path}; raises
    with the compiler's output if any build fails.  The ``-Xptxas -v``
    report (registers, shared memory, spills) is kept beside each library
    as ``<library>.ptxas.txt``."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    paths = {n: _library_path(n) for n in names}
    procs = {}
    for name, lib in paths.items():
        if lib.exists():
            continue
        tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp),
               str(CSRC_DIR / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, cmd)
    failed = []
    for name, (proc, tmp, cmd) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{' '.join(cmd)}\n{log}")
            continue
        paths[name].with_name(paths[name].name + ".ptxas.txt").write_text(log)
        os.replace(tmp, paths[name])   # atomic: readers never see half a file
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return paths


def load_library(name: str) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cu``'s shared library."""
    lib = _loaded.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build([name])[name]))
        _loaded[name] = lib
    return lib

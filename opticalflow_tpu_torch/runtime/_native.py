"""Build and load the port's host C++ libraries (g++, ctypes).

A source is compiled at first use into ``opticalflow_tpu_torch/_build/``
(git-ignored), beside the CUDA kernels, under a name that carries a digest
of the source and flags, so an edited source is rebuilt; the new file is
renamed into place, so a concurrent reader never sees half of it.  A
failed build raises with the compiler's output: nothing here falls back
to another implementation.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path
from typing import Sequence

__all__ = ["BUILD_DIR", "library_path", "build_and_load"]

BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"


def library_path(src: Path, flags: Sequence[str]) -> Path:
    """``_build/lib<stem>-<digest>.so`` for ``src`` built with ``flags``."""
    h = hashlib.sha256(" ".join(flags).encode())
    h.update(src.read_bytes())
    return BUILD_DIR / f"lib{src.stem}-{h.hexdigest()[:16]}.so"


def _build(src: Path, flags: Sequence[str], path: Path, what: str) -> None:
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
    cmd = ["g++", *flags, "-o", str(tmp), str(src)]
    try:
        res = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    except FileNotFoundError:
        raise RuntimeError(f"g++ not found: {what} is host C++ ({src.name}) "
                           "built at first use") from None
    if res.returncode != 0:
        raise RuntimeError(f"building {src.name} failed:\n{' '.join(cmd)}\n"
                           f"{res.stdout}{res.stderr}")
    os.replace(tmp, path)            # atomic: readers never see half a file


def build_and_load(src: Path, flags: Sequence[str], what: str) -> ctypes.CDLL:
    """Build ``src`` with ``g++ flags`` if its library is not there yet, and
    load it; ``what`` names the feature in the error when g++ is missing.
    The caller serialises calls (each module loads its library once, under
    its own lock)."""
    path = library_path(src, flags)
    if not path.exists():
        _build(src, flags, path, what)
    return ctypes.CDLL(str(path))

"""Build and load the port's host C++ libraries (g++, ctypes).

A source is compiled at first use into ``opticalflow_tpu_torch/_build/``
(git-ignored), beside the CUDA kernels, under a name that carries a digest
of the flags, the source and the local headers it includes (``#include
"..."``, followed through), so an edited source or header is rebuilt; the new file is
renamed into place, so a concurrent reader never sees half of it.  A
failed build raises with the compiler's output: nothing here falls back
to another implementation.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import subprocess
from pathlib import Path
from typing import List, Sequence

__all__ = ["BUILD_DIR", "library_path", "build_and_load", "sources"]

BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"


_INCLUDE = re.compile(rb'^[ \t]*#[ \t]*include[ \t]*"([^"]+)"', re.M)


def sources(src: Path) -> List[Path]:
    """``src`` and the local headers it includes, recursively, each once."""
    seen: List[Path] = []
    todo = [src.resolve()]
    while todo:
        path = todo.pop(0)
        if path in seen:
            continue
        seen.append(path)
        todo += [(path.parent / m.group(1).decode()).resolve()
                 for m in _INCLUDE.finditer(path.read_bytes())]
    return seen


def library_path(src: Path, flags: Sequence[str]) -> Path:
    """``_build/lib<stem>-<digest>.so`` for ``src`` built with ``flags``:
    the digest covers the flags, the source and its local headers."""
    h = hashlib.sha256(" ".join(flags).encode())
    for path in sources(src):
        h.update(path.name.encode() + b"\0" + path.read_bytes())
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

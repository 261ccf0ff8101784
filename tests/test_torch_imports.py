"""The port stands alone: importing it loads neither JAX, flax nor any
module of the JAX package, and its sources do not name them."""

import torch_threads  # noqa: F401  (first: caps torch threads per xdist worker)
import os
import pkgutil
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "opticalflow_tpu_torch")


def _port_modules():
    import opticalflow_tpu_torch
    names = ["opticalflow_tpu_torch"]
    for info in pkgutil.walk_packages(opticalflow_tpu_torch.__path__,
                                      "opticalflow_tpu_torch."):
        names.append(info.name)
    return names


def test_every_module_imports_without_jax():
    mods = _port_modules()
    assert "opticalflow_tpu_torch.ops.corr_cuda" in mods
    assert "opticalflow_tpu_torch.cli.script_pwc" in mods
    for m in ("serve", "export", "cli.serve", "cli.parity",
              "cli.convert_ckpt", "models.prune", "utils.profiling",
              "utils.debugging", "runtime.jpeg", "runtime._native",
              "runtime.dis", "viz.farneback", "runtime.mpeg4", "io.mp4",
              "io.avi", "runtime.vp8", "io.mkv", "runtime.vp9",
              "runtime.mpeg12", "io.mpegps", "runtime.h263", "runtime.ffv1",
              "io.mpegpes", "io.mpegts", "io.elementary", "runtime.h264"):
        assert f"opticalflow_tpu_torch.{m}" in mods, m
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'opticalflow_tpu'))\n"
        "print(repr(bad))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().splitlines()[-1] == "[]", res.stdout


def test_port_neither_imports_nor_names_opencv():
    """The GPU machine has no OpenCV: importing every port module loads no
    cv2, and no port source names it outside docstrings and comments."""
    mods = _port_modules()
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "print('cv2' in sys.modules)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().splitlines()[-1] == "False", res.stdout
    offenders = []
    for dirpath, _, names in os.walk(PKG):
        for n in names:
            if n.endswith(".py"):
                with open(os.path.join(dirpath, n)) as f:
                    code = re.sub(r'"""[\s\S]*?"""|#.*', "", f.read())
                if re.search(r"\bcv2\b", code):
                    offenders.append(n)
    assert not offenders, offenders


def test_sources_name_no_jax():
    pattern = re.compile(r"^\s*(import|from)\s+(jax|flax|jaxlib)\b"
                         r"|opticalflow_tpu\.|opticalflow_tpu\s+import",
                         re.MULTILINE)
    offenders = []
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, _, names in os.walk(PKG):
        files += [os.path.join(dirpath, n) for n in names
                  if n.endswith((".py", ".cu", ".cuh"))]
    for path in files:
        with open(path) as f:
            src = f.read()
        # mentions of the JAX package's file paths in prose are fine; code
        # references (dotted module names, imports) are not
        code = re.sub(r'"""[\s\S]*?"""|#.*|//.*', "", src)
        if pattern.search(code):
            offenders.append(os.path.relpath(path, ROOT))
    assert not offenders, offenders


def test_importing_the_port_loads_no_matplotlib_nor_pil():
    """The GPU machine has neither: the quiver figure imports matplotlib
    only when it is drawn, and PIL's resize is the port's own numpy."""
    mods = _port_modules()
    assert "opticalflow_tpu_torch.viz.overlay" in mods
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "print(sorted(m for m in ('matplotlib', 'PIL') if m in sys.modules))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().splitlines()[-1] == "[]", res.stdout


def test_package_data_holds_every_file_the_port_opens():
    """An installed (non-editable) package can build its kernels, its host
    library and draw text: every file that ``ops/_build.py`` (the kernels'
    sources and headers), ``runtime/flowviz.py``, ``runtime/jpeg.py`` and
    ``runtime/dis.py``, ``runtime/vp8.py`` and ``runtime/vp9.py`` (their
    C++ sources, and VP9's table header),
    ``runtime/mpeg4.py``, ``runtime/mpeg12.py`` and ``runtime/h264.py``
    (with ``jpeg.py``, the headers they include), ``runtime/ffv1.py`` (its
    C++ source),
    ``viz/text.py`` (the glyph atlas) and ``viz/colorwheel.py`` (the magma
    table) read is matched by a ``package-data`` pattern of
    ``pyproject.toml``."""
    import fnmatch
    import tomllib
    from opticalflow_tpu_torch.ops import _build
    from opticalflow_tpu_torch.runtime import _native, dis, ffv1, flowviz, \
        h264, jpeg, mpeg4, mpeg12, vp8, vp9
    from opticalflow_tpu_torch.viz import colorwheel, text
    with open(os.path.join(ROOT, "pyproject.toml"), "rb") as f:
        patterns = tomllib.load(f)["tool"]["setuptools"]["package-data"][
            "opticalflow_tpu_torch"]
    opened = [str(p) for p in sorted(_build.CSRC_DIR.glob("*.cu*"))]
    opened += [str(flowviz._SRC), str(dis._SRC), str(vp8._SRC),
               str(ffv1._SRC),
               text.ATLAS_PATH, colorwheel.MAGMA_PATH]
    opened += sorted({str(p) for src in (jpeg._SRC, mpeg4._SRC, vp9._SRC,
                                         mpeg12._SRC, h264._SRC)
                      for p in _native.sources(src)})
    assert any(p.endswith("h264_tables.h") for p in opened)
    assert any(p.endswith("h264_qpel.h") for p in opened)
    assert any(p.endswith("vp9_tables.h") for p in opened)
    assert any(p.endswith("mpeg12.cpp") for p in opened)
    assert any(p.endswith("mpeg_common.h") for p in opened)
    assert any(p.endswith(".cuh") for p in opened)
    assert {os.path.splitext(p)[1] for p in opened} == {
        ".cu", ".cuh", ".cpp", ".h", ".npz"}
    for path in opened:
        assert os.path.isfile(path), path
        rel = os.path.relpath(path, PKG)
        assert any(fnmatch.fnmatch(rel, pat) for pat in patterns), \
            (rel, patterns)

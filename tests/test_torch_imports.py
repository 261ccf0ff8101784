"""The port stands alone: importing it loads neither JAX, flax nor any
module of the JAX package, and its sources do not name them."""

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
              "utils.debugging"):
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
    sources and headers), ``runtime/flowviz.py`` (its C++ source),
    ``viz/text.py`` (the glyph atlas) and ``viz/colorwheel.py`` (the magma
    table) read is matched by a ``package-data`` pattern of
    ``pyproject.toml``."""
    import fnmatch
    import tomllib
    from opticalflow_tpu_torch.ops import _build
    from opticalflow_tpu_torch.runtime import flowviz
    from opticalflow_tpu_torch.viz import colorwheel, text
    with open(os.path.join(ROOT, "pyproject.toml"), "rb") as f:
        patterns = tomllib.load(f)["tool"]["setuptools"]["package-data"][
            "opticalflow_tpu_torch"]
    opened = [str(p) for p in sorted(_build.CSRC_DIR.glob("*.cu*"))]
    opened += [str(flowviz._SRC), text.ATLAS_PATH, colorwheel.MAGMA_PATH]
    assert any(p.endswith(".cuh") for p in opened)
    assert {os.path.splitext(p)[1] for p in opened} == {
        ".cu", ".cuh", ".cpp", ".npz"}
    for path in opened:
        assert os.path.isfile(path), path
        rel = os.path.relpath(path, PKG)
        assert any(fnmatch.fnmatch(rel, pat) for pat in patterns), \
            (rel, patterns)

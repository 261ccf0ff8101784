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

"""The port never imports jax, and ``chip_smoke.py`` refuses to report a result
without a GPU."""

import os
import shutil
import subprocess
import sys

import pytest

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_IMPORT_ALL = """
import importlib, pkgutil, sys
import jaybenne_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
assert len(names) >= 20, names
bad = sorted(m for m in sys.modules if m == "jax" or m.startswith(("jax.", "jaybenne_tpu.")))
print("IMPORTED", len(names), "JAX", bad)
"""


def test_port_imports_no_jax():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = _ROOT
    res = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=_ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert "JAX []" in res.stdout, res.stdout


@pytest.mark.parametrize("where", ["repo", "alone"])
def test_chip_smoke_fails_without_gpu(where, tmp_path):
    """Here (no GPU), and in a directory holding chip_smoke.py and nothing else of
    the repository, the script exits non-zero and prints no result line."""
    script = os.path.join(_ROOT, "chip_smoke.py")
    cwd = _ROOT
    if where == "alone":
        shutil.copy(script, tmp_path / "chip_smoke.py")
        script, cwd = str(tmp_path / "chip_smoke.py"), str(tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, script], cwd=cwd, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout

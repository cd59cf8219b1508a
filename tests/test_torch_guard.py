"""The port imports torch and never jax: checked on its sources and by
importing every module with ``jax`` blocked, in a fresh interpreter, where
importing prints nothing (nothing runs at import: the examples' and the
benchmarks' work sits behind ``__main__``) and pulls in no matplotlib."""

import pathlib
import re
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "particle_filters_tpu_torch"
JAX_IMPORT = re.compile(r"^\s*(import\s+jax\b|from\s+jax\b)", re.MULTILINE)

# The Triton kernel module imports triton at the top; only the CUDA
# launcher imports it, so it is not imported here.
_CODE = """
import importlib, pkgutil, sys
sys.modules["jax"] = None
import particle_filters_tpu_torch as port
names = [m.name for m in pkgutil.walk_packages(port.__path__, port.__name__ + ".")
         if not m.name.endswith("_fused_pf_triton")]
for name in names:
    importlib.import_module(name)
leaked = sorted(m for m in sys.modules if m.startswith("particle_filters_tpu.")
                or m == "particle_filters_tpu")
assert not leaked, leaked
assert "matplotlib" not in sys.modules
assert any(n.endswith(".examples.ex15_pf_degeneracy_analysis") for n in names)
print(len(names))
"""


def test_no_jax_import_in_sources():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 10
    offenders = [str(f) for f in files if JAX_IMPORT.search(f.read_text())]
    assert not offenders, offenders


def test_port_imports_with_jax_blocked():
    res = subprocess.run(
        [sys.executable, "-c", _CODE], cwd=ROOT, capture_output=True, text=True,
        timeout=120, check=False,
    )
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.strip()) >= 10

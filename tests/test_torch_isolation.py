"""The port stands alone: importing every module of ``repro_torch`` loads
neither JAX nor anything of the JAX package, and no source of the port (nor
``chip_smoke.py``) imports them."""
import json
import os
import re
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "src" / "repro_torch"
SOURCES = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]


def _module_names():
    return sorted(".".join(("repro_torch",) + p.relative_to(PORT)
                           .with_suffix("").parts).removesuffix(".__init__")
                  for p in PORT.rglob("*.py"))


def test_importing_every_port_module_loads_no_jax_or_reference():
    code = (
        "import importlib, json, sys\n"
        f"names = {_module_names()!r}\n"
        "for n in names: importlib.import_module(n)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith(('jax.', 'jaxlib')) or m == 'repro' or "
        "m.startswith('repro.'))\n"
        "print(json.dumps({'n': len(names), 'bad': bad}))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=REPO,
                         env={**os.environ, "PYTHONPATH": str(REPO / "src")})
    assert out.returncode == 0, out.stderr
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["n"] >= 20 and res["bad"] == []


def test_no_port_source_imports_jax_or_the_reference():
    pattern = re.compile(r"^\s*(import\s+jax|from\s+jax|import\s+repro\b(?!_)"
                         r"|from\s+repro[.\s]|import\s+repro\.)", re.M)
    assert (REPO / "chip_smoke.py").exists()
    offenders = [str(p.relative_to(REPO)) for p in SOURCES
                 if pattern.search(p.read_text())]
    assert offenders == []

"""The port stands alone: importing every module of
``audio_processor_tpu_torch``, ``chip_smoke.py`` and the port's tools
loads neither JAX nor any module of the JAX package
``audio_processor_tpu``, and no source of the port names that package
in an import statement, lazy ones inside functions included."""

import ast
import json
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "audio_processor_tpu_torch"
SCRIPTS = [REPO / "chip_smoke.py"] + sorted((REPO / "tools").glob("*torch*.py"))

# Imports every module of the port by name, then each script as a module
# (under a name other than __main__, so that none of them runs), and
# prints what sys.modules then holds of JAX and of the JAX package.
IMPORT_ALL = r"""
import importlib, importlib.util, json, pkgutil, sys

import audio_processor_tpu_torch as port

names = [m.name for m in pkgutil.walk_packages(port.__path__,
                                                port.__name__ + ".")]
for name in names:
    importlib.import_module(name)
for i, path in enumerate(sys.argv[1:]):
    spec = importlib.util.spec_from_file_location(f"_script_{i}", path)
    spec.loader.exec_module(importlib.util.module_from_spec(spec))
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "audio_processor_tpu"))
print(json.dumps({"modules": len(names), "bad": bad}))
"""


def _imported_names(path: Path):
    """Every module name an import statement of ``path`` names."""
    for node in ast.walk(ast.parse(path.read_text(encoding="utf-8"))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and not node.level:
            yield node.module


def test_importing_the_port_loads_no_jax_and_no_jax_package():
    r = subprocess.run([sys.executable, "-c", IMPORT_ALL, *map(str, SCRIPTS)],
                       cwd=REPO, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-4000:]
    out = json.loads(r.stdout.strip().splitlines()[-1])
    assert out["modules"] > 50          # io/ alone holds some 30 modules
    assert out["bad"] == []


@pytest.mark.parametrize("root", ["audio_processor_tpu_torch", "scripts"])
def test_no_source_names_the_jax_package(root):
    files = sorted(PORT.rglob("*.py")) if root != "scripts" else SCRIPTS
    assert files
    offenders = [f"{f.relative_to(REPO)}: {name}" for f in files
                 for name in _imported_names(f)
                 if name.split(".")[0] in ("jax", "audio_processor_tpu")]
    assert offenders == []


def test_native_library_lives_in_the_port():
    """The port's native I/O library is built into and loaded from the
    port's own directory, never the JAX package's."""
    from audio_processor_tpu_torch import _build
    from audio_processor_tpu_torch.io import native

    lib = _build.native_library()
    assert native._LIB_PATH == lib
    assert lib.parent == PORT / "io" / "_native"
    assert lib.name.startswith("libaudioio-") and lib.suffix == ".so"

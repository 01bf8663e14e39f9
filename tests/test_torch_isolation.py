"""The PyTorch port stands alone: it imports neither JAX nor anything of
the JAX package (kungfu_tpu), and neither does chip_smoke.py."""
import ast
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "kungfu_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "kungfu_tpu")


def _sources():
    return sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]


def _absolute_imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.lineno, node.module or ""


@pytest.mark.parametrize("path", _sources(),
                         ids=lambda p: str(p.relative_to(REPO)))
def test_no_source_imports_jax_or_the_jax_package(path):
    bad = [(line, mod) for line, mod in _absolute_imports(path)
           if mod.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.relative_to(REPO)} imports {bad}"


def test_every_module_imports_with_jax_blocked():
    """In a fresh interpreter where importing jax or kungfu_tpu raises,
    every module of the port still imports."""
    code = f"""
import importlib, pkgutil, sys
for name in {FORBIDDEN!r}:
    sys.modules[name] = None          # any import of it raises
import kungfu_tpu_torch
mods = [m.name for m in pkgutil.walk_packages(kungfu_tpu_torch.__path__,
                                              "kungfu_tpu_torch.")]
for m in mods:
    importlib.import_module(m)
assert not any(k.split(".")[0] in {FORBIDDEN!r} and sys.modules[k] is not None
               for k in list(sys.modules)), "a forbidden module loaded"
print(len(mods))
"""
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert int(r.stdout.strip()) >= 15

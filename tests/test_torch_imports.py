"""The PyTorch port stands alone: no module of ``gaussian_transformer_tpu_torch``
(nor ``chip_smoke.py``) imports JAX, Flax, Pillow or anything of the JAX
package, and importing the whole port loads no JAX."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "gaussian_transformer_tpu_torch"
SOURCES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "flax", "PIL", "gaussian_transformer_tpu")


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def _forbidden(module: str) -> bool:
    """Whole-name match: ``gaussian_transformer_tpu_torch`` is allowed,
    ``gaussian_transformer_tpu`` and ``gaussian_transformer_tpu.x`` are not."""
    return any(module == name or module.startswith(name + ".") for name in FORBIDDEN)


def test_forbidden_matches_whole_module_names():
    assert _forbidden("jax.numpy") and _forbidden("gaussian_transformer_tpu.render")
    assert _forbidden("gaussian_transformer_tpu") and _forbidden("PIL")
    assert not _forbidden("gaussian_transformer_tpu_torch.render") and not _forbidden("jaxtyping")


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_source_imports_nothing_forbidden(path):
    bad = [m for m in _imported_modules(path) if _forbidden(m)]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_importing_the_port_loads_no_jax():
    modules = sorted(
        ".".join(p.relative_to(ROOT).with_suffix("").parts).removesuffix(".__init__")
        for p in PORT.rglob("*.py")
    )
    code = (
        "import importlib, sys\n"
        f"for m in {modules!r}: importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'PIL', 'gaussian_transformer_tpu'))\n"
        "assert not bad, bad\n"
        "print(len(sys.modules))\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr

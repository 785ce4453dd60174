"""The port's package stands alone: no module of ``qcmrf_tpu_torch`` imports
JAX, the JAX package, the benchmark or a script at the repository's root,
or loads a source file by its path; and every CUDA source it holds is one
the kernel library builds. Reads the sources with ``ast``; imports no
JAX."""

import ast
from pathlib import Path

import pytest

from qcmrf_tpu_torch.ops import _build

PACKAGE = Path(__file__).resolve().parents[1] / "qcmrf_tpu_torch"

#: top-level modules no module of the port may import: JAX, the JAX
#: package, the benchmark and the root scripts
FORBIDDEN = {"jax", "jaxlib", "qcmrf_tpu", "benchmark", "chip_smoke", "bench",
             "__graft_entry__"}

MODULES = sorted(p.relative_to(PACKAGE).as_posix()
                 for p in PACKAGE.rglob("*.py"))


def _imported(tree: ast.AST):
    """The absolute module names a source imports."""
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("module", MODULES)
def test_module_imports_nothing_outside_the_port(module):
    """No import of JAX, the JAX package, ``benchmark``, ``chip_smoke``,
    the root ``bench`` or ``__graft_entry__``, and no call of
    ``importlib.util.spec_from_file_location``."""
    tree = ast.parse((PACKAGE / module).read_text(), filename=module)
    bad = sorted({name for name in _imported(tree)
                  if name.split(".")[0] in FORBIDDEN})
    assert not bad, f"{module} imports {bad}"
    by_path = [node.lineno for node in ast.walk(tree)
               if isinstance(node, (ast.Attribute, ast.Name))
               and "spec_from_file_location" in (
                   getattr(node, "attr", None), getattr(node, "id", None))]
    assert not by_path, (f"{module} loads a file by its path at lines "
                         f"{by_path}")


def test_every_cuda_source_is_built():
    """Every ``*.cu`` under the package is a library source that
    ``ops._build`` compiles."""
    held = sorted(PACKAGE.rglob("*.cu"))
    assert held and held == sorted(_build.sources())

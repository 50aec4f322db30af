"""Rules of the PyTorch port.

* ``repro_torch``, ``chip_smoke.py``, the port's examples
  (``examples/*_torch.py``) and its chip tools (``tools/port_*.py``)
  import neither JAX nor the JAX package (``repro``), not even modules of
  it that do not import JAX.
* ``repro_torch/core`` is the JAX package's control plane and evaluation
  simulator copied file for file: each file equals its reference after the
  ``repro.core`` → ``repro_torch.core`` rewrite, apart from the deliberate
  edits listed here.
* Every name a tool or test reads from ``chip_smoke.py`` is defined at its
  top level (both sides read from the source, nothing imported).
"""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
REF_CORE = ROOT / "src" / "repro" / "core"
PORT = ROOT / "src" / "repro_torch"
COPIED = ("tapp", "scheduler", "platform", "analysis", "sim")
#: The files that import ``chip_smoke``.
CHIP_SMOKE_USERS = ("tests/test_torch_topology.py", "tools/port_f32_ab.py")

#: The deliberate edits to the copy, as (reference text after the rewrite,
#: port text) pairs, per file.
EDITS = {
    "scheduler/batch.py": [
        (':func:`repro.kernels.ops.select_first_available` resolves "first set',
         ':func:`repro_torch.kernels.ops.select_first_available` resolves "first set'),
        ("  kernel in :mod:`repro.kernels.ref`; ``backend=\"jax\"`` lowers the\n"
         "  identical computation through jit (``REPRO_BATCH_BACKEND`` overrides).",
         "  kernel in :mod:`repro_torch.kernels.ref`; ``backend=\"torch\"`` runs the\n"
         "  identical computation as torch tensor ops (``REPRO_BATCH_BACKEND`` overrides)."),
        ('if backend not in ("numpy", "jax"):', 'if backend not in ("numpy", "torch"):'),
        ("expected 'numpy' or 'jax'", "expected 'numpy' or 'torch'"),
        ("from repro.kernels.ops import select_first_available",
         "from repro_torch.kernels.ops import select_first_available"),
    ],
}


def _rewritten(rel: str) -> str:
    return (REF_CORE / rel).read_text().replace("repro.core", "repro_torch.core")


def _copied_files():
    return sorted(
        str(p.relative_to(REF_CORE)) for sub in COPIED for p in (REF_CORE / sub).glob("*.py")
    )


def _is_forbidden(module: str) -> bool:
    return module.split(".")[0] in ("jax", "jaxlib") or module == "repro" or \
        module.startswith("repro.")


def test_importing_the_port_loads_no_jax_and_no_reference_module():
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.')]\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "bad = sorted(n for n in sys.modules if n.split('.')[0] in ('jax', 'jaxlib')\n"
        "             or n == 'repro' or n.startswith('repro.'))\n"
        "print(len(names), bad)\n"
        "assert not bad, bad\n"
        "assert len(names) > 30\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr


@pytest.mark.parametrize("path", sorted(
    [str(p.relative_to(ROOT)) for p in PORT.rglob("*.py")]
    + ["chip_smoke.py", "examples/quickstart_torch.py", "examples/train_smollm_torch.py"]
    + [str(p.relative_to(ROOT)) for p in (ROOT / "tools").glob("port_*.py")]
))
def test_no_jax_or_reference_import(path):
    tree = ast.parse((ROOT / path).read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [alias.name for alias in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        bad = [n for n in names if _is_forbidden(n)]
        assert not bad, f"{path}:{node.lineno} imports {bad}"


@pytest.mark.parametrize("rel", _copied_files())
def test_control_plane_copy_matches_reference(rel):
    expect = _rewritten(rel)
    for old, new in EDITS.get(rel, ()):
        assert expect.count(old) == 1, (rel, old)
        expect = expect.replace(old, new)
    assert (PORT / "core" / rel).read_text() == expect


def test_copy_has_exactly_the_reference_files():
    """No file beyond the copied ones, the simulator (``core/sim``) among
    them, and ``core/__init__.py`` is its reference after the rewrite,
    importing ``sim`` as the JAX package does."""
    port_files = sorted(
        str(p.relative_to(PORT / "core")) for sub in COPIED
        for p in (PORT / "core" / sub).glob("*.py")
    )
    assert port_files == _copied_files()
    assert sorted(p.name for p in (PORT / "core" / "sim").glob("*.py")) == [
        "__init__.py", "core.py", "scenarios.py"]
    init = (PORT / "core" / "__init__.py").read_text()
    assert init == _rewritten("__init__.py")
    assert "from repro_torch.core import platform, scheduler, sim, tapp\n" in init


def _chip_smoke_aliases(tree):
    """Names bound to the ``chip_smoke`` module."""
    return {a.asname or a.name for node in ast.walk(tree) if isinstance(node, ast.Import)
            for a in node.names if a.name == "chip_smoke"}


def _top_level_names(tree):
    names = set()
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = node.targets if isinstance(node, ast.Assign) else [node.target]
            names |= {n.id for t in targets for n in ast.walk(t) if isinstance(n, ast.Name)}
        elif isinstance(node, (ast.Import, ast.ImportFrom)):
            names |= {(a.asname or a.name).split(".")[0] for a in node.names}
    return names


@pytest.mark.parametrize("path", CHIP_SMOKE_USERS)
def test_names_read_from_chip_smoke_are_defined_there(path):
    defined = _top_level_names(ast.parse((ROOT / "chip_smoke.py").read_text()))
    tree = ast.parse((ROOT / path).read_text())
    aliases = _chip_smoke_aliases(tree)
    used = {node.attr for node in ast.walk(tree) if isinstance(node, ast.Attribute)
            and isinstance(node.value, ast.Name) and node.value.id in aliases}
    assert used, f"{path} imports chip_smoke and reads nothing from it"
    assert not used - defined, f"{path} reads {sorted(used - defined)} from chip_smoke.py"

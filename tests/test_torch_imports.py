"""The port stands alone: nothing under ``src/repro_torch/`` and nothing
in ``chip_smoke.py``, ``scripts/monitor_kernel_turns.py`` or
``scripts/chaos_replica_cap.py`` (all run on the card's machine)
imports ``jax`` or the JAX package ``repro`` (any ``repro.*`` import
would run ``repro/core/__init__.py`` and with it jax).  The card's
machine has no jax."""

import ast
import pathlib

import pytest

REPO = pathlib.Path(__file__).resolve().parents[1]
FILES = sorted((REPO / "src" / "repro_torch").rglob("*.py")) + [
    REPO / "chip_smoke.py", REPO / "scripts" / "monitor_kernel_turns.py",
    REPO / "scripts" / "chaos_replica_cap.py"]
BANNED = ("jax", "jaxlib", "repro")


def _imported_roots(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom):
            if node.level == 0 and node.module:
                yield node.lineno, node.module.split(".")[0]
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__") and node.args
              and isinstance(node.args[0], ast.Constant)
              and isinstance(node.args[0].value, str)):
            yield node.lineno, node.args[0].value.split(".")[0]


def test_port_has_sources():
    assert any(f.name == "monitor.py" for f in FILES)
    names = {str(f.relative_to(REPO)) for f in FILES}
    for mod in ("control/policy.py", "control/loop.py", "control/group.py",
                "streams/pipeline.py", "kernels/monitor/rounds.py",
                "ft/supervisor.py", "workloads/harness.py",
                "data/pipeline.py"):
        assert f"src/repro_torch/{mod}" in names, mod
    assert (REPO / "chip_smoke.py").exists()
    assert (REPO / "src" / "repro_torch" / "kernels" / "monitor" / "csrc"
            / "monitor.cu").exists()


@pytest.mark.parametrize("path", FILES,
                         ids=[str(f.relative_to(REPO)) for f in FILES])
def test_no_jax_or_repro_imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = [(line, root) for line, root in _imported_roots(tree)
           if root in BANNED]
    assert not bad, f"{path.relative_to(REPO)} imports {bad}"


def test_scanner_catches_banned_imports():
    src = ("import jax.numpy as jnp\nfrom repro.core import monitor\n"
           "import importlib\nimportlib.import_module('repro.streams')\n"
           "from repro_torch.core import stats\n")
    roots = [r for _, r in _imported_roots(ast.parse(src))]
    assert roots.count("jax") == 1 and roots.count("repro") == 2
    assert "repro_torch" in roots

"""The port stands alone: nothing under ``src/repro_torch/`` and nothing
in ``chip_smoke.py``, ``scripts/*.py`` or the example twins
``examples/*_torch.py`` (all run on the card's machine) imports ``jax``,
the JAX package ``repro`` (any ``repro.*`` import would run
``repro/core/__init__.py`` and with it jax) or its ``benchmarks``.  The card's
machine has no jax.  Nor does the package import ``torch.testing``,
PyTorch's test helpers (its tests may)."""

import ast
import os
import pathlib
import subprocess
import sys

import pytest

REPO = pathlib.Path(__file__).resolve().parents[1]
FILES = sorted((REPO / "src" / "repro_torch").rglob("*.py")) + [
    REPO / "chip_smoke.py"] + sorted((REPO / "scripts").glob("*.py")) + sorted(
    (REPO / "examples").glob("*_torch.py"))
BANNED = ("jax", "jaxlib", "repro", "benchmarks")


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
                "data/pipeline.py", "launch/dryrun.py", "launch/sweep.py",
                "models/moe.py", "analysis/__init__.py",
                "analysis/__main__.py", "analysis/model.py",
                "analysis/lock_order.py", "analysis/layering.py",
                "analysis/races.py", "analysis/retrace.py",
                "analysis/witness.py"):
        assert f"src/repro_torch/{mod}" in names, mod
    for extra in ("baseline.json", "README.md"):
        assert (REPO / "src" / "repro_torch" / "analysis" / extra).exists()
    assert (REPO / "chip_smoke.py").exists()
    for twin in ("quickstart", "streaming_apps", "serve_decode", "train_lm"):
        assert f"examples/{twin}_torch.py" in names, twin
    assert (REPO / "src" / "repro_torch" / "kernels" / "monitor" / "csrc"
            / "monitor.cu").exists()


@pytest.mark.parametrize("path", FILES,
                         ids=[str(f.relative_to(REPO)) for f in FILES])
def test_no_jax_or_repro_imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = [(line, root) for line, root in _imported_roots(tree)
           if root in BANNED]
    assert not bad, f"{path.relative_to(REPO)} imports {bad}"


def _imported_modules(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_package_does_not_import_torch_testing():
    bad = [str(f.relative_to(REPO)) for f in FILES
           if "src" in f.parts and any(
               m == "torch.testing" or m.startswith("torch.testing.")
               for m in _imported_modules(ast.parse(f.read_text())))]
    assert not bad, bad


def test_scanner_catches_banned_imports():
    src = ("import jax.numpy as jnp\nfrom repro.core import monitor\n"
           "import importlib\nimportlib.import_module('repro.streams')\n"
           "from repro_torch.core import stats\n"
           "from benchmarks.apps import fig16_matmul_app\n")
    roots = [r for _, r in _imported_roots(ast.parse(src))]
    assert roots.count("jax") == 1 and roots.count("repro") == 2
    assert roots.count("benchmarks") == 1
    assert "repro_torch" in roots


def test_dist_and_serve_import_neither_train_nor_control():
    """The reference's import DAG: ``dist`` imports only ``dist`` and
    ``configs``, and ``serve`` imports ``control`` and ``obs`` only inside
    the functions that wire them (``# layer-ok``).  In a fresh
    interpreter, importing every ``dist`` module and the engine loads no
    ``train`` and no ``control`` module."""
    code = ("import sys\n"
            "import repro_torch.dist, repro_torch.dist.sharding\n"
            "import repro_torch.dist.compression, repro_torch.serve.engine\n"
            "print(sorted(m for m in sys.modules if m.startswith(\n"
            "    ('repro_torch.train', 'repro_torch.control'))))\n")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]", out.stdout


def test_analysis_is_stdlib_only():
    """``repro_torch.analysis`` imports with ``torch`` and ``numpy``
    blocked (the analyzer must run where the numeric stack is broken),
    and runs its CLI there."""
    code = ("import sys\n"
            "class Block:\n"
            "    def find_spec(self, name, path=None, target=None):\n"
            "        if name.split('.')[0] in ('torch', 'numpy', 'jax'):\n"
            "            raise ImportError('blocked: ' + name)\n"
            "sys.meta_path.insert(0, Block())\n"
            "import repro_torch.analysis\n"
            "from repro_torch.analysis.__main__ import main\n"
            "sys.exit(main(['-q']))\n")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    assert out.stdout.startswith("repro_torch.analysis: 0 finding(s)")

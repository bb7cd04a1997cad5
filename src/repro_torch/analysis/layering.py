"""LayerGuard: machine-enforced import DAG for the ``repro_torch``
package.

The layering contract (previously prose scattered across module
headers):

* ``obs`` is dependency-free — it imports nothing from ``repro_torch``
  so a broken control plane can still be scraped.
* ``streams`` and ``serve`` never import ``repro_torch.ft`` (fault
  tolerance reaches *down* via duck typing, never up) and never import
  ``repro_torch.control`` at module level — the wiring inversion where a
  pipeline/engine constructs its own control loop is confined to
  function-local imports annotated ``# layer-ok: <reason>``, which
  keeps the module graph acyclic (``control.group`` imports
  ``streams.fleet``).
* Everything else follows ``ALLOWED`` below: an import is legal iff
  the importee's layer is in the importer's allow-set.  The table is
  the JAX package's, plus the edges the port really has, each with its
  reason beside it.

LG001  module-level import outside the DAG (no annotation can sanction)
LG002  ``repro_torch.obs`` importing from ``repro_torch``
LG003  ``streams``/``serve`` importing ``repro_torch.ft`` (banned even
       lazily)
LG004  function-level upward import without a ``# layer-ok:`` annotation
"""
from __future__ import annotations

import ast
from typing import Dict, Iterator, Optional, Set

from .model import PACKAGE, Checker, Finding, Source

# importer layer -> layers it may import from (module level).  The
# port-only files (core/device.py, kernels/_build.py, roofline/counters.py
# in place of roofline/hlo.py, launch/dryrun.py, launch/sweep.py) need no
# edge beyond the JAX package's table; the one edge added is marked.
ALLOWED: Dict[str, Set[str]] = {
    "": set(),                       # repro_torch/__init__.py
    "analysis": {"analysis"},
    "configs": {"configs"},
    "core": {"core", "configs", "kernels"},
    "obs": {"obs"},
    "dist": {"dist", "configs"},
    "ckpt": {"ckpt"},
    "kernels": {"kernels", "core", "configs"},
    "streams": {"streams", "core", "configs"},
    "data": {"data", "streams", "core"},
    # port: the models call the kernel ops (flash attention, the SSD
    # chunk); in the JAX package the kernels are reached through core
    "models": {"models", "configs", "dist", "core", "kernels"},
    "serve": {"serve", "streams", "core", "models", "configs"},
    "control": {"control", "streams", "core", "obs", "configs"},
    "ft": {"ft", "control", "streams", "core", "configs"},
    "roofline": {"roofline", "configs", "core"},
    "train": {"train", "core", "ckpt", "ft", "models", "dist", "configs",
              "data"},
    "launch": {"launch", "configs", "dist", "models", "roofline", "train",
               "core"},
    "workloads": {"workloads", "core", "streams", "control", "ft",
                  "serve", "obs", "configs"},
}

# layers that may additionally be imported function-locally when the
# import line carries a ``# layer-ok: <reason>`` annotation — the
# audited wiring/observability inversion points
LAZY_ALLOWED: Dict[str, Set[str]] = {
    "streams": {"control", "obs"},
    "serve": {"control", "obs", "qos"},
    "control": {"obs"},
    "core": {"obs"},
    "ft": {"obs"},
}

# hard bans that no annotation can sanction
FORBIDDEN: Dict[str, Set[str]] = {
    "streams": {"ft"},
    "serve": {"ft"},
    "obs": {l for l in ALLOWED if l and l != "obs"},
}


def layer_of(rel: str) -> Optional[str]:
    """'streams' for 'repro_torch/streams/queue.py'; None off-package."""
    parts = rel.split("/")
    if not parts or parts[0] != PACKAGE:
        return None
    return parts[1].removesuffix(".py") if len(parts) > 1 else ""


class LayerGuard(Checker):
    name = "LayerGuard"

    def check(self, src: Source) -> Iterator[Finding]:
        layer = layer_of(src.rel)
        if layer is None or layer == "__init__":
            return
        allowed = ALLOWED.get(layer, set())
        lazy = LAZY_ALLOWED.get(layer, set())
        forbidden = FORBIDDEN.get(layer, set())
        for node, depth in _imports(src.tree):
            target = _target_layer(node, src.rel)
            if target is None or target in allowed:
                continue
            if target in forbidden:
                code = "LG002" if layer == "obs" else "LG003"
                yield self.finding(
                    code, src, node,
                    f"layer '{layer}' must never import "
                    f"{PACKAGE}.{target} (hard ban; see "
                    f"{PACKAGE}.analysis.layering)")
            elif depth == 0:
                yield self.finding(
                    "LG001", src, node,
                    f"module-level import of {PACKAGE}.{target} from layer "
                    f"'{layer}' breaks the import DAG — move it into "
                    f"the function that needs it and annotate "
                    f"'# layer-ok: <reason>'")
            elif target not in lazy:
                yield self.finding(
                    "LG004", src, node,
                    f"function-level import of {PACKAGE}.{target} from "
                    f"layer '{layer}' is not a sanctioned inversion "
                    f"point (see LAZY_ALLOWED)")
            elif src.annotation(node.lineno, "layer-ok") in (None, ""):
                yield self.finding(
                    "LG004", src, node,
                    f"lazy import of {PACKAGE}.{target} from layer "
                    f"'{layer}' needs a '# layer-ok: <reason>' "
                    f"annotation naming why the inversion is safe")


def _imports(tree: ast.AST):
    """(import-node, function-nesting-depth) for every import."""
    def walk(node, depth):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.Import, ast.ImportFrom)):
                yield child, depth
            elif isinstance(child, (ast.FunctionDef,
                                    ast.AsyncFunctionDef)):
                yield from walk(child, depth + 1)
            else:
                yield from walk(child, depth)
    yield from walk(tree, 0)


def _target_layer(node, rel: str) -> Optional[str]:
    """Layer a package import lands in, else None for stdlib/third-party."""
    if isinstance(node, ast.Import):
        for alias in node.names:
            parts = alias.name.split(".")
            if parts[0] == PACKAGE:
                return parts[1] if len(parts) > 1 else ""
        return None
    mod = node.module or ""
    if node.level:                   # relative: resolve against rel
        base = rel.split("/")[:-1]   # package dirs, e.g. repro_torch/streams
        base = base[:len(base) - (node.level - 1)] if node.level > 1 \
            else base
        full = base + (mod.split(".") if mod else [])
        if full and full[0] == PACKAGE:
            return full[1] if len(full) > 1 else ""
        return None
    parts = mod.split(".")
    if parts[0] == PACKAGE:
        return parts[1] if len(parts) > 1 else ""
    return None

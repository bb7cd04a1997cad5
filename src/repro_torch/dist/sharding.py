"""Logical-axis -> mesh-axis rule tables and the greedy resolver.

A rule table is an *ordered* mapping ``logical axis name -> candidates``;
each candidate is a tuple of mesh axis names (usually one, sometimes a
combined group like ``("data", "model")`` for the decode KV cache).
``spec_for`` walks the table in priority order and gives each logical axis
the first candidate whose mesh axes (a) all exist in the mesh, (b) are not
already used by this tensor, and (c) evenly divide the dimension — the
divisibility fallback that, e.g., moves 'model' from a 24-head axis to the
128-wide head_dim axis.  Each mesh axis is used at most once per tensor.

Tables are plain dicts so the dry-run can override individual entries per
cell.  The tables and the resolver are the JAX package's; a spec is the
port's own ``PartitionSpec`` (a tuple, equal entry for entry to
``jax.sharding.PartitionSpec``'s), and ``placements_for`` turns it into
DTensor placements over a ``DeviceMesh``.

Layout of a combined group: a tensor dim sharded by ``("data",
"model")`` becomes ``Shard(i)`` on both mesh dims, and DTensor orders
such shards by mesh dim, the first outermost: the rank at mesh
coordinate (d, m) holds block d * |model| + m.  That is JAX's layout
for a group whose axes are listed in the mesh's order (major to minor),
as every group of these tables is (("pod", "data"), ("data", "model"));
a group listed out of the mesh's order would get the mesh's order here,
not the group's.
"""

from __future__ import annotations

import math
from typing import Mapping, Sequence

from torch.distributed.tensor import Replicate, Shard

from repro_torch.train.optimizer import _tree_map

__all__ = [
    "spec_for",
    "param_specs_tree",
    "act_rules",
    "act_rules_opt",
    "param_rules",
    "param_rules_opt",
    "resolve_profile",
    "PartitionSpec",
    "placements_for",
]


class PartitionSpec(tuple):
    """One tensor's mesh axes per dim: None (replicated), an axis name,
    or a tuple of names (a combined group); trailing Nones trimmed."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self):
        return f"PartitionSpec{tuple.__repr__(self)}"


def _norm(cand) -> tuple:
    return cand if isinstance(cand, tuple) else (cand,)


def _mesh_shape(mesh) -> dict:
    """axis name -> size, of a ``DeviceMesh`` or of anything with a
    ``.shape`` mapping (a test stub)."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, mesh.shape))
    return dict(mesh.shape)


def spec_for(shape: Sequence[int], axes: Sequence[str],
             rules: Mapping[str, tuple], mesh) -> PartitionSpec:
    """Resolve one tensor's logical axes to a PartitionSpec.

    ``mesh`` is a ``DeviceMesh`` with named dims, or anything with a
    ``.shape`` mapping (axis name -> size), so tests can pass a stub.
    Trailing unsharded dims are trimmed from the spec.
    """
    mesh_shape = _mesh_shape(mesh)
    assign: dict[int, tuple] = {}
    used: set[str] = set()
    for name, candidates in rules.items():
        if name not in axes:
            continue
        i = axes.index(name)
        dim = shape[i]
        for cand in candidates:
            group = _norm(cand)
            if any(a not in mesh_shape or a in used for a in group):
                continue
            n = math.prod(mesh_shape[a] for a in group)
            if n <= 1 or dim % n:
                continue
            assign[i] = group
            used.update(group)
            break
    entries = [None] * len(axes)
    for i, group in assign.items():
        entries[i] = group if len(group) > 1 else group[0]
    while entries and entries[-1] is None:
        entries.pop()
    return PartitionSpec(*entries)


def placements_for(spec: Sequence, mesh) -> tuple:
    """DTensor placements of ``spec`` over ``mesh`` (a ``DeviceMesh``
    with named dims): per mesh dim, ``Shard(i)`` where the spec puts the
    dim's name on tensor dim i (alone or in a group), else
    ``Replicate()``."""
    dim_of = {}
    for i, entry in enumerate(spec):
        for a in (() if entry is None else _norm(entry)):
            dim_of[a] = i
    return tuple(Shard(dim_of[n]) if n in dim_of else Replicate()
                 for n in mesh.mesh_dim_names)


def param_specs_tree(axes_tree, abstract_tree, mesh,
                     rules: Mapping[str, tuple]):
    """Map a (logical-axes tree, abstract-shape tree) to PartitionSpecs.
    The trees are nested dicts; a leaf of the abstract tree is anything
    with a ``.shape`` (a ``meta`` tensor)."""
    return _tree_map(lambda a, s: spec_for(tuple(s.shape), a, rules, mesh),
                     axes_tree, abstract_tree)


# ---------------------------------------------------------------------------
# Rule tables.
#
# Mesh vocabulary: canonical pod = (data=16, model=16) [+ pod=2 multi-pod];
# MoE pod = (data=16, expert=8, tp=2) [+ pod].  Candidates mentioning axes
# a mesh does not have are skipped, so one table serves both meshes.
# ---------------------------------------------------------------------------

def _batch_cands(multi_pod: bool) -> tuple:
    return ((("pod", "data"), ("data",)) if multi_pod else (("data",),))


def param_rules(multi_pod: bool = False) -> dict:
    """Baseline parameter placement: FSDP d_model over 'data', tensor
    parallelism over 'model' with head->head_dim divisibility fallback."""
    return {
        "vocab": (("model",),),
        "experts": (("model",), ("expert",)),
        "heads": (("model",),),
        "kv_heads": (("model",),),
        "d_ff": (("model",), ("tp",)),
        "head_dim": (("model",),),
        "ssm_inner": (("model",),),
        "experts_router": (("model",),),
        "d_model": _batch_cands(multi_pod),
    }


def param_rules_opt(multi_pod: bool = False) -> dict:
    """Opt profile: same placement priorities; d_model additionally
    falls back to plain 'data' FSDP when the pod group does not divide."""
    rules = param_rules(multi_pod)
    rules["d_model"] = _batch_cands(multi_pod) + (("data",),)
    return rules


def act_rules(kind: str, multi_pod: bool = False) -> dict:
    """Baseline activation placement per workload kind.

    Priorities encode the measured preferences: batch first; attention
    score tensors shard kv_heads over 'model' when divisible, else the
    query-sequence axis; decode shards the KV cache sequence over the whole
    chip group (batch=1 cannot use 'data').
    """
    batch = _batch_cands(multi_pod)
    if kind == "decode":
        return {
            "batch": batch,
            "cache_seq": (("data", "model"), ("model",), ("data",)),
            "kv_heads": (("model",),),
            "heads": (("model",),),
            "vocab": (("model",),),
            "experts": (("expert",),),
            "d_ff": (("tp",),),
        }
    return {
        "batch": batch,
        "kv_heads": (("model",),),
        "heads": (("model",),),
        "q_seq": (("model",),),
        "vocab": (("model",),),
        "experts": (("model",), ("expert",)),
        "d_ff": (("tp",),),
        "enc_seq": (("model",),),
    }


def act_rules_opt(kind: str, multi_pod: bool = False) -> dict:
    """Opt profile: adds sequence parallelism — the 'seq' axis of
    (batch, seq, d_model) activations takes 'model' between matmuls."""
    rules = act_rules(kind, multi_pod)
    if kind != "decode":
        out = {}
        for name, cands in rules.items():
            out[name] = cands
            if name == "kv_heads":          # seq wins over q_seq, loses
                out["seq"] = (("model",),)  # to kv_heads
        rules = out
    return rules


def resolve_profile(profile: str, cfg, kind: str, multi_pod: bool):
    """(act_rules, param_rules, mesh_kind) for one dry-run cell.

    MoE architectures always use the shard_map EP mesh (perf it.6:
    auto-SPMD replicates the dispatch scatter), dense ones the canonical
    (data, model) mesh.
    """
    if profile == "opt":
        a, p = act_rules_opt(kind, multi_pod), param_rules_opt(multi_pod)
    else:
        a, p = act_rules(kind, multi_pod), param_rules(multi_pod)
    mesh_kind = "moe" if getattr(cfg, "n_experts", 0) else "canonical"
    return a, p, mesh_kind

"""The port's dry run (``launch.dryrun``) and its sweep
(``launch.sweep``) on the CPU, against the JAX package's arithmetic.

The dry run traces one rank's step over a ``fake`` 256-rank world on
``meta`` DTensors.  Held here:

* every cell the reference's ``applicable`` refuses comes back
  "skipped" with the reference's reason (the reference's ``lower_cell``
  builds the same dict before it touches a device);
* ``internlm2-1.8b`` x ``train_4k`` x single pod at full width: "ok",
  the same result twice; its ``analytic`` terms and its report's
  compute, memory and collective terms equal the reference's
  ``analytic_flops`` / ``analytic_bytes`` / ``roofline_report`` on the
  same inputs (arithmetic only, nothing compiled); its per-rank argument
  bytes equal what the reference's ``param_specs_tree`` specs give on a
  (data 16, model 16) mesh (parameters, two Adam moments, the step, the
  batch); it all-gathers (the parameters' FSDP shards) and all-reduces;
* a world of one rank moves no collective bytes;
* ``sweep.main`` skips "ok" and "skipped" results and re-runs a corrupt
  or missing one (``subprocess.run`` replaced);
* on the multi-pod mesh (pod 2, data 16, model 16; 512 ranks):
  ``zamba2-7b`` x ``decode_32k`` and ``internlm2-1.8b`` x
  ``decode_32k`` are "ok" at full width, their per-rank argument bytes
  equal to what the reference's specs give (bf16 parameters, the cache,
  tokens and positions);
* the argument bytes count the inputs the step reads: a view reads
  nothing, a copy or a product does (``MemoryTracker.read``);
* the same mesh's trace of mamba2's smoke config on ``train_4k``, in a
  fresh process, computes at most ``SMOKE_PLANS`` redistribute plans and
  misses DTensor's propagation cache at most ``SMOKE_MISSES`` times (a
  count, not a time: a placement DTensor cannot carry as it is sends the
  trace to a graph search per strategy, each a plan).
"""

import json
import math
import os
import pathlib
import subprocess
import sys
import types

import jax
import jax.numpy as jnp
import pytest

from repro.configs import SHAPES as J_SHAPES
from repro.configs import applicable as j_applicable
from repro.configs import get_config as j_get_config
from repro.dist import sharding as j_sh
from repro.models import build_model as j_build_model
from repro.roofline import analysis as j_an
from repro.roofline import analytic as j_ay
from repro_torch.configs import ARCH_IDS, SHAPES, get_smoke_config
from repro_torch.launch import dryrun as D
from repro_torch.launch import mesh as t_mesh
from repro_torch.launch import sweep as W
from repro_torch.roofline import analysis as t_an

SKIPPED = [(a, s) for a in ARCH_IDS for s in SHAPES
           if not j_applicable(j_get_config(a), J_SHAPES[s])[0]]


def test_some_cells_are_refused():
    assert SKIPPED and len(SKIPPED) < len(ARCH_IDS) * len(SHAPES)


@pytest.mark.parametrize("arch,shape", SKIPPED,
                         ids=[f"{a}:{s}" for a, s in SKIPPED])
@pytest.mark.parametrize("multi", [False, True])
def test_refused_cells_are_skipped_with_the_reference_reason(arch, shape,
                                                             multi):
    why = j_applicable(j_get_config(arch), J_SHAPES[shape])[1]
    assert D.lower_cell(arch, shape, multi) == {
        "arch": arch, "shape": shape, "mesh": "multi" if multi else "single",
        "status": "skipped", "reason": why, "profile": "baseline"}


@pytest.fixture(scope="module")
def train_cell():
    return (D.lower_cell("internlm2-1.8b", "train_4k", False),
            D.lower_cell("internlm2-1.8b", "train_4k", False))


def test_train_cell_is_ok_and_deterministic(train_cell):
    a, b = train_cell
    assert a["status"] == "ok" and a["n_chips"] == 256
    a, b = dict(a), dict(b)
    a.pop("trace_s"), b.pop("trace_s")
    assert a == b
    assert a["optimizer"] == "adamw" and a["param_dtype"] == "float32"
    mem = a["memory"]
    assert 0 < mem["argument_bytes_per_dev"] < mem["peak_bytes_per_dev"]
    assert mem["fits_hbm"] == (mem["peak_bytes_per_dev"]
                               < t_an.HW["hbm_bytes"])
    assert a["cost"]["flops"] > 0


def test_train_cell_terms_equal_the_reference_arithmetic(train_cell):
    res = train_cell[0]
    cfg, sh = j_get_config("internlm2-1.8b"), J_SHAPES["train_4k"]
    af = j_ay.analytic_flops(cfg, sh, "full")
    ab = j_ay.analytic_bytes(cfg, sh)
    rep = res["roofline"]
    assert rep["analytic"] == {**af, **ab}
    coll = j_an.CollectiveStats(rep["collective_bytes_by_op"],
                                rep["collective_count_by_op"])
    want = j_an.roofline_report(
        flops_per_dev=af["compiled"] / 256,
        bytes_per_dev=ab["traffic"] / 256, coll=coll, n_chips=256,
        model_flops_total=af["model_flops"], hw=t_an.HW)
    for k in ("compute_s", "memory_s", "collective_s", "dominant",
              "step_lower_bound_s", "roofline_fraction"):
        assert rep[k] == want[k], k
    assert rep["collective_bytes_counted"] == coll.total_bytes
    assert rep["collective_bytes_by_op"]["all-gather"] > 0
    assert rep["collective_bytes_by_op"]["all-reduce"] > 0


def test_train_cell_argument_bytes_equal_the_reference_specs(train_cell):
    """Parameters, Adam's m and v (float32, the parameters' specs), the
    int32 step, and tokens and targets (B, S) int32 on data."""
    jm = j_build_model(j_get_config("internlm2-1.8b"))
    mesh = types.SimpleNamespace(shape={"data": 16, "model": 16})
    specs = j_sh.param_specs_tree(jm.param_axes(),
                                  jm.abstract_params(jnp.float32), mesh,
                                  j_sh.param_rules())
    shapes = jm.abstract_params(jnp.float32)

    def local(spec, shape):
        n = math.prod(shape.shape)
        for entry in spec:
            for a in (() if entry is None else
                      (entry if isinstance(entry, tuple) else (entry,))):
                n //= mesh.shape[a]
        return n

    per_param = sum(jax.tree_util.tree_leaves(jax.tree_util.tree_map(
        local, specs, shapes, is_leaf=lambda x: isinstance(
            x, jax.sharding.PartitionSpec))))
    sh = J_SHAPES["train_4k"]
    batch = 2 * (sh.global_batch // 16) * sh.seq_len * 4
    assert train_cell[0]["memory"]["argument_bytes_per_dev"] == (
        3 * 4 * per_param + 4 + batch)


def test_a_world_of_one_moves_no_bytes(monkeypatch):
    monkeypatch.setattr(D, "WORLD", {False: 1, True: 1})
    monkeypatch.setattr(D, "get_config", get_smoke_config)
    monkeypatch.setattr(
        D, "make_production_mesh",
        lambda multi_pod, device: t_mesh.make_local_mesh(1, 1,
                                                         device=device))
    res = D.lower_cell("internlm2-1.8b", "train_4k", False)
    assert res["status"] == "ok" and res["n_chips"] == 1
    assert res["roofline"]["collective_bytes_counted"] == 0
    assert res["cost"]["flops"] > 0


def test_sweep_skips_done_cells_and_reruns_corrupt_ones(tmp_path,
                                                        monkeypatch):
    cells = [(a, s) for a in W._SIZE_ORDER for s in W._SHAPE_ORDER]
    (tmp_path / f"{cells[0][0]}__{cells[0][1]}__single.json").write_text(
        json.dumps({"status": "ok"}))
    (tmp_path / f"{cells[1][0]}__{cells[1][1]}__single.json").write_text(
        json.dumps({"status": "skipped"}))
    (tmp_path / f"{cells[2][0]}__{cells[2][1]}__single.json").write_text(
        "{not json")
    (tmp_path / f"{cells[3][0]}__{cells[3][1]}__single.json").write_text(
        json.dumps({"status": "error"}))
    ran = []

    def run(cmd, **kw):
        assert cmd[1:3] == ["-m", "repro_torch.launch.dryrun"]
        ran.append((cmd[cmd.index("--arch") + 1],
                    cmd[cmd.index("--shape") + 1]))
        return types.SimpleNamespace(stdout="[ok     ] cell\n")
    monkeypatch.setattr(W.subprocess, "run", run)
    assert W.main(["--mesh", "single", "--out", str(tmp_path)]) == 0
    assert ran == cells[2:]


def test_the_arguments_are_the_inputs_the_step_reads():
    """An input only viewed (one layer's slice of stacked weights) is not
    read; one copied or multiplied is, and so is one the step returns:
    the argument bytes keep those, as the reference's ``jax.jit`` keeps
    only the arguments its step uses."""
    import torch

    from repro_torch.roofline.counters import MemoryTracker, storage_key
    w, v, c = (torch.zeros(4, 8, 8) for _ in range(3))
    tracker = MemoryTracker()
    tracker.track(w, v, c)
    with tracker:
        w[0].t()
        v[1].t().contiguous()
        c[2] @ c[3]
    assert storage_key(w) not in tracker.read
    assert {storage_key(v), storage_key(c)} <= tracker.read
    assert [id(t) for t in D._read([w, v, c], [], tracker.read)] == [
        id(v), id(c)]
    assert len(D._read([w, v, c], [w[1]], tracker.read)) == 3


MULTI = types.SimpleNamespace(shape={"pod": 2, "data": 16, "model": 16})


def _local(spec, leaf, mesh=MULTI) -> int:
    """Bytes of ``leaf``'s shard under ``spec`` (a JAX PartitionSpec)."""
    n = math.prod(leaf.shape) * jnp.dtype(leaf.dtype).itemsize
    for entry in spec:
        for a in (() if entry is None else
                  (entry if isinstance(entry, tuple) else (entry,))):
            n //= mesh.shape[a]
    return n


def _reference_decode_argument_bytes(arch: str) -> int:
    """A decode_32k cell's per-rank argument bytes on the multi-pod mesh
    from the reference's own specs: bf16 parameters under its parameter
    rules, the cache, the tokens and the positions under its decode
    activation rules."""
    jm = j_build_model(j_get_config(arch))
    sh = J_SHAPES["decode_32k"]
    ap = jm.abstract_params(jnp.bfloat16)
    specs = j_sh.param_specs_tree(jm.param_axes(), ap, MULTI,
                                  j_sh.param_rules(True))
    total = sum(jax.tree_util.tree_leaves(jax.tree_util.tree_map(
        _local, specs, ap, is_leaf=lambda x: isinstance(
            x, jax.sharding.PartitionSpec))))
    rules = j_sh.act_rules("decode", True)
    cache, cache_axes = jm.cache_spec(sh.global_batch, sh.seq_len)
    batch, batch_axes = jm.input_specs(sh)
    for tree, axes in ((cache, cache_axes), (batch, batch_axes)):
        for k, leaf in tree.items():
            total += _local(j_sh.spec_for(leaf.shape, axes[k], rules,
                                          MULTI), leaf)
    return total


@pytest.mark.parametrize("arch,want", [("zamba2-7b", 1_625_761_472),
                                       ("internlm2-1.8b", 812_693_664)])
def test_multi_pod_decode_argument_bytes_equal_the_reference_specs(arch,
                                                                   want):
    """zamba2's decode raised in the mamba layers' concat on this mesh
    (a partial sum beside a batch shard, which DTensor cannot join)."""
    res = D.lower_cell(arch, "decode_32k", True)
    assert res["status"] == "ok" and res["n_chips"] == 512
    assert _reference_decode_argument_bytes(arch) == want
    assert res["memory"]["argument_bytes_per_dev"] == want


# the trace of mamba2's smoke config on the multi-pod mesh (train_4k):
# the redistribute plans it computes and its misses of DTensor's
# propagation cache, measured on PyTorch 2.13 on the CPU; before the
# SSD ran on its shards and the products held their gradients' layout,
# the same trace planned by graph search and gave no result in 9 minutes
SMOKE_PLANS = 12488
SMOKE_MISSES = 44

_SMOKE_TRACE = """
from torch.distributed.tensor import DTensor
from torch.distributed.tensor._redistribute import _gen_transform_infos
from repro_torch.configs import get_smoke_config
from repro_torch.launch import dryrun as D
D.get_config = get_smoke_config
res = D.lower_cell("mamba2-2.7b", "train_4k", True)
prop = DTensor._op_dispatcher.sharding_propagator.propagate_op_sharding
print(res["status"], _gen_transform_infos.cache_info().misses,
      prop.cache_info().misses)
"""


def test_multi_pod_smoke_trace_plans_are_held():
    src = pathlib.Path(__file__).resolve().parents[1] / "src"
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        [str(src), os.environ.get("PYTHONPATH", "")])}
    out = subprocess.run([sys.executable, "-c", _SMOKE_TRACE], env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    status, plans, misses = out.stdout.split()[-3:]
    assert status == "ok"
    assert int(plans) <= SMOKE_PLANS, plans
    assert int(misses) <= SMOKE_MISSES, misses

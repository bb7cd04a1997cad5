"""The port's sharding engine, meshes, int8 compression and the model's
dry-run tools against the JAX package, on the CPU.

* ``dist.sharding``: every resolver case of ``tests/test_sharding.py``
  on both packages with the same ``FakeMesh`` stub, spec for spec, and
  the full parameter tree of every architecture under both parameter
  rule tables on the single-pod, multi-pod and MoE mesh shapes.
* ``Model.abstract_params`` / ``param_axes`` / ``input_specs`` and
  ``make_train_state_specs``: shapes, dtypes and axes equal to the
  reference's.
* DTensor placements and ``launch.mesh`` on many-rank worlds of the
  ``fake`` process group (``torch.testing``; collectives move nothing),
  created and destroyed inside each test (the group is process-global).
* ``dist.compression``: quantization bit-equal to the reference's in
  float32; ``ef_compress_grads`` over a 2-process gloo group (a
  ``FileStore`` under ``tmp_path``) against the reference's
  ``shard_map`` on a 2-device host mesh, both in subprocesses, 3 steps
  of error feedback with different gradients on the two ranks: equal to
  the bit.
"""

import contextlib
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import PartitionSpec as JP
from torch.distributed.tensor import Replicate, Shard, distribute_tensor
from torch.testing._internal.distributed.fake_pg import FakeStore

from repro.configs import SHAPES as J_SHAPES
from repro.configs import get_config as j_get_config
from repro.dist import api as j_api
from repro.dist import compression as j_comp
from repro.dist import sharding as j_sh
from repro.models import build_model as j_build_model
from repro.train import step as j_step
from repro.train.optimizer import OptConfig as JOptConfig
from repro.train.step import TrainConfig as JTrainConfig
from repro_torch.configs import ARCH_IDS, SHAPES, get_config, get_smoke_config
from repro_torch.dist import api as t_api
from repro_torch.dist import compression as t_comp
from repro_torch.dist import sharding as t_sh
from repro_torch.launch import mesh as t_mesh
from repro_torch.models import build_model
from repro_torch.train import OptConfig, TrainConfig
from repro_torch.train.step import make_train_state_specs

SRC = Path(__file__).resolve().parents[1] / "src"


class FakeMesh:
    shape = {"pod": 2, "data": 16, "model": 16}


MESH = FakeMesh()


def _stub(**shape):
    return type("Stub", (), {"shape": shape})()


MESHES = {"single": _stub(data=16, model=16),
          "multi": _stub(pod=2, data=16, model=16),
          "moe": _stub(data=16, expert=8, tp=2),
          "moe_multi": _stub(pod=2, data=16, expert=8, tp=2)}


@contextlib.contextmanager
def fake_world(size, rank=0):
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _flat(tree, prefix=()):
    """{path: leaf} of nested dicts."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = v
    return out


def _both(spec_fn, *args):
    """The spec of both packages for the same inputs; they must agree."""
    got = spec_fn(t_sh, *args)
    want = spec_fn(j_sh, *args)
    assert isinstance(got, t_sh.PartitionSpec)
    assert tuple(got) == tuple(want)
    assert got == want
    return got


# -- the resolver: tests/test_sharding.py's cases ---------------------------

RESOLVER_CASES = [
    # phi4: 24 heads % 16 != 0 -> head_dim takes 'model'
    ("param", (False,), (3072, 24, 128), ("d_model", "heads", "head_dim"),
     JP("data", None, "model")),
    # grok: 48 heads divisible -> heads take 'model', trailing None trimmed
    ("param", (False,), (6144, 48, 128), ("d_model", "heads", "head_dim"),
     JP("data", "model")),
    # zamba: 32 kv heads divisible -> kv_heads win the 'model' axis
    ("act", ("train", False), (32, 32, 1, 4096, 4096),
     ("batch", "kv_heads", "q_per_kv", "q_seq", "kv_seq"),
     JP("data", "model")),
    # internlm: kv 8 not divisible -> q_seq takes it
    ("act", ("train", False), (32, 8, 2, 4096, 4096),
     ("batch", "kv_heads", "q_per_kv", "q_seq", "kv_seq"),
     JP("data", None, None, "model")),
    # long_500k: batch 1 -> cache_seq takes (data, model)
    ("act", ("decode", False), (64, 1, 524_288, 8, 128),
     ("layers", "batch", "cache_seq", "kv_heads", "head_dim"),
     JP(None, None, ("data", "model"))),
    ("act_opt", ("train", True), (256, 4096, 3072),
     ("batch", "seq", "d_model"), JP(("pod", "data"), "model")),
]
_RULES = {"param": "param_rules", "param_opt": "param_rules_opt",
          "act": "act_rules", "act_opt": "act_rules_opt"}


@pytest.mark.parametrize("table,args,shape,axes,want", RESOLVER_CASES)
def test_resolver_cases_match_the_reference(table, args, shape, axes, want):
    got = _both(lambda m: m.spec_for(shape, axes,
                                     getattr(m, _RULES[table])(*args), MESH))
    assert got == want


def test_one_mesh_axis_per_tensor():
    for a in ARCH_IDS:
        cfg = get_config(a)
        spec = _both(lambda m: m.spec_for(
            (cfg.padded_vocab, cfg.d_model), ("vocab", "d_model"),
            m.param_rules(multi_pod=False), MESH))
        used = [x for part in spec if part
                for x in (part if isinstance(part, tuple) else (part,))]
        assert len(used) == len(set(used))


def test_rule_tables_equal_the_reference():
    for mp in (False, True):
        for name in ("param_rules", "param_rules_opt"):
            got, want = getattr(t_sh, name)(mp), getattr(j_sh, name)(mp)
            assert list(got.items()) == list(want.items())
        for kind in ("train", "prefill", "decode"):
            for name in ("act_rules", "act_rules_opt"):
                got = getattr(t_sh, name)(kind, mp)
                want = getattr(j_sh, name)(kind, mp)
                assert list(got.items()) == list(want.items())


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_resolve_profile_matches_the_reference(arch):
    for profile in ("opt", "base"):
        for kind in ("train", "decode"):
            for mp in (False, True):
                got = t_sh.resolve_profile(profile, get_config(arch), kind,
                                           mp)
                want = j_sh.resolve_profile(profile, j_get_config(arch),
                                            kind, mp)
                assert got == want
    moe = arch in ("grok-1-314b", "phi3.5-moe-42b-a6.6b")
    assert t_sh.resolve_profile("opt", get_config(arch), "train",
                                False)[2] == ("moe" if moe else "canonical")


# -- the model's parameter tree under every table and mesh ------------------

@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_tree_specs_match_the_reference(arch, mesh):
    tm = build_model(get_config(arch))
    jm = j_build_model(j_get_config(arch))
    m = MESHES[mesh]
    mp = "pod" in m.shape
    for table in ("param_rules", "param_rules_opt"):
        got = _flat(t_sh.param_specs_tree(
            tm.param_axes(), tm.abstract_params(), m,
            getattr(t_sh, table)(mp)))
        want = _flat(j_sh.param_specs_tree(
            jm.param_axes(), jm.abstract_params(), m,
            getattr(j_sh, table)(mp)))
        assert sorted(got) == sorted(want)      # jax sorts dict keys
        for path, spec in got.items():
            assert tuple(spec) == tuple(want[path]), (table, path)


# -- the dry-run tools on Model ---------------------------------------------

def _shape_dtype(x):
    return tuple(x.shape), str(x.dtype).removeprefix("torch.")


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_abstract_params_axes_and_input_specs_match_the_reference(arch):
    """``abstract_params`` gives meta tensors (nothing allocated) with the
    reference's shapes and dtypes, in float32 and bf16; ``param_axes``
    the same axes; ``input_specs`` the same keys, shapes, dtypes and axes
    for every assigned shape."""
    tm = build_model(get_config(arch))
    jm = j_build_model(j_get_config(arch))
    for tdt, jdt in ((torch.float32, jnp.float32),
                     (torch.bfloat16, jnp.bfloat16)):
        got = _flat(tm.abstract_params(tdt))
        want = _flat(jm.abstract_params(jdt))
        assert list(got) == list(want)
        for path, t in got.items():
            assert t.device.type == "meta"
            assert _shape_dtype(t) == (tuple(want[path].shape),
                                       want[path].dtype.name), path
    assert _flat(tm.param_axes()) == _flat(jm.param_axes())
    for name in SHAPES:
        batch, axes = tm.input_specs(SHAPES[name])
        jbatch, jaxes = jm.input_specs(J_SHAPES[name])
        assert list(batch) == list(jbatch) and axes == jaxes
        for k, t in batch.items():
            assert t.device.type == "meta"
            assert _shape_dtype(t) == (tuple(jbatch[k].shape),
                                       jbatch[k].dtype.name), (name, k)


def test_input_specs_cover_every_input_kind():
    kinds = {}
    for arch in ARCH_IDS:
        cfg = get_config(arch)
        batch, _ = build_model(cfg).input_specs(SHAPES["train_4k"])
        kinds[cfg.input_kind] = sorted(batch)
    assert kinds == {"tokens": ["targets", "tokens"],
                     "embeds": ["embeds", "targets"],
                     "frames+tokens": ["frames", "targets", "tokens"]}


@pytest.mark.parametrize("opt", ["adamw", "adamw8bit"])
@pytest.mark.parametrize("arch", ["internlm2-1.8b", "qwen2-vl-72b"])
def test_make_train_state_specs_match_the_reference(arch, opt):
    """The abstract state's shapes and dtypes equal the reference's, and
    each leaf's placements over a 256-rank (data 16, model 16) mesh are
    those of the reference's spec for it."""
    jm = j_build_model(j_get_config(arch))
    jmesh = jax.sharding.Mesh(np.asarray(jax.devices()[:1]).reshape(1, 1),
                              ("data", "model"))
    jctx = j_api.ShardingContext(jmesh, j_sh.act_rules("train"),
                                 j_sh.param_rules())
    jabs, _ = j_step.make_train_state_specs(
        jm, JTrainConfig(opt=JOptConfig(name=opt)), jctx)
    want_specs = j_sh.param_specs_tree(jm.param_axes(), jm.abstract_params(),
                                       MESHES["single"], j_sh.param_rules())
    with fake_world(256):
        mesh = t_mesh.make_production_mesh(device="cpu")
        ctx = t_api.ShardingContext(mesh, t_sh.act_rules("train"),
                                    t_sh.param_rules())
        tabs, placements = make_train_state_specs(
            build_model(get_config(arch)), TrainConfig(opt=OptConfig(
                name=opt)), ctx)
        got, want = _flat(tabs), _flat(jabs)
        assert sorted(got) == sorted(want)      # jax sorts dict keys
        for path, t in got.items():
            assert t.device.type == "meta"
            assert _shape_dtype(t) == (tuple(want[path].shape),
                                       want[path].dtype.name), path
        pl = _flat(placements)
        assert list(pl) == list(got)
        for path, spec in _flat(want_specs).items():
            assert pl[("params",) + path] == t_sh.placements_for(
                tuple(spec), mesh), path
        assert pl[("step",)] == (Replicate(), Replicate())


# -- placements and DTensor local shapes on an 8-rank world -----------------

def test_placements_for_a_spec():
    with fake_world(8):
        mesh = t_mesh.make_local_mesh(2, 4, device="cpu")
        pf = t_sh.placements_for
        assert pf(t_sh.PartitionSpec(), mesh) == (Replicate(), Replicate())
        assert pf(t_sh.PartitionSpec("data", None, "model"), mesh) == (
            Shard(0), Shard(2))
        assert pf(t_sh.PartitionSpec(None, ("data", "model")), mesh) == (
            Shard(1), Shard(1))


@pytest.mark.parametrize("rank", [0, 5])
def test_dtensor_local_shapes_on_an_8_rank_world(rank):
    """Every parameter of the internlm2 smoke model placed by
    ``param_rules`` over a (data 2, model 4) mesh: each rank's local
    shape is the spec's block; a combined (data, model) group gives the
    rank at mesh coordinate (d, m) block d * 4 + m, JAX's layout for a
    group listed in the mesh's order."""
    tm = build_model(get_smoke_config("internlm2-1.8b"))
    with fake_world(8, rank):
        mesh = t_mesh.make_local_mesh(2, 4, device="cpu")
        sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
        specs = t_sh.param_specs_tree(tm.param_axes(), tm.abstract_params(),
                                      mesh, t_sh.param_rules())
        shapes = _flat(tm.param_shapes())
        sharded = 0
        for path, spec in _flat(specs).items():
            shape = shapes[path]
            d = distribute_tensor(torch.zeros(shape), mesh,
                                  t_sh.placements_for(spec, mesh),
                                  src_data_rank=None)
            want = list(shape)
            for i, entry in enumerate(spec):
                for a in (() if entry is None else
                          (entry if isinstance(entry, tuple) else (entry,))):
                    want[i] //= sizes[a]
            assert tuple(d.to_local().shape) == tuple(want), path
            sharded += tuple(want) != tuple(shape)
        assert sharded > 0
        spec = t_sh.spec_for((16, 3), ("cache_seq", "head_dim"),
                             t_sh.act_rules("decode"), mesh)
        assert spec == JP(("data", "model"))
        x = torch.arange(48.0).reshape(16, 3)
        d = distribute_tensor(x, mesh, t_sh.placements_for(spec, mesh),
                              src_data_rank=None)
        dc, mc = mesh.get_coordinate()
        blk = dc * 4 + mc
        assert torch.equal(d.to_local(), x[2 * blk:2 * blk + 2])


def test_constrain_redistributes_a_dtensor_under_a_context():
    x = torch.zeros(8, 32, 96)
    assert t_api.constrain(x, ("batch", "seq", "d_model")) is x
    with fake_world(8, rank=3):
        mesh = t_mesh.make_local_mesh(2, 4, device="cpu")
        d = distribute_tensor(x, mesh, [Replicate(), Replicate()],
                              src_data_rank=None)
        axes = ("batch", "seq", "d_model")
        ctx = t_api.ShardingContext(mesh, t_sh.act_rules("train"),
                                    t_sh.param_rules())
        with t_api.use_sharding(ctx):
            assert t_api.active_context() is ctx
            assert t_api.constrain(x, axes) is x       # no layout to change
            assert t_api.constrain(d, axes).placements == (Shard(0),
                                                           Replicate())
            ctx.act_rules = t_sh.act_rules_opt("train")
            assert t_api.constrain(d, axes).placements == (Shard(0),
                                                           Shard(1))
        assert t_api.active_context() is None


# -- launch.mesh ------------------------------------------------------------

@pytest.mark.parametrize("which,world,shape,names", [
    ("production", 256, (16, 16), ("data", "model")),
    ("production_multi", 512, (2, 16, 16), ("pod", "data", "model")),
    ("moe", 256, (16, 8, 2), ("data", "expert", "tp")),
    ("local", 8, (2, 4), ("data", "model")),
    ("local_pod", 16, (2, 2, 4), ("pod", "data", "model")),
])
def test_meshes_have_the_reference_shapes(which, world, shape, names):
    make = {"production": lambda: t_mesh.make_production_mesh(device="cpu"),
            "production_multi": lambda: t_mesh.make_production_mesh(
                multi_pod=True, device="cpu"),
            "moe": lambda: t_mesh.make_moe_mesh(device="cpu"),
            "local": lambda: t_mesh.make_local_mesh(device="cpu"),
            "local_pod": lambda: t_mesh.make_local_mesh(pod=2,
                                                        device="cpu")}
    with fake_world(world, rank=world - 1):
        m = make[which]()
        assert tuple(m.shape) == shape and m.mesh_dim_names == names
        assert m.get_coordinate() == tuple(s - 1 for s in shape)


def test_mesh_raises_when_the_world_is_too_small():
    with pytest.raises(RuntimeError, match="need 256 ranks, have 0"):
        t_mesh.make_production_mesh(device="cpu")
    with fake_world(8):
        with pytest.raises(RuntimeError, match="need 512 ranks, have 8"):
            t_mesh.make_production_mesh(multi_pod=True, device="cpu")
        with pytest.raises(RuntimeError, match="need 256 ranks"):
            t_mesh.make_moe_mesh(device="cpu")


def test_mesh_over_the_first_ranks_of_a_larger_world():
    with fake_world(16, rank=5):
        m = t_mesh.make_local_mesh(2, 4, device="cpu")
        assert tuple(m.shape) == (2, 4)
        assert m.get_coordinate() == (1, 1)


def test_mesh_import_touches_no_process_group():
    r = subprocess.run(
        [sys.executable, "-c", "import torch.distributed as d; "
         "import repro_torch.launch.mesh; print(d.is_initialized())"],
        capture_output=True, text=True, timeout=120,
        env={**os.environ, "PYTHONPATH": str(SRC)})
    assert r.stdout.strip() == "False", r.stderr[-1000:]


# -- int8 error-feedback compression ----------------------------------------

def _grads_with_specials(seed, shape=(8, 32)):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    x[1] = 0.0                          # an all-zero row: scale 0
    x[2, 3], x[3, 5], x[4, 0] = np.inf, -np.inf, np.nan
    return x


def test_quantize_int8_is_bit_equal_to_the_reference():
    x = np.concatenate([_grads_with_specials(0), 1e-30 * _grads_with_specials(
        1), 3e4 * np.random.default_rng(2).standard_normal((4, 32))]
        ).astype(np.float32)
    q, s = t_comp.quantize_int8(torch.as_tensor(x))
    jq, js = j_comp.quantize_int8(jnp.asarray(x))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    np.testing.assert_array_equal(t_comp.dequantize_int8(q, s).numpy(),
                                  np.asarray(j_comp.dequantize_int8(jq, js)))
    assert not t_comp.dequantize_int8(q, s)[1].any()
    assert torch.isfinite(t_comp.dequantize_int8(q, s)).all()


_EF_STEPS = 3

_EF_PORT = textwrap.dedent("""
    import sys
    import numpy as np
    import torch
    import torch.distributed as dist
    import torch.multiprocessing as mp
    from repro_torch.dist.compression import ef_compress_grads
    from repro_torch.launch.mesh import make_local_mesh  # noqa: F401

    def run(rank, path):
        store = dist.FileStore(path + "/store", 2)
        dist.init_process_group("gloo", store=store, rank=rank,
                                world_size=2)
        from torch.distributed.device_mesh import init_device_mesh
        mesh = init_device_mesh("cpu", (2,), mesh_dim_names=("pod",))
        inp = np.load(path + "/inputs.npz")
        res = {"w": torch.zeros(8, 32), "b": {"x": torch.zeros(3, 16)}}
        out = {}
        for s in range(STEPS):
            g = {"w": torch.as_tensor(inp[f"w{s}_{rank}"]),
                 "b": {"x": torch.as_tensor(inp[f"x{s}_{rank}"])}}
            red, res = ef_compress_grads(g, res, mesh, axis_name="pod")
            out[f"red_w{s}"] = red["w"].numpy()
            out[f"red_x{s}"] = red["b"]["x"].numpy()
            out[f"res_w{s}"] = res["w"].numpy()
            out[f"res_x{s}"] = res["b"]["x"].numpy()
        np.savez(path + f"/port_{rank}.npz", **out)
        dist.destroy_process_group()

    if __name__ == "__main__":
        mp.spawn(run, args=(sys.argv[1],), nprocs=2, join=True)
        print("PORT_OK")
""").replace("STEPS", str(_EF_STEPS))

_EF_REF = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
    import numpy as np
    import jax, jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P
    from repro.dist.compression import ef_compress_grads

    path = sys.argv[1]
    devs = jax.devices()[:2]
    mesh = jax.sharding.Mesh(np.asarray(devs), ("pod",))
    rep = NamedSharding(mesh, P())

    def per_device(a0, a1):
        # one value per device under a replicated spec: what each pod
        # holds before the reduction
        return jax.make_array_from_single_device_arrays(
            a0.shape, rep, [jax.device_put(a0, devs[0]),
                            jax.device_put(a1, devs[1])])

    def shard(a, i):
        return np.asarray([s.data for s in a.addressable_shards
                           if s.device == devs[i]][0])

    inp = np.load(path + "/inputs.npz")
    z = lambda *sh: np.zeros(sh, np.float32)
    res = {"w": per_device(z(8, 32), z(8, 32)),
           "b": {"x": per_device(z(3, 16), z(3, 16))}}
    out = {0: {}, 1: {}}
    with mesh:
        for s in range(STEPS):
            g = {"w": per_device(inp[f"w{s}_0"], inp[f"w{s}_1"]),
                 "b": {"x": per_device(inp[f"x{s}_0"], inp[f"x{s}_1"])}}
            red, res = ef_compress_grads(g, res, mesh, axis_name="pod")
            for i in (0, 1):
                out[i][f"red_w{s}"] = shard(red["w"], i)
                out[i][f"red_x{s}"] = shard(red["b"]["x"], i)
                out[i][f"res_w{s}"] = shard(res["w"], i)
                out[i][f"res_x{s}"] = shard(res["b"]["x"], i)
    for i in (0, 1):
        np.savez(path + f"/ref_{i}.npz", **out[i])
    print("REF_OK")
""").replace("STEPS", str(_EF_STEPS))


def test_ef_compress_grads_over_gloo_matches_the_reference(tmp_path):
    """Three steps of EF-compressed mean-reduction over the pod axis,
    the two ranks' gradients different (one with an inf, a -inf and a
    NaN): the reduced values and each rank's residual equal the
    reference's on the same device to the bit."""
    rng = np.random.default_rng(7)
    inp = {}
    for s in range(_EF_STEPS):
        for r in (0, 1):
            inp[f"w{s}_{r}"] = (_grads_with_specials(10 * s + r) if s == 1
                                else rng.standard_normal((8, 32)).astype(
                                    np.float32))
            inp[f"x{s}_{r}"] = (1e-3 * rng.standard_normal((3, 16))).astype(
                np.float32)
    np.savez(tmp_path / "inputs.npz", **inp)
    env = {**os.environ, "PYTHONPATH": str(SRC)}
    runs = {}
    for name, prog in (("port", _EF_PORT), ("ref", _EF_REF)):
        script = tmp_path / f"{name}.py"
        script.write_text(prog)
        runs[name] = subprocess.run(
            [sys.executable, str(script), str(tmp_path)], capture_output=True,
            text=True, timeout=300, env={**env, "JAX_PLATFORMS": "cpu"})
    assert "PORT_OK" in runs["port"].stdout, runs["port"].stderr[-2000:]
    assert "REF_OK" in runs["ref"].stdout, runs["ref"].stderr[-2000:]
    for r in (0, 1):
        got = np.load(tmp_path / f"port_{r}.npz")
        want = np.load(tmp_path / f"ref_{r}.npz")
        assert sorted(got.files) == sorted(want.files)
        for k in want.files:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
            assert np.isfinite(got[k]).all(), k
    a, b = (np.load(tmp_path / f"port_{r}.npz") for r in (0, 1))
    np.testing.assert_array_equal(a["red_w0"], b["red_w0"])
    assert not np.array_equal(a["res_w0"], b["res_w0"])

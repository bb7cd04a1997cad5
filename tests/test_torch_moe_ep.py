"""The port's expert-parallel MoE (``models.moe.moe_block_ep``) against
the JAX package's ``moe_block_ep`` and the port's ``moe_block``, on the
CPU.

Two subprocesses run side by side on the same numpy inputs (the
``grok1-smoke`` MoE layer, 4 experts top-2 of d_ff 128, GeGLU, with
capacity_factor 4.0 so that nothing drops, as ``tests/test_moe_ep.py``
does; a (4, 16, 64) float32 ``x``):

* the port: an 8-process gloo world over a ``FileStore`` under
  ``tmp_path``, a (data 2, expert 2, tp 2) ``DeviceMesh``; parameters
  from ``params_from_numpy``; ``moe_block_ep`` in the train and the
  decode forms, and the gradients of sum(y^2) with respect to ``x`` and
  every weight; rank 0 also runs ``moe_block`` on the same inputs;
* the reference: its ``moe_block_ep`` (a ``shard_map``) on an
  8-device host mesh of the same shape, as ``tests/test_moe_ep.py``
  runs it.

Tolerances are the reference's own test's: ``y`` 1e-4 and the router
probabilities 1e-5 max-abs; gradients 1e-4 max-abs against
``moe_block``'s.  A weight built as ``arange`` shows which block of an
expert weight each rank holds in decode: the reference's ("tp",
"data") order on d_ff, which DTensor's placements cannot express.
"""

import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

from repro_torch.configs import get_smoke_config
from repro_torch.models import build_model

SRC = Path(__file__).resolve().parents[1] / "src"
ARCH = "grok-1-314b"
X_SHAPE = (4, 16)           # (B, S); B divisible by the data axis
GRADS = ("x", "router", "w_gate", "w_up", "w_down")

_COMMON = textwrap.dedent("""
    import dataclasses
    import numpy as np

    def nest(flat):
        tree = {}
        for key, a in flat.items():
            if not key.startswith("p/"):
                continue
            node = tree
            *path, leaf = key[2:].split("/")
            for k in path:
                node = node.setdefault(k, {})
            node[leaf] = a
        return tree
""")

_PORT = _COMMON + textwrap.dedent("""
    import sys
    import torch
    import torch.distributed as dist
    import torch.multiprocessing as mp
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import distribute_tensor
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import params_from_numpy
    from repro_torch.models.moe import (_local_weight, _placements,
                                        moe_block, moe_block_ep)

    def run(rank, path):
        torch.set_num_threads(1)
        dist.init_process_group("gloo", store=dist.FileStore(
            path + "/store", 8), rank=rank, world_size=8)
        mesh = init_device_mesh("cpu", (2, 2, 2),
                                mesh_dim_names=("data", "expert", "tp"))
        cfg = dataclasses.replace(get_smoke_config("ARCH"),
                                  capacity_factor=4.0)
        inp = dict(np.load(path + "/inputs.npz"))
        tree = params_from_numpy(cfg, nest(inp), device="cpu",
                                 compute_dtype=torch.float32)
        p0 = {k: v[0] for k, v in tree["blocks"]["moe"].items()}
        out = {}

        def run_block(fn, tag, **kw):
            x = torch.from_numpy(inp["x"]).requires_grad_(True)
            p = {k: v.clone().requires_grad_(True) for k, v in p0.items()}
            y, probs = fn(x, p, cfg, compute_dtype=torch.float32, **kw)
            (y ** 2).sum().backward()
            out[f"{tag}_y"] = y.detach().numpy()
            out[f"{tag}_probs"] = probs.detach().numpy()
            out[f"{tag}_g_x"] = x.grad.numpy()
            for k, v in p.items():
                out[f"{tag}_g_{k}"] = v.grad.numpy()

        for decode in (False, True):
            run_block(lambda *a, **kw: moe_block_ep(*a[:2], a[2], mesh,
                                                    decode=decode, **kw),
                      f"ep{int(decode)}")
        if rank == 0:
            run_block(moe_block, "dense")
        # which block of an expert weight this rank holds in decode
        E, D, F = p0["w_up"].shape
        ar = torch.arange(E * D * F, dtype=torch.float32)
        for name, shape, f_dim in (("w_up", (E, D, F), 2),
                                   ("w_down", (E, F, D), 1)):
            rest = _placements(mesh, expert=0, tp=f_dim,
                               data=3 - f_dim)
            w = distribute_tensor(ar.reshape(shape), mesh, rest)
            for decode in (False, True):
                out[f"block_{name}_{int(decode)}"] = _local_weight(
                    w, mesh, f_dim, decode).numpy()
        np.savez(path + f"/port_{rank}.npz", **out)
        dist.destroy_process_group()

    if __name__ == "__main__":
        mp.spawn(run, args=(sys.argv[1],), nprocs=8, join=True)
        print("PORT_OK")
""").replace("ARCH", ARCH)

_REF = _COMMON + textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import jax, jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P
    from repro.configs import get_smoke_config
    from repro.models.moe import moe_block_ep

    path = sys.argv[1]
    cfg = dataclasses.replace(get_smoke_config("ARCH"),
                              capacity_factor=4.0)
    mesh = jax.sharding.Mesh(np.asarray(jax.devices()[:8]).reshape(2, 2, 2),
                             ("data", "expert", "tp"))
    inp = dict(np.load(path + "/inputs.npz"))
    p = jax.tree_util.tree_map(lambda a: jnp.asarray(a[0]),
                               nest(inp)["blocks"]["moe"])
    x = jnp.asarray(inp["x"])
    out = {}
    with mesh:
        for decode in (False, True):
            y, probs = jax.jit(lambda x, p: moe_block_ep(
                x, p, cfg, mesh, compute_dtype=jnp.float32,
                decode=decode))(x, p)
            out[f"ep{int(decode)}_y"] = np.asarray(y)
            out[f"ep{int(decode)}_probs"] = np.asarray(probs)
    E, D, F = p["w_up"].shape
    ar = np.arange(E * D * F, dtype=np.float32)
    for name, shape, specs in (
            ("w_up", (E, D, F), {0: P("expert", "data", "tp"),
                                 1: P("expert", None, ("tp", "data"))}),
            ("w_down", (E, F, D), {0: P("expert", "tp", "data"),
                                   1: P("expert", ("tp", "data"), None)})):
        for decode, spec in specs.items():
            a = jax.device_put(ar.reshape(shape), NamedSharding(mesh, spec))
            idx = {s.device: s.index for s in a.addressable_shards}
            for d, e, t in np.ndindex(2, 2, 2):
                r = d * 4 + e * 2 + t
                out[f"index_{name}_{decode}_{r}"] = np.asarray(
                    [[sl.start or 0, sl.stop or n] for sl, n in
                     zip(idx[mesh.devices[d, e, t]], shape)])
    np.savez(path + "/ref.npz", **out)
    print("REF_OK")
""").replace("ARCH", ARCH)


def _inputs(path):
    """The smoke model's whole parameter tree (numpy, seeded), flattened
    as "p/<path>", and ``x``."""
    cfg = get_smoke_config(ARCH)
    rng = np.random.default_rng(11)
    flat = {}

    def walk(node, prefix):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v, prefix + (k,))
            else:
                fan_in = v[-2] if len(v) > 1 else v[-1]
                flat["p/" + "/".join(prefix + (k,))] = (
                    rng.standard_normal(v) / np.sqrt(fan_in)).astype(
                        np.float32)
    walk(build_model(cfg).param_shapes(), ())
    flat["x"] = rng.standard_normal(X_SHAPE + (cfg.d_model,)).astype(
        np.float32)
    np.savez(path / "inputs.npz", **flat)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    path = tmp_path_factory.mktemp("moe_ep")
    _inputs(path)
    env = {**os.environ, "PYTHONPATH": str(SRC), "JAX_PLATFORMS": "cpu",
           "OMP_NUM_THREADS": "1"}
    procs = {}
    for name, prog in (("port", _PORT), ("ref", _REF)):
        script = path / f"{name}.py"
        script.write_text(prog)
        procs[name] = subprocess.Popen(
            [sys.executable, str(script), str(path)], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    for name, proc in procs.items():
        out, err = proc.communicate(timeout=600)
        assert f"{name.upper()}_OK" in out, err[-3000:]
    return ({r: dict(np.load(path / f"port_{r}.npz")) for r in range(8)},
            dict(np.load(path / "ref.npz")))


def _maxabs(a, b):
    return float(np.max(np.abs(np.asarray(a, np.float64)
                               - np.asarray(b, np.float64))))


@pytest.mark.parametrize("decode", [False, True])
def test_ep_matches_the_reference_ep(runs, decode):
    port, ref = runs
    tag = f"ep{int(decode)}"
    for r in (0, 5):
        assert _maxabs(port[r][f"{tag}_y"], ref[f"{tag}_y"]) < 1e-4
        assert _maxabs(port[r][f"{tag}_probs"], ref[f"{tag}_probs"]) < 1e-5


@pytest.mark.parametrize("decode", [False, True])
def test_ep_matches_the_dense_block(runs, decode):
    """In decode the probs are the data ranks' copies stacked, as the
    reference's ``out_specs`` gives them."""
    port, _ = runs
    tag = f"ep{int(decode)}"
    dense = port[0]["dense_probs"]
    if decode:
        dense = np.concatenate([dense, dense])
    assert _maxabs(port[0][f"{tag}_y"], port[0]["dense_y"]) < 1e-4
    assert _maxabs(port[0][f"{tag}_probs"], dense) < 1e-5
    assert np.abs(port[0]["dense_y"]).max() > 0.1


@pytest.mark.parametrize("decode", [False, True])
def test_ep_gradients_match_the_dense_block(runs, decode):
    """d sum(y^2) / d x and / d each weight, on two ranks: each holds the
    whole gradient of the global inputs."""
    port, _ = runs
    tag = f"ep{int(decode)}"
    for r in (0, 7):
        for g in GRADS:
            want = port[0][f"dense_g_{g}"]
            assert np.abs(want).max() > 0, g
            assert _maxabs(port[r][f"{tag}_g_{g}"], want) < 1e-4, (r, g)


@pytest.mark.parametrize("name", ["w_up", "w_down"])
@pytest.mark.parametrize("decode", [False, True])
def test_each_rank_holds_the_reference_block(runs, name, decode):
    """The expert-weight slice each rank computes with: the reference's
    in_spec block, D whole in train/prefill (gathered over data), and
    in decode the d_ff block at tp * |data| + data (("tp", "data"))."""
    port, ref = runs
    cfg = get_smoke_config(ARCH)
    E, D, F = cfg.n_experts, cfg.d_model, cfg.d_ff
    shape = (E, D, F) if name == "w_up" else (E, F, D)
    d_dim = 1 if name == "w_up" else 2
    full = np.arange(E * D * F, dtype=np.float32).reshape(shape)
    starts = set()
    for r in range(8):
        idx = ref[f"index_{name}_{int(decode)}_{r}"].copy()
        if not decode:          # the body gathers D over data
            idx[d_dim] = (0, shape[d_dim])
        want = full[tuple(slice(a, b) for a, b in idx)]
        got = port[r][f"block_{name}_{int(decode)}"]
        np.testing.assert_array_equal(got, want, err_msg=str(r))
        starts.add(tuple(idx[:, 0]))
    assert len(starts) == (8 if decode else 4)

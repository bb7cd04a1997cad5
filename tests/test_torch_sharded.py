"""The port's sharded step on the CPU: DTensor parameters, the model's
``constrain`` sites and the flash operators' registered sharding,
against the unsharded port and the JAX package.

* A 2-process gloo world (a ``FileStore`` under the test's tmp dir; a
  subprocess, since a process group is process-global) over
  ``make_local_mesh(1, 2, device="cpu")``: the internlm2 smoke model in
  float32, its parameters ``DTensor``s placed by ``param_rules``
  (heads, KV heads, d_ff and vocab over ``model``), runs a prefill and
  one training loss with its gradients under ``use_sharding``.  The
  attention goes through ``impl="kernel"``: its CPU wrapper runs the
  plain version on each rank's local shards, through the operators'
  ``register_sharding`` strategies.  The results must equal the
  unsharded port at 1e-5 and the JAX ``lm_forward`` / ``lm_loss`` at
  the parity tests' tolerances (logits and cache 1e-4; loss 1e-5
  relative; each gradient leaf 1e-4 relative L2).
* The flash op alone on heads-sharded and batch-sharded DTensor inputs:
  the output stays in the input's placement (the operator ran on the
  local shards) and equals the unsharded op, with its gradients, at
  1e-5.
* The SSD operators in a second 2-process world: the mamba2 smoke model
  (float32, the JAX package's weights) runs a prefill and one loss with
  its gradients on a (data 2, model 1) mesh, where the SSD runs
  batch-sharded and dA comes back as a partial sum, and on (data 1,
  model 2), against the unsharded port and JAX at the same tolerances;
  the operators alone, heads- and batch-sharded, keep the inputs'
  placement, return the partial sums as partial (dB and dC under
  heads, dA under batch) and equal the unsharded op at 1e-5.
* On ``fake`` worlds (collectives move nothing): ``CollectiveCounter``
  sees the redistribution a ``constrain`` call requests, with its bytes
  (8 ranks), and the model's constrain sites are what changes the
  collectives of a prefill between two rule tables (4 ranks, (data 2,
  model 2), where every head count of the smoke model divides).
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
from torch.distributed.tensor import Replicate, Shard, distribute_tensor
from torch.testing._internal.distributed.fake_pg import FakeStore

from repro.configs import get_smoke_config as j_get_smoke
from repro.models import build_model as j_build_model
from repro.models.transformer import lm_forward as j_lm_forward
from repro_torch.configs import get_smoke_config
from repro_torch.dist import api as t_api
from repro_torch.dist import sharding as t_sh
from repro_torch.launch import mesh as t_mesh
from repro_torch.models import build_model, params_from_numpy
from repro_torch.roofline.counters import count_collectives
from repro_torch.train.optimizer import _leaves, _tree_map

torch.set_num_threads(1)

SRC = Path(__file__).resolve().parents[1] / "src"
ARCH = "internlm2-1.8b"
B, S = 4, 16
FLASH = (4, 16, 4, 2, 16)        # B, S, H, K, hd

_PORT = textwrap.dedent("""
    import sys
    import numpy as np
    import torch
    import torch.distributed as dist
    import torch.multiprocessing as mp
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from repro_torch.configs import get_smoke_config
    from repro_torch.dist import api, sharding as sh
    from repro_torch.kernels.attention import ops as attn_ops
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import build_model, params_from_numpy
    from repro_torch.train.optimizer import _leaves, _tree_map

    def nest(flat):
        tree = {}
        for key, a in flat.items():
            if key.startswith("p/"):
                node = tree
                *path, leaf = key[2:].split("/")
                for k in path:
                    node = node.setdefault(k, {})
                node[leaf] = a
        return tree

    def run(rank, path):
        torch.set_num_threads(1)
        dist.init_process_group("gloo", store=dist.FileStore(
            path + "/store", 2), rank=rank, world_size=2)
        mesh = make_local_mesh(1, 2, device="cpu")
        cfg = get_smoke_config("ARCH")
        inp = dict(np.load(path + "/inputs.npz"))
        model = build_model(cfg, torch.float32)
        tree = params_from_numpy(cfg, nest(inp), device="cpu",
                                 compute_dtype=torch.float32,
                                 param_dtype=torch.float32)
        specs = sh.param_specs_tree(model.param_axes(),
                                    model.abstract_params(), mesh,
                                    sh.param_rules())
        params = _tree_map(lambda t, s: distribute_tensor(
            t, mesh, sh.placements_for(s, mesh)), tree, specs)
        out = {"n_sharded": sum(any(p != Replicate() for p in t.placements)
                                for t in _leaves(params))}

        def batch(names, kind):
            rules = sh.act_rules(kind)
            return {n: distribute_tensor(
                torch.from_numpy(inp[n]), mesh, sh.placements_for(
                    sh.spec_for(inp[n].shape, ("batch", "seq"), rules,
                                mesh), mesh)) for n in names}

        ctx = api.ShardingContext(mesh, sh.act_rules("prefill"),
                                  sh.param_rules())
        with api.use_sharding(ctx), torch.no_grad():
            logits, cache = model.prefill(params, batch(["tokens"],
                                                        "prefill"))
        out["logits"] = logits.full_tensor().numpy()
        out["cache_k"] = cache["k"].full_tensor().numpy()
        out["cache_v"] = cache["v"].full_tensor().numpy()

        for t in _leaves(params):
            t.requires_grad_(True)
        ctx = api.ShardingContext(mesh, sh.act_rules("train"),
                                  sh.param_rules())
        with api.use_sharding(ctx):
            loss, mets = model.loss(params, batch(["tokens", "targets"],
                                                  "train"))
            loss.backward()
        out["loss"] = loss.detach().full_tensor().numpy()
        for i, t in enumerate(_leaves(params)):
            out[f"grad_{i}"] = t.grad.full_tensor().numpy()

        # the flash op alone, heads- and batch-sharded over "model"
        for name, dim in (("heads", 2), ("batch", 0)):
            qkv, w = ([distribute_tensor(torch.from_numpy(inp[n]), mesh,
                                         [Replicate(), Shard(dim)])
                       for n in ("q", "k", "v", "w")][i:j]
                      for i, j in ((0, 3), (3, 4)))
            o = attn_ops.flash_attention(*qkv, causal=True, impl="kernel")
            out[f"{name}_placement"] = np.asarray(
                [o.placements[1] == Shard(dim)])
            out[f"{name}_out"] = o.detach().full_tensor().numpy()
            for t in qkv:
                t.requires_grad_(True)
            o = attn_ops.flash_attention(*qkv, causal=True, impl="kernel")
            (o * w[0]).sum().backward()
            for n, t in zip("qkv", qkv):
                out[f"{name}_d{n}"] = t.grad.full_tensor().numpy()
        np.savez(path + f"/port_{rank}.npz", **out)
        dist.destroy_process_group()

    if __name__ == "__main__":
        mp.spawn(run, args=(sys.argv[1],), nprocs=2, join=True)
        print("PORT_OK")
""").replace("ARCH", ARCH)


def _flatten(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flatten(v, prefix + (k,)))
        else:
            out["p/" + "/".join(prefix + (k,))] = np.asarray(v)
    return out


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    """The JAX weights and batch, the flash inputs, and the port's
    2-rank results (rank 0, rank 1)."""
    path = tmp_path_factory.mktemp("sharded")
    jm = j_build_model(j_get_smoke(ARCH), compute_dtype=jnp.float32)
    tree = jax.tree_util.tree_map(np.asarray,
                                  jm.init_params(jax.random.PRNGKey(0)))
    rng = np.random.default_rng(5)
    cfg = get_smoke_config(ARCH)
    toks = rng.integers(0, cfg.vocab_size, (B, S + 1)).astype(np.int32)
    b, s, h, k, hd = FLASH
    inp = {**_flatten(tree), "tokens": toks[:, :-1], "targets": toks[:, 1:],
           "q": rng.standard_normal((b, s, h, hd)).astype(np.float32),
           "k": rng.standard_normal((b, s, k, hd)).astype(np.float32),
           "v": rng.standard_normal((b, s, k, hd)).astype(np.float32),
           "w": rng.standard_normal((b, s, h, hd)).astype(np.float32)}
    np.savez(path / "inputs.npz", **inp)
    script = path / "port.py"
    script.write_text(_PORT)
    r = subprocess.run([sys.executable, str(script), str(path)],
                       capture_output=True, text=True, timeout=600,
                       env={**os.environ, "PYTHONPATH": str(SRC),
                            "OMP_NUM_THREADS": "1"})
    assert "PORT_OK" in r.stdout, r.stderr[-3000:]
    return jm, tree, inp, [dict(np.load(path / f"port_{i}.npz"))
                           for i in (0, 1)]


def _unsharded(tree, inp):
    cfg = get_smoke_config(ARCH)
    model = build_model(cfg, torch.float32)
    params = params_from_numpy(cfg, tree, device="cpu",
                               compute_dtype=torch.float32,
                               param_dtype=torch.float32)
    with torch.no_grad():
        logits, cache = model.prefill(
            params, {"tokens": torch.from_numpy(inp["tokens"])})
    for t in _leaves(params):
        t.requires_grad_(True)
    loss, _ = model.loss(params, {n: torch.from_numpy(inp[n])
                                  for n in ("tokens", "targets")})
    loss.backward()
    return (logits.numpy(), cache, float(loss.detach()),
            [t.grad.numpy() for t in _leaves(params)])


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


def test_sharded_prefill_equals_the_unsharded_port_and_jax(case):
    jm, tree, inp, ranks = case
    logits, cache, _, _ = _unsharded(tree, inp)
    j_logits, j_cache, _ = j_lm_forward(
        jax.tree_util.tree_map(jnp.asarray, tree), jm.cfg,
        tokens=jnp.asarray(inp["tokens"]), mode="prefill",
        compute_dtype=jnp.float32, logits_mode="last")
    for port in ranks:
        assert port["n_sharded"] >= 7
        np.testing.assert_allclose(port["logits"], logits, rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(port["logits"], np.asarray(j_logits),
                                   rtol=1e-4, atol=1e-4)
        for n in ("k", "v"):
            np.testing.assert_allclose(port[f"cache_{n}"], cache[n].numpy(),
                                       rtol=1e-5, atol=1e-5)
            np.testing.assert_allclose(port[f"cache_{n}"],
                                       np.asarray(j_cache[n]), rtol=1e-4,
                                       atol=1e-4)


def test_sharded_loss_and_grads_equal_the_unsharded_port_and_jax(case):
    jm, tree, inp, ranks = case
    _, _, loss, grads = _unsharded(tree, inp)
    (j_loss, _), j_grads = jax.value_and_grad(jm.loss, has_aux=True)(
        jax.tree_util.tree_map(jnp.asarray, tree),
        {n: jnp.asarray(inp[n]) for n in ("tokens", "targets")})
    j_grads = jax.tree_util.tree_leaves(j_grads)
    for port in ranks:
        assert float(port["loss"]) == pytest.approx(loss, rel=1e-5)
        assert float(port["loss"]) == pytest.approx(float(j_loss), rel=1e-5)
        assert len(grads) == len(j_grads)
        for i, (g, jg) in enumerate(zip(grads, j_grads)):
            np.testing.assert_allclose(port[f"grad_{i}"], g, rtol=1e-5,
                                       atol=1e-5)
            assert _rel_l2(port[f"grad_{i}"], np.asarray(jg)) <= 1e-4, i


@pytest.mark.parametrize("placement", ["heads", "batch"])
def test_flash_op_runs_on_local_shards(case, placement):
    """The output keeps the inputs' placement, so the operator ran on the
    shards; values and gradients equal the unsharded op's."""
    from repro_torch.kernels.attention import ops as attn_ops
    _, _, inp, ranks = case
    q, k, v = (torch.from_numpy(inp[n]).requires_grad_(True)
               for n in ("q", "k", "v"))
    o = attn_ops.flash_attention(q, k, v, causal=True, impl="kernel")
    (o * torch.from_numpy(inp["w"])).sum().backward()
    for port in ranks:
        assert port[f"{placement}_placement"].all()
        np.testing.assert_allclose(port[f"{placement}_out"],
                                   o.detach().numpy(), rtol=1e-5, atol=1e-5)
        for n, t in zip("qkv", (q, k, v)):
            np.testing.assert_allclose(port[f"{placement}_d{n}"],
                                       t.grad.numpy(), rtol=1e-5, atol=1e-5)


# -- the SSD operators on the shards: mamba2 on the 2-rank world -----------

SSM_ARCH = "mamba2-2.7b"
SSD = (4, 2, 8, 8, 16, 16)       # B, c, Q, H, P, N
# the 2-rank meshes: (data 2, model 1) shards the batch, so the SSD runs
# batch-sharded (dA a pending partial sum); (data 1, model 2) shards the
# projections' inner dim (the SSD's inputs reach it replicated)
SSM_MESHES = {"data": (2, 1), "model": (1, 2)}

_PORT_SSM = textwrap.dedent("""
    import sys
    import numpy as np
    import torch
    import torch.distributed as dist
    import torch.multiprocessing as mp
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from repro_torch.configs import get_smoke_config
    from repro_torch.dist import api, sharding as sh
    from repro_torch.kernels.ssd import kernel as SK
    from repro_torch.kernels._dtensor import along_shards
    from repro_torch.kernels.ssd import ops as ssd_ops
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import build_model, params_from_numpy
    from repro_torch.train.optimizer import _leaves, _tree_map

    MESHES = MESHES_

    def nest(flat):
        tree = {}
        for key, a in flat.items():
            if key.startswith("p/"):
                node = tree
                *path, leaf = key[2:].split("/")
                for k in path:
                    node = node.setdefault(k, {})
                node[leaf] = a
        return tree

    def run(rank, path):
        torch.set_num_threads(1)
        dist.init_process_group("gloo", store=dist.FileStore(
            path + "/store", 2), rank=rank, world_size=2)
        cfg = get_smoke_config("ARCH")
        inp = dict(np.load(path + "/inputs.npz"))
        model = build_model(cfg, torch.float32)
        tree = params_from_numpy(cfg, nest(inp), device="cpu",
                                 compute_dtype=torch.float32,
                                 param_dtype=torch.float32)
        calls = {"fwd": 0, "bwd": 0}
        fwd, bwd = SK.ssd_chunk, SK.ssd_chunk_bwd

        def counted(name, fn):
            def wrapped(*a):
                calls[name] += 1
                return fn(*a)
            return wrapped
        SK.ssd_chunk = counted("fwd", fwd)
        SK.ssd_chunk_bwd = counted("bwd", bwd)
        out = {}
        for tag, shape in MESHES.items():
            mesh = make_local_mesh(*shape, device="cpu")
            specs = sh.param_specs_tree(model.param_axes(),
                                        model.abstract_params(), mesh,
                                        sh.param_rules())
            params = _tree_map(lambda t, s: distribute_tensor(
                t, mesh, sh.placements_for(s, mesh)), tree, specs)

            def batch(names, kind):
                rules = sh.act_rules(kind)
                return {n: distribute_tensor(
                    torch.from_numpy(inp[n]), mesh, sh.placements_for(
                        sh.spec_for(inp[n].shape, ("batch", "seq"), rules,
                                    mesh), mesh)) for n in names}

            ctx = api.ShardingContext(mesh, sh.act_rules("prefill"),
                                      sh.param_rules())
            calls.update(fwd=0, bwd=0)
            with api.use_sharding(ctx), torch.no_grad():
                logits, cache = model.prefill(params, batch(["tokens"],
                                                            "prefill"))
            out[f"{tag}_prefill_calls"] = np.asarray(calls["fwd"])
            out[f"{tag}_dtensor"] = np.asarray(
                type(logits).__name__ == "DTensor")
            out[f"{tag}_logits"] = logits.full_tensor().numpy()
            for n in ("conv", "ssm"):
                out[f"{tag}_cache_{n}"] = cache[n].full_tensor().numpy()

            for t in _leaves(params):
                t.requires_grad_(True)
            ctx = api.ShardingContext(mesh, sh.act_rules("train"),
                                      sh.param_rules())
            calls.update(fwd=0, bwd=0)
            with api.use_sharding(ctx):
                loss, _ = model.loss(params, batch(["tokens", "targets"],
                                                   "train"))
                loss.backward()
            out[f"{tag}_loss_calls"] = np.asarray([calls["fwd"],
                                                   calls["bwd"]])
            out[f"{tag}_loss"] = loss.detach().full_tensor().numpy()
            for i, t in enumerate(_leaves(params)):
                out[f"{tag}_grad_{i}"] = t.grad.full_tensor().numpy()

        # the operators alone, heads- and batch-sharded over "model"
        mesh = make_local_mesh(1, 2, device="cpu")
        names = ("x", "dt", "A", "Bm", "Cm")
        for name, dims in (("heads", {"x": 3, "dt": 3, "A": 0}),
                           ("batch", {"x": 0, "dt": 0, "Bm": 0, "Cm": 0})):
            ins = [distribute_tensor(torch.from_numpy(inp["ssd_" + n]), mesh,
                                     [Replicate(), Shard(dims[n]) if n in dims
                                      else Replicate()]) for n in names]
            with torch.no_grad():
                outs = ssd_ops.ssd_chunk_fwd(*ins)
            out[f"ssd_{name}_placements"] = np.asarray(
                [repr(o.placements[1]) for o in outs])
            for i, o in enumerate(outs):
                out[f"ssd_{name}_out_{i}"] = o.full_tensor().numpy()
            for t in ins:
                t.requires_grad_(True)
            outs = ssd_ops.SSDChunkFn.apply(*ins)
            ws = [distribute_tensor(torch.from_numpy(inp[f"ssd_w{i}"]), mesh,
                                    o.placements) for i, o in enumerate(outs)]
            sum((o * w).sum() for o, w in zip(outs, ws)).backward()
            out[f"ssd_{name}_grad_placements"] = np.asarray(
                [repr(t.grad.placements[1]) for t in ins])
            for n, t in zip(names, ins):
                out[f"ssd_{name}_d{n}"] = t.grad.full_tensor().numpy()

        # along_shards: a cumsum along a split dim, a pad along a whole one
        u = torch.from_numpy(inp["ssd_x"][:, 0, :, 0])          # (B, Q, P)
        d = distribute_tensor(u, mesh, [Replicate(), Shard(1)])
        got = along_shards(lambda t: torch.cumsum(t, 1), d, 1)
        out["along_cumsum"] = got.full_tensor().numpy()
        out["along_cumsum_placement"] = np.asarray(repr(got.placements[1]))
        d = distribute_tensor(u, mesh, [Replicate(), Shard(0)])
        got = along_shards(
            lambda t: torch.nn.functional.pad(t, (0, 0, 3, 0)), d, 1,
            (u.shape[0], u.shape[1] + 3, u.shape[2]))
        out["along_pad"] = got.full_tensor().numpy()
        out["along_pad_placement"] = np.asarray(repr(got.placements[1]))
        np.savez(path + f"/port_{rank}.npz", **out)
        dist.destroy_process_group()

    if __name__ == "__main__":
        mp.spawn(run, args=(sys.argv[1],), nprocs=2, join=True)
        print("PORT_OK")
""").replace("ARCH", SSM_ARCH).replace("MESHES_", repr(SSM_MESHES))


def _ssd_inputs(rng):
    B, c, Q, H, P, N = SSD
    f = np.float32
    return {"ssd_x": rng.standard_normal((B, c, Q, H, P)).astype(f),
            "ssd_dt": rng.uniform(0.01, 0.3, (B, c, Q, H)).astype(f),
            "ssd_A": -rng.uniform(0.5, 2.0, (H,)).astype(f),
            "ssd_Bm": rng.standard_normal((B, c, Q, N)).astype(f),
            "ssd_Cm": rng.standard_normal((B, c, Q, N)).astype(f),
            "ssd_w0": rng.standard_normal((B, c, Q, H, P)).astype(f),
            "ssd_w1": rng.standard_normal((B, c, H, P, N)).astype(f),
            "ssd_w2": rng.standard_normal((B, c, H)).astype(f)}


@pytest.fixture(scope="module")
def ssm_case(tmp_path_factory):
    """mamba2's smoke weights (the JAX package's, with the float32 mamba
    leaves moved off their 0/1 init so the decay and skip carry
    gradient), a batch, the SSD op's inputs, and the port's 2-rank
    results (rank 0, rank 1)."""
    path = tmp_path_factory.mktemp("sharded_ssm")
    jm = j_build_model(j_get_smoke(SSM_ARCH), compute_dtype=jnp.float32)
    tree = jax.tree_util.tree_map(np.asarray,
                                  jm.init_params(jax.random.PRNGKey(3)))
    rng = np.random.default_rng(7)
    for name in ("A_log", "dt_bias", "D_skip", "gnorm"):
        leaf = tree["blocks"][name]
        base = 1.0 if name == "D_skip" else 0.0
        tree["blocks"][name] = (base + 0.3 * rng.standard_normal(
            leaf.shape)).astype(np.float32)
    cfg = get_smoke_config(SSM_ARCH)
    toks = rng.integers(0, cfg.vocab_size, (B, S + 1)).astype(np.int32)
    inp = {**_flatten(tree), "tokens": toks[:, :-1], "targets": toks[:, 1:],
           **_ssd_inputs(rng)}
    np.savez(path / "inputs.npz", **inp)
    script = path / "port.py"
    script.write_text(_PORT_SSM)
    r = subprocess.run([sys.executable, str(script), str(path)],
                       capture_output=True, text=True, timeout=600,
                       env={**os.environ, "PYTHONPATH": str(SRC),
                            "OMP_NUM_THREADS": "1"})
    assert "PORT_OK" in r.stdout, r.stderr[-3000:]
    return jm, tree, inp, [dict(np.load(path / f"port_{i}.npz"))
                           for i in (0, 1)]


def _unsharded_ssm(tree, inp):
    cfg = get_smoke_config(SSM_ARCH)
    model = build_model(cfg, torch.float32)
    params = params_from_numpy(cfg, tree, device="cpu",
                               compute_dtype=torch.float32,
                               param_dtype=torch.float32)
    with torch.no_grad():
        logits, cache = model.prefill(
            params, {"tokens": torch.from_numpy(inp["tokens"])})
    for t in _leaves(params):
        t.requires_grad_(True)
    loss, _ = model.loss(params, {n: torch.from_numpy(inp[n])
                                  for n in ("tokens", "targets")})
    loss.backward()
    return (logits.numpy(), cache, float(loss.detach()),
            [t.grad.numpy() for t in _leaves(params)])


@pytest.mark.parametrize("mesh", list(SSM_MESHES))
def test_sharded_mamba2_prefill_equals_the_unsharded_port_and_jax(ssm_case,
                                                                  mesh):
    """The smoke mamba2 prefill on DTensor parameters through the SSD
    operator (once a layer, on the shards) against the unsharded port
    and the JAX ``lm_forward``, logits and both cache leaves."""
    jm, tree, inp, ranks = ssm_case
    logits, cache, _, _ = _unsharded_ssm(tree, inp)
    j_logits, j_cache, _ = j_lm_forward(
        jax.tree_util.tree_map(jnp.asarray, tree), jm.cfg,
        tokens=jnp.asarray(inp["tokens"]), mode="prefill",
        compute_dtype=jnp.float32, logits_mode="last")
    L = get_smoke_config(SSM_ARCH).n_layers
    for port in ranks:
        assert port[f"{mesh}_dtensor"]
        assert int(port[f"{mesh}_prefill_calls"]) == L
        np.testing.assert_allclose(port[f"{mesh}_logits"], logits,
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(port[f"{mesh}_logits"],
                                   np.asarray(j_logits), rtol=1e-4, atol=1e-4)
        for n in ("conv", "ssm"):
            np.testing.assert_allclose(port[f"{mesh}_cache_{n}"],
                                       cache[n].numpy(), rtol=1e-5, atol=1e-5)
            np.testing.assert_allclose(port[f"{mesh}_cache_{n}"],
                                       np.asarray(j_cache[n]), rtol=1e-4,
                                       atol=1e-4)


@pytest.mark.parametrize("mesh", list(SSM_MESHES))
def test_sharded_mamba2_loss_and_grads_equal_the_unsharded_port_and_jax(
        ssm_case, mesh):
    """The loss and every gradient leaf through ``SSDChunkFn`` on the
    shards (the forward and backward operators once a layer) against the
    unsharded port and ``jax.value_and_grad``: under the data mesh the
    SSD runs batch-sharded, so dA is a partial sum the ranks reduce; a
    strategy that called it replicated or sharded would miss here."""
    jm, tree, inp, ranks = ssm_case
    _, _, loss, grads = _unsharded_ssm(tree, inp)
    (j_loss, _), j_grads = jax.value_and_grad(jm.loss, has_aux=True)(
        jax.tree_util.tree_map(jnp.asarray, tree),
        {n: jnp.asarray(inp[n]) for n in ("tokens", "targets")})
    j_grads = jax.tree_util.tree_leaves(j_grads)
    L = get_smoke_config(SSM_ARCH).n_layers
    for port in ranks:
        assert port[f"{mesh}_loss_calls"].tolist() == [L, L]
        assert float(port[f"{mesh}_loss"]) == pytest.approx(loss, rel=1e-5)
        assert float(port[f"{mesh}_loss"]) == pytest.approx(float(j_loss),
                                                            rel=1e-5)
        assert len(grads) == len(j_grads)
        for i, (g, jg) in enumerate(zip(grads, j_grads)):
            np.testing.assert_allclose(port[f"{mesh}_grad_{i}"], g,
                                       rtol=1e-5, atol=1e-5)
            assert _rel_l2(port[f"{mesh}_grad_{i}"], np.asarray(jg)) <= 1e-4, i


@pytest.mark.parametrize("placement", ["heads", "batch"])
def test_ssd_op_runs_on_local_shards(ssm_case, placement):
    """The forward operator's outputs keep the inputs' placement (y on
    dim 3 and the state and decay on dim 2 under heads, dim 0 under
    batch), so it ran on the shards; values and gradients equal the
    unsharded op's, and the gradients summed over what the shards split
    come back as partial sums (dB, dC under heads; dA under batch)."""
    from repro_torch.kernels.ssd import ops as ssd_ops
    _, _, inp, ranks = ssm_case
    names = ("x", "dt", "A", "Bm", "Cm")
    ins = [torch.from_numpy(inp["ssd_" + n]).requires_grad_(True)
           for n in names]
    outs = ssd_ops.SSDChunkFn.apply(*ins)
    sum((o * torch.from_numpy(inp[f"ssd_w{i}"])).sum()
        for i, o in enumerate(outs)).backward()
    want = {"heads": (["Shard(dim=3)", "Shard(dim=2)", "Shard(dim=2)"],
                      ["Shard(dim=3)", "Shard(dim=3)", "Shard(dim=0)",
                       "Partial(sum)", "Partial(sum)"]),
            "batch": (["Shard(dim=0)"] * 3,
                      ["Shard(dim=0)", "Shard(dim=0)", "Partial(sum)",
                       "Shard(dim=0)", "Shard(dim=0)"])}[placement]
    for port in ranks:
        assert port[f"ssd_{placement}_placements"].tolist() == want[0]
        assert port[f"ssd_{placement}_grad_placements"].tolist() == want[1]
        for i, o in enumerate(outs):
            np.testing.assert_allclose(port[f"ssd_{placement}_out_{i}"],
                                       o.detach().numpy(), rtol=1e-5,
                                       atol=1e-5)
        for n, t in zip(names, ins):
            np.testing.assert_allclose(port[f"ssd_{placement}_d{n}"],
                                       t.grad.numpy(), rtol=1e-5, atol=1e-5)


def test_along_shards_runs_on_the_shards_with_the_worked_dim_whole(
        ssm_case):
    """``kernels._dtensor.along_shards``: a cumsum along a dim the
    placement splits gathers that dim first (the result replicated
    there), a zero-pad along a whole dim keeps the batch shards; both
    equal the plain op."""
    _, _, inp, ranks = ssm_case
    u = torch.from_numpy(inp["ssd_x"][:, 0, :, 0])
    for port in ranks:
        np.testing.assert_allclose(port["along_cumsum"],
                                   torch.cumsum(u, 1).numpy(), rtol=1e-6,
                                   atol=1e-6)
        assert str(port["along_cumsum_placement"]) == "Replicate()"
        np.testing.assert_array_equal(
            port["along_pad"],
            torch.nn.functional.pad(u, (0, 0, 3, 0)).numpy())
        assert str(port["along_pad_placement"]) == "Shard(dim=0)"


# -- the counter on a fake 8-rank world -------------------------------------

@contextlib.contextmanager
def fake_world(size, rank=0):
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def test_counter_sees_a_constrain_redistribution():
    """(batch on data, d_model on model) constrained to ("batch", "seq",
    "d_model") under the train rules: d_model is gathered over the 4
    model ranks, one all-gather of the local (4, 8, 24) float32 shard."""
    with fake_world(8, rank=3):
        mesh = t_mesh.make_local_mesh(2, 4, device="cpu")
        d = distribute_tensor(torch.zeros(8, 8, 96), mesh,
                              [Shard(0), Shard(2)], src_data_rank=None)
        ctx = t_api.ShardingContext(mesh, t_sh.act_rules("train"),
                                    t_sh.param_rules())
        with t_api.use_sharding(ctx):
            out, st, _ = count_collectives(
                t_api.constrain, d, ("batch", "seq", "d_model"))
        assert out.placements == (Shard(0), Replicate())
        assert st.count_by_op == {"all-gather": 1}
        assert st.bytes_by_op == {"all-gather": 4 * 8 * 24 * 4}


def _prefill_collectives(act_rules):
    """A smoke prefill's collectives over a (data 2, model 2) mesh, and
    those that its ``constrain`` calls made, each call counted by a
    counter of its own inside the step's."""
    cfg = get_smoke_config(ARCH)
    model = build_model(cfg, torch.float32, kernel_impl="plain")
    mesh = t_mesh.make_local_mesh(2, 2, device="cpu")
    ap = model.abstract_params()
    specs = t_sh.param_specs_tree(model.param_axes(), ap, mesh,
                                  t_sh.param_rules())
    params = _tree_map(lambda a, s: distribute_tensor(
        torch.zeros(a.shape), mesh, t_sh.placements_for(s, mesh),
        src_data_rank=None), ap, specs)
    tokens = distribute_tensor(torch.zeros((B, S), dtype=torch.int32),
                               mesh, [Shard(0), Replicate()],
                               src_data_rank=None)
    ctx = t_api.ShardingContext(mesh, act_rules, t_sh.param_rules())
    calls, sites = [], {}
    real = t_api.constrain

    def recording(x, axes):
        calls.append(axes)
        out, st, _ = count_collectives(real, x, axes)
        for op, b in st.bytes_by_op.items():
            sites[op] = sites.get(op, 0.0) + b
        return out
    with pytest.MonkeyPatch.context() as mp_:
        for mod in ("transformer", "attention", "moe", "whisper"):
            mp_.setattr(f"repro_torch.models.{mod}.constrain", recording)
        with t_api.use_sharding(ctx), torch.no_grad():
            _, st, _ = count_collectives(model.prefill, params,
                                         {"tokens": tokens})
    return st, sites, calls


def test_counter_sees_the_model_constrain_sites():
    """A prefill under the baseline rules and under the opt rules
    (sequence parallelism: "seq" on model): the step's counter sees
    every byte that the constrain calls' own counters see.  Under the
    baseline rules the sites reduce the row-parallel products' partial
    sums to replicated values (all-reduces); under the opt rules they
    reduce them to sequence shards instead (reduce-scatters, no
    all-reduce), as sequence parallelism does.  The sites are the
    reference's (the embedded input, h and x in each layer, the logits)
    and the port's residual after the attention."""
    with fake_world(4):
        base, base_sites, calls = _prefill_collectives(
            t_sh.act_rules("prefill"))
        opt, opt_sites, _ = _prefill_collectives(
            t_sh.act_rules_opt("prefill"))
    L = get_smoke_config(ARCH).n_layers
    assert calls == ([("batch", "seq", "d_model")] * (1 + 3 * L)
                     + [("batch", "seq", "vocab")])
    for total, sites in ((base, base_sites), (opt, opt_sites)):
        for op, b in sites.items():
            assert total.bytes_by_op[op] >= b > 0, op
    assert base_sites.get("all-reduce", 0) > 0
    assert opt_sites.get("reduce-scatter", 0) > 0
    assert "all-reduce" not in opt_sites

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
* The SSD in a second 2-process world: the mamba2 smoke model
  (float32, the JAX package's weights) runs a prefill and one loss with
  its gradients on a (data 2, model 1) mesh, where the SSD runs
  batch-sharded and dA comes back as a partial sum, and on (data 1,
  model 2), against the unsharded port and JAX at the same tolerances;
  two full train steps with each optimizer on each mesh, on the state
  ``make_train_state_specs`` places, against the unsharded port and the
  JAX package's train step; ``models.ssm.ssd_chunked`` alone on
  heads- and batch-sharded DTensors keeps the inputs' split, returns
  the partial sums as partial (dB and dC under heads, dA under batch)
  and equals the unsharded op at 1e-5.
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
# the train steps on those meshes: each optimizer, two steps (the second
# reads the moments the first wrote, the int8 ones through their row
# scales), at test_torch_train.py's lr
OPTS = ("adamw", "adamw8bit")
LR = 1e-2
OPT_KW = dict(lr_peak=LR, warmup_steps=5, total_steps=100)
STEPS = 2

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
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import build_model, params_from_numpy, ssm
    from repro_torch.train import (OptConfig, TrainConfig, init_opt_state,
                                   make_train_state_specs, make_train_step)
    from repro_torch.train.optimizer import _leaves, _tree_map

    MESHES = MESHES_
    OPTS = OPTS_

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

    def _ssd_weights(inp):
        # the cotangent weights of ssd_chunked's y (B,S,H,P) and final
        # state (B,H,P,N)
        Bsz, c, Q, H, P = inp["ssd_w0"].shape
        return [inp["ssd_w0"].reshape(Bsz, c * Q, H, P), inp["ssd_w1"][:, 0]]

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

            # full train steps from the JAX package's weights on the
            # state ``make_train_state_specs`` places
            for opt in OPTS:
                tcfg = TrainConfig(opt=OptConfig(**OPT_KW, name=opt),
                                   remat_policy=None, microbatches=1)
                _, pl = make_train_state_specs(model, tcfg, ctx)
                p0 = params_from_numpy(cfg, nest(inp), device="cpu",
                                       compute_dtype=torch.float32,
                                       param_dtype=torch.float32)
                plain = {"params": p0, "opt": init_opt_state(opt, p0)}
                state = _tree_map(lambda t, q: distribute_tensor(t, mesh, q),
                                  plain, {k: pl[k] for k in plain})
                state["step"] = distribute_tensor(
                    torch.zeros((), dtype=torch.int32), mesh, pl["step"])
                out[f"{tag}_{opt}_last_split"] = np.asarray(sum(
                    any(q.is_shard(t.ndim - 1) for q in t.placements)
                    for t in _leaves(state["params"]) if t.ndim))
                train_step = make_train_step(model, tcfg)
                mets = []
                with api.use_sharding(ctx):
                    for _ in range(STEPS):
                        state, m = train_step(state, batch(
                            ["tokens", "targets"], "train"))
                        mets.append([float(m[k].full_tensor())
                                     for k in ("loss", "grad_norm")])
                out[f"{tag}_{opt}_metrics"] = np.asarray(mets)
                for part in ("params", "opt"):
                    for i, t in enumerate(_leaves(state[part])):
                        out[f"{tag}_{opt}_{part}_{i}"] = (
                            t.full_tensor().numpy())

        # the SSD on DTensors alone, heads- and batch-sharded over "model"
        mesh = make_local_mesh(1, 2, device="cpu")
        names = ("x", "dt", "A", "Bm", "Cm")
        full = {n: inp["ssd_" + n] for n in names}
        Bsz, c, Q = full["x"].shape[:3]
        for n in ("x", "dt", "Bm", "Cm"):
            full[n] = full[n].reshape(Bsz, c * Q, *full[n].shape[3:])
        for name, dims in (("heads", {"x": 2, "dt": 2, "A": 0}),
                           ("batch", {"x": 0, "dt": 0, "Bm": 0, "Cm": 0})):
            ins = [distribute_tensor(torch.from_numpy(full[n]), mesh,
                                     [Replicate(), Shard(dims[n]) if n in dims
                                      else Replicate()]) for n in names]
            with torch.no_grad():
                outs = ssm.ssd_chunked(*ins, Q)
            out[f"ssd_{name}_placements"] = np.asarray(
                [repr(o.placements[1]) for o in outs])
            for i, o in enumerate(outs):
                out[f"ssd_{name}_out_{i}"] = o.full_tensor().numpy()
            for t in ins:
                t.requires_grad_(True)
            calls.update(fwd=0, bwd=0)
            outs = ssm.ssd_chunked(*ins, Q)
            ws = [distribute_tensor(torch.from_numpy(w), mesh, o.placements)
                  for w, o in zip(_ssd_weights(inp), outs)]
            sum((o * w).sum() for o, w in zip(outs, ws)).backward()
            out[f"ssd_{name}_calls"] = np.asarray([calls["fwd"],
                                                   calls["bwd"]])
            out[f"ssd_{name}_grad_placements"] = np.asarray(
                [repr(t.grad.placements[1]) for t in ins])
            for n, t in zip(names, ins):
                out[f"ssd_{name}_d{n}"] = t.grad.full_tensor().numpy()

        # on_shards along a dim: a cumsum along a split dim (taken whole),
        # a pad along a whole one (the batch shards kept)
        u = torch.from_numpy(inp["ssd_x"][:, 0, :, 0])          # (B, Q, P)
        d = distribute_tensor(u, mesh, [Replicate(), Shard(1)])
        got = api.on_shards(lambda t: torch.cumsum(t, 1), d,
                            ins=([Replicate(), Replicate()],))
        out["along_cumsum"] = got.full_tensor().numpy()
        out["along_cumsum_placement"] = np.asarray(repr(got.placements[1]))
        d = distribute_tensor(u, mesh, [Replicate(), Shard(0)])
        got = api.on_shards(
            lambda t: torch.nn.functional.pad(t, (0, 0, 3, 0)), d,
            shape=(u.shape[0], u.shape[1] + 3, u.shape[2]))
        out["along_pad"] = got.full_tensor().numpy()
        out["along_pad_placement"] = np.asarray(repr(got.placements[1]))
        out["along_pad_shape"] = np.asarray(tuple(got.shape))
        np.savez(path + f"/port_{rank}.npz", **out)
        dist.destroy_process_group()

    if __name__ == "__main__":
        mp.spawn(run, args=(sys.argv[1],), nprocs=2, join=True)
        print("PORT_OK")
""").replace("ARCH", SSM_ARCH).replace("MESHES_", repr(SSM_MESHES)).replace(
    "OPTS_", repr(OPTS)).replace("OPT_KW", repr(OPT_KW)).replace(
    "STEPS", repr(STEPS))


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


def _ssd_plain(inp):
    """The SSD's inputs as ``models.ssm.ssd_chunked`` takes them (x, dt,
    B, C with the chunks joined into the sequence), its cotangent
    weights, and the chunk."""
    Bsz, c, Q, H, P = inp["ssd_x"].shape
    ins = {n: inp["ssd_" + n] for n in ("x", "dt", "A", "Bm", "Cm")}
    for n in ("x", "dt", "Bm", "Cm"):
        ins[n] = ins[n].reshape(Bsz, c * Q, *ins[n].shape[3:])
    return (ins, [inp["ssd_w0"].reshape(Bsz, c * Q, H, P),
                  inp["ssd_w1"][:, 0]], Q)


@pytest.mark.parametrize("placement", ["heads", "batch"])
def test_ssd_op_runs_on_local_shards(ssm_case, placement):
    """``models.ssm.ssd_chunked`` on DTensor inputs: y and the final
    state keep the inputs' split (y on dim 2 and the state on dim 1
    under heads, dim 0 under batch), so the op ran on the shards, its
    forward and backward operators once each under grad; values and
    gradients equal the unsharded op's, and the gradients summed over
    what the shards split come back as partial sums (dB, dC under
    heads; dA under batch)."""
    from repro_torch.models import ssm
    _, _, inp, ranks = ssm_case
    names = ("x", "dt", "A", "Bm", "Cm")
    full, wts, Q = _ssd_plain(inp)
    ins = [torch.from_numpy(full[n]).requires_grad_(True) for n in names]
    outs = ssm.ssd_chunked(*ins, Q)
    sum((o * torch.from_numpy(w)).sum() for o, w in zip(outs, wts)
        ).backward()
    want = {"heads": (["Shard(dim=2)", "Shard(dim=1)"],
                      ["Shard(dim=2)", "Shard(dim=2)", "Shard(dim=0)",
                       "Partial(sum)", "Partial(sum)"]),
            "batch": (["Shard(dim=0)"] * 2,
                      ["Shard(dim=0)", "Shard(dim=0)", "Partial(sum)",
                       "Shard(dim=0)", "Shard(dim=0)"])}[placement]
    for port in ranks:
        assert port[f"ssd_{placement}_placements"].tolist() == want[0]
        assert port[f"ssd_{placement}_grad_placements"].tolist() == want[1]
        assert port[f"ssd_{placement}_calls"].tolist() == [1, 1]
        for i, o in enumerate(outs):
            np.testing.assert_allclose(port[f"ssd_{placement}_out_{i}"],
                                       o.detach().numpy(), rtol=1e-5,
                                       atol=1e-5)
        for n, t in zip(names, ins):
            np.testing.assert_allclose(port[f"ssd_{placement}_d{n}"],
                                       t.grad.numpy(), rtol=1e-5, atol=1e-5)


def test_along_shards_runs_on_the_shards_with_the_worked_dim_whole(
        ssm_case):
    """``dist.api.on_shards`` with a function along one dim, as
    ``models.ssm._pad_seq`` calls it: a cumsum along a dim the placement
    splits, taken whole first (the result replicated there), a zero-pad
    along a whole dim keeps the batch shards and takes the given global
    shape; both equal the plain op."""
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
        assert port["along_pad_shape"].tolist() == [u.shape[0],
                                                    u.shape[1] + 3,
                                                    u.shape[2]]


def _steps_unsharded_and_jax(jm, tree, inp, opt):
    """``STEPS`` train steps of the unsharded port and of the JAX
    package's ``make_train_step`` on the case's batch: (port state,
    JAX state, [(loss, grad_norm)] a step for each)."""
    from repro.train import OptConfig as JOptConfig
    from repro.train import TrainConfig as JTrainConfig
    from repro.train import init_opt_state as j_init_opt_state
    from repro.train import make_train_step as j_make_train_step
    from repro_torch.train import (OptConfig, TrainConfig, init_opt_state,
                                   make_train_step)
    cfg = get_smoke_config(SSM_ARCH)
    params = params_from_numpy(cfg, tree, device="cpu",
                               compute_dtype=torch.float32,
                               param_dtype=torch.float32)
    state = {"params": params, "opt": init_opt_state(opt, params),
             "step": torch.zeros((), dtype=torch.int32)}
    step = make_train_step(build_model(cfg, torch.float32),
                           TrainConfig(opt=OptConfig(**OPT_KW, name=opt),
                                       remat_policy=None, microbatches=1))
    jp = jax.tree_util.tree_map(jnp.asarray, tree)
    jstate = {"params": jp, "opt": j_init_opt_state(opt, jp),
              "step": jnp.zeros((), jnp.int32)}
    jstep = jax.jit(j_make_train_step(
        jm, JTrainConfig(opt=JOptConfig(**OPT_KW, name=opt),
                         remat_policy=None, microbatches=1)))
    batch = {n: inp[n] for n in ("tokens", "targets")}
    mets, jmets = [], []
    for _ in range(STEPS):
        state, m = step(state, {k: torch.from_numpy(v)
                                for k, v in batch.items()})
        jstate, jm_ = jstep(jstate, {k: jnp.asarray(v)
                                     for k, v in batch.items()})
        mets.append([float(m[k]) for k in ("loss", "grad_norm")])
        jmets.append([float(jm_[k]) for k in ("loss", "grad_norm")])
    return state, jstate, np.asarray(mets), np.asarray(jmets)


@pytest.mark.parametrize("opt", OPTS)
@pytest.mark.parametrize("mesh", list(SSM_MESHES))
def test_sharded_train_steps_equal_the_unsharded_port_and_jax(ssm_case,
                                                              mesh, opt):
    """Two ``make_train_step`` steps on the state that
    ``make_train_state_specs`` places (each rank updates its local
    shards; AdamW8bit's per-row scales take their maximum over the mesh
    dims that split a parameter's last dim, which some parameters are on
    each mesh: d_model over data, ssm_inner over model) against the
    unsharded port and the JAX package's step from the same weights and
    batch: the loss and grad norm a step (1e-5 relative against the
    port, 1e-4 against JAX), the parameters within 1e-2 * lr everywhere
    against the port and at ``test_torch_train.py``'s tolerances against
    JAX, the float moments and scales within 1e-5 (port) and 1e-3 (JAX)
    relative L2, the int8 moments within one quantisation step."""
    jm, tree, inp, ranks = ssm_case
    state, jstate, mets, jmets = _steps_unsharded_and_jax(jm, tree, inp, opt)
    for port in ranks:
        assert int(port[f"{mesh}_{opt}_last_split"]) > 0
        np.testing.assert_allclose(port[f"{mesh}_{opt}_metrics"], mets,
                                   rtol=1e-5)
        np.testing.assert_allclose(port[f"{mesh}_{opt}_metrics"], jmets,
                                   rtol=1e-4)
        for i, (a, b) in enumerate(zip(_leaves(state["params"]),
                                       jax.tree_util.tree_leaves(
                                           jstate["params"]))):
            got = port[f"{mesh}_{opt}_params_{i}"]
            assert float(np.abs(got - a.numpy()).max()) <= 1e-2 * LR, i
            d = np.abs(got - np.asarray(b))
            assert float((d > 1e-2 * LR).mean()) <= 1e-2, i
            assert float(d.max()) <= 3e-2 * LR, i
        for i, (a, b) in enumerate(zip(_leaves(state["opt"]),
                                       jax.tree_util.tree_leaves(
                                           jstate["opt"]))):
            got, b = port[f"{mesh}_{opt}_opt_{i}"], np.asarray(b)
            assert got.dtype == b.dtype == a.numpy().dtype, i
            if b.dtype == np.int8:
                for want in (a.numpy(), b):
                    assert int(np.abs(got.astype(int) - want).max()) <= 1, i
            else:
                assert _rel_l2(got, a.numpy()) <= 1e-5, i
                assert _rel_l2(got, b) <= 1e-3, i


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

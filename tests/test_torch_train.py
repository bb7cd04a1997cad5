"""The port's training path against the JAX package, on the CPU.

The JAX package initialises the smoke internlm2 weights; the same
numpy arrays go into the port as float32 master weights
(``params_from_numpy(..., param_dtype=torch.float32)``), and the same
numpy batches into both.  Compute is float32 and the attention is the
flash op's plain version (CPU tensors) with its plain backward.

Tolerances: the loss to 1e-5 relative and every gradient leaf to 1e-4
relative L2 (the same operations, XLA's and PyTorch's summation
orders); the rematerialisation policies to 1e-6 (the same arithmetic
rerun); after three optimizer steps the parameters within 1e-2 * lr_peak
and the int8 moments within one quantisation step (an update divides by
sqrt(v), so rounding differences in tiny second moments move a
parameter by up to a small part of lr).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as j_get_smoke
from repro.models import build_model as j_build_model
from repro.train import OptConfig as JOptConfig
from repro.train import TrainConfig as JTrainConfig
from repro.train import clip_by_global_norm as j_clip
from repro.train import init_opt_state as j_init_opt_state
from repro.train import lr_schedule as j_lr_schedule
from repro.train import make_train_step as j_make_train_step
from repro.train import pick_optimizer as j_pick_optimizer
from repro_torch.configs import get_smoke_config
from repro_torch.data import DataPipeline, SyntheticLMSource
from repro_torch.models import build_model, params_from_numpy
from repro_torch.models import transformer as TM
from repro_torch.models.transformer import _maybe_remat
from repro_torch.train import (OptConfig, TrainConfig, clip_by_global_norm,
                               init_opt_state, lr_schedule, make_train_step,
                               pick_optimizer)
from repro_torch.train.optimizer import _leaves
from repro_torch.train.trainer import Trainer, TrainerConfig

torch.set_num_threads(1)

ARCH = "internlm2-1.8b"
LR = 1e-2


@pytest.fixture(scope="module")
def ref():
    """(port config, JAX model, JAX params as numpy, port model)."""
    jcfg = j_get_smoke(ARCH)
    jm = j_build_model(jcfg, compute_dtype=jnp.float32)
    tree = jax.tree_util.tree_map(
        np.asarray, jm.init_params(jax.random.PRNGKey(0)))
    return (get_smoke_config(ARCH), jm, tree,
            build_model(get_smoke_config(ARCH), torch.float32))


def _params(cfg, tree):
    return params_from_numpy(cfg, tree, device="cpu",
                             compute_dtype=torch.float32,
                             param_dtype=torch.float32)


def _batch(cfg, seed, B=4, S=16):
    toks = np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, S + 1)).astype(np.int32)
    return {"tokens": toks[:, :-1], "targets": toks[:, 1:]}


def _t(batch):
    return {k: torch.as_tensor(v) for k, v in batch.items()}


def _j(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _loss_and_grads(model, params, batch, remat_policy=None):
    leaves = _leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    loss, mets = model.loss(params, _t(batch), remat_policy=remat_policy)
    grads = torch.autograd.grad(loss, leaves)
    return (float(loss.detach()),
            {k: float(v.detach()) for k, v in mets.items()}, grads)


@pytest.fixture(scope="module")
def jax_loss(ref):
    cfg, jm, tree, _ = ref
    batch = _batch(cfg, 1)
    (loss, mets), grads = jax.jit(jax.value_and_grad(
        jm.loss, has_aux=True))(tree, _j(batch))
    return batch, float(loss), float(mets["ce"]), [
        np.asarray(g) for g in jax.tree_util.tree_leaves(grads)]


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


def test_lm_loss_and_grads_match_jax(ref, jax_loss):
    cfg, _, tree, tm = ref
    batch, j_loss, j_ce, j_grads = jax_loss
    loss, mets, grads = _loss_and_grads(tm, _params(cfg, tree), batch)
    assert loss == pytest.approx(j_loss, rel=1e-5)
    assert mets["ce"] == pytest.approx(j_ce, rel=1e-5)
    assert mets["aux"] == 0.0
    assert len(grads) == len(j_grads)
    for g, jg in zip(grads, j_grads):
        assert g.shape == jg.shape
        assert _rel_l2(g.numpy(), jg) <= 1e-4


@pytest.mark.parametrize("policy", ["full", "dots", "dots_no_batch"])
def test_remat_policies_give_the_same_loss_and_grads(ref, jax_loss, policy):
    cfg, _, tree, tm = ref
    batch = jax_loss[0]
    loss0, _, g0 = _loss_and_grads(tm, _params(cfg, tree), batch)
    loss, _, g = _loss_and_grads(tm, _params(cfg, tree), batch, policy)
    assert loss == pytest.approx(loss0, rel=1e-6)
    for a, b in zip(g, g0):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6,
                                   atol=1e-6)


def test_remat_policies_recompute_as_named(ref):
    """"full" reruns the flash forward in the backward; the "dots"
    policies keep its outputs; an unknown policy raises."""
    cfg, _, tree, tm = ref
    from repro_torch.kernels.attention import kernel as K
    calls = []
    orig = K.flash_attention

    def counted(*a, **kw):
        calls.append(1)
        return orig(*a, **kw)
    batch = _batch(cfg, 2, B=2, S=8)
    K.flash_attention = counted
    try:
        for policy, want in ((None, 1), ("full", 2), ("dots", 1),
                             ("dots_no_batch", 1)):
            calls.clear()
            _loss_and_grads(tm, _params(cfg, tree), batch, policy)
            assert len(calls) == want * cfg.n_layers, policy
    finally:
        K.flash_attention = orig
    with pytest.raises(ValueError):
        _maybe_remat(lambda x: x, "everything")


@pytest.mark.parametrize("arch", [ARCH, "gemma2-2b"])
def test_chunked_cross_entropy_matches_jax(arch, monkeypatch):
    """Past ``LOSS_CHUNK_LOGITS`` ``lm_loss`` sums the cross entropy over
    row chunks, each rematerialised in the backward: here chunks of 5 of
    the 64 rows (the last ragged), gemma2 with its tied embedding and
    the final logits' softcap.  The loss and every leaf's gradient
    against ``jax.value_and_grad`` at the tolerances above, and against
    the whole logits to 1e-6 (the same arithmetic a row, summed in
    another order)."""
    cfg, jm, tree, tm = _smoke_ref(arch)
    batch = _batch(cfg, 5)
    (j_loss, _), j_grads = jax.value_and_grad(jm.loss, has_aux=True)(
        tree, _j(batch))
    whole, _, g_whole = _loss_and_grads(tm, _params(cfg, tree), batch)
    monkeypatch.setattr(TM, "LOSS_CHUNK_LOGITS", 4 * 5 * cfg.vocab_size)
    calls, ce_sum = [], TM._ce_sum
    monkeypatch.setattr(TM, "_ce_sum", lambda x, *a: calls.append(
        x.shape[0]) or ce_sum(x, *a))
    loss, _, grads = _loss_and_grads(tm, _params(cfg, tree), batch)
    assert calls[:13] == [5] * 12 + [4]
    assert loss == pytest.approx(float(j_loss), rel=1e-5)
    assert loss == pytest.approx(whole, rel=1e-6)
    j_leaves = jax.tree_util.tree_leaves(j_grads)
    assert len(grads) == len(j_leaves)
    for g, w, jg in zip(grads, g_whole, j_leaves):
        assert _rel_l2(g.numpy(), jg) <= 1e-4
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-6,
                                   atol=1e-6)


def test_kernel_and_plain_impls_give_the_same_grads_on_cpu(ref, jax_loss):
    """On the CPU ``kernel_impl="kernel"`` differentiates through
    ``FlashAttentionFn`` (plain backward), "plain" through autograd."""
    cfg, _, tree, tm = ref
    batch = jax_loss[0]
    _, _, g0 = _loss_and_grads(tm, _params(cfg, tree), batch)
    plain = build_model(cfg, torch.float32, kernel_impl="plain")
    _, _, g = _loss_and_grads(plain, _params(cfg, tree), batch)
    for a, b in zip(g, g0):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5,
                                   atol=1e-6)


def _tcfg_pair(opt, microbatches=1):
    kw = dict(name=opt, lr_peak=LR, warmup_steps=5, total_steps=100)
    return (TrainConfig(opt=OptConfig(**kw), remat_policy=None,
                        microbatches=microbatches),
            JTrainConfig(opt=JOptConfig(**kw), remat_policy=None,
                         microbatches=microbatches))


def _run_both(ref, opt, microbatches, steps, B=4):
    cfg, jm, tree, tm = ref
    tcfg, jtcfg = _tcfg_pair(opt, microbatches)
    jstep = jax.jit(j_make_train_step(jm, jtcfg))
    jp = jax.tree_util.tree_map(jnp.asarray, tree)
    jstate = {"params": jp, "opt": j_init_opt_state(opt, jp),
              "step": jnp.zeros((), jnp.int32)}
    params = _params(cfg, tree)
    state = {"params": params, "opt": init_opt_state(opt, params),
             "step": torch.zeros((), dtype=torch.int32)}
    step = make_train_step(tm, tcfg)
    for i in range(steps):
        batch = _batch(cfg, 10 + i, B=B)
        jstate, jm_ = jstep(jstate, _j(batch))
        state, m = step(state, _t(batch))
        for k in ("loss", "grad_norm", "lr", "ce", "aux"):
            assert float(m[k]) == pytest.approx(float(jm_[k]), rel=1e-4,
                                                abs=1e-7), (i, k)
    return state, jstate


def _close_params(state, jstate, everywhere=True):
    """Parameters after full steps: within 1e-2 * lr_peak on all but 1%
    of each leaf, within 3e-2 * lr_peak everywhere (unless
    ``everywhere`` is False).  Adam moves an
    element by about lr * g / (|g| + eps); where the gradient element is
    at the rounding floor of its matmul (|g| ~ 1e-10, a relative
    difference of order one between the frameworks' summation orders)
    that move differs by up to 2e-2 * lr (one element of w_up in 16 384
    at seed 0, one of 128 in a norm leaf with adamw8bit)."""
    for a, b in zip(_leaves(state["params"]),
                    jax.tree_util.tree_leaves(jstate["params"])):
        d = np.abs(a.numpy() - np.asarray(b))
        assert float((d > 1e-2 * LR).mean()) <= 1e-2
        if everywhere:
            assert float(d.max()) <= 3e-2 * LR


def _close_moments(state, jstate):
    for a, b in zip(_leaves(state["opt"]),
                    jax.tree_util.tree_leaves(jstate["opt"])):
        b = np.asarray(b)
        assert a.dtype == {np.dtype(np.int8): torch.int8,
                           np.dtype(np.float32): torch.float32}[b.dtype]
        if b.dtype == np.int8:        # within one quantisation step
            assert int(np.abs(a.numpy().astype(int) - b).max()) <= 1
        else:
            assert _rel_l2(a.numpy(), b) <= 1e-3


def _smoke_ref(arch):
    """``ref`` for another architecture's smoke config: the JAX package's
    weights from PRNGKey(0), both models in float32."""
    jcfg = j_get_smoke(arch)
    jm = j_build_model(jcfg, compute_dtype=jnp.float32)
    tree = jax.tree_util.tree_map(
        np.asarray, jm.init_params(jax.random.PRNGKey(0)))
    return (get_smoke_config(arch), jm, tree,
            build_model(get_smoke_config(arch), torch.float32))


# (arch, optimizer): the dense model with both optimizers (ids as they
# were), the hybrid (the flash op at the shared block and the SSD op,
# each through its autograd Function) and gemma2 (the softcap and the
# window through the flash op's backward) with AdamW
TRAIN_STEP_CASES = [(ARCH, "adamw"), (ARCH, "adamw8bit"),
                    ("zamba2-7b", "adamw"), ("gemma2-2b", "adamw")]


@pytest.mark.parametrize(
    "arch,opt", TRAIN_STEP_CASES,
    ids=[o if a == ARCH else f"{a}-{o}" for a, o in TRAIN_STEP_CASES])
def test_three_train_steps_match_jax(ref, arch, opt):
    """Three full train steps in both packages from the same weights and
    batches: the step metrics (each step, in ``_run_both``), the
    parameters and the moments (the tolerances of ``_close_params`` and
    ``_close_moments``).  The hybrid holds its parameters on all but 1%
    of each leaf, not on every element, and its moments after one step:
    its gradients agree to ~1e-5 (1e-6 for the dense model), and where
    an element's gradient sits near zero Adam's normalised step, ~lr,
    takes another sign (one element 5e-2 lr apart after one step; after
    three, one embedding element of 32 768, whose gradient is 8.5e-8 in
    JAX's first moment and 2.3e-7 in the port's, 0.74 lr apart), which
    moves the third step's gradients, and so every moment, by ~5e-4
    (1.2e-3 at most, conv_C's second moment)."""
    r = ref if arch == ARCH else _smoke_ref(arch)
    state, jstate = _run_both(r, opt, 1, 3)
    assert int(state["step"]) == int(jstate["step"]) == 3
    hybrid = arch == "zamba2-7b"
    _close_params(state, jstate, everywhere=not hybrid)
    if hybrid:
        state, jstate = _run_both(r, opt, 1, 1)
    _close_moments(state, jstate)


@pytest.mark.parametrize("opt", ["adamw", "adamw8bit"])
def test_three_optimizer_updates_match_jax(ref, opt):
    """``opt_update`` alone, three steps on the same gradients in both
    packages: the parameters within 1e-2 * lr_peak everywhere, the int8
    moments within one quantisation step."""
    from repro.train import opt_update as j_opt_update
    from repro_torch.train import opt_update
    cfg, _, tree, _ = ref
    kw = dict(name=opt, lr_peak=LR, warmup_steps=2, total_steps=10)
    rng = np.random.default_rng(7)
    grads = jax.tree_util.tree_map(
        lambda a: (rng.standard_normal(a.shape) * 1e-2).astype(np.float32),
        tree)
    jp = jax.tree_util.tree_map(jnp.asarray, tree)
    jg = jax.tree_util.tree_map(jnp.asarray, grads)
    jo = j_init_opt_state(opt, jp)
    params = _params(cfg, tree)
    tg = _params(cfg, grads)
    to = init_opt_state(opt, params)
    for i in range(3):
        jp, jo = j_opt_update(opt, JOptConfig(**kw), jp, jg, jo,
                              jnp.asarray(i, jnp.int32))
        params, to = opt_update(opt, OptConfig(**kw), params, tg, to,
                                torch.tensor(i, dtype=torch.int32))
    for a, b in zip(_leaves(params), jax.tree_util.tree_leaves(jp)):
        assert float(np.abs(a.numpy() - np.asarray(b)).max()) <= 1e-2 * LR
    _close_moments({"opt": to}, {"opt": jo})


def test_microbatches_match_jax(ref):
    state, jstate = _run_both(ref, "adamw", 2, 2, B=8)
    _close_params(state, jstate)


def test_clip_by_global_norm_matches_jax():
    rng = np.random.default_rng(3)
    tree = {"b": {"y": rng.standard_normal((3, 4)).astype(np.float32)},
            "a": rng.standard_normal((5,)).astype(np.float32) * 10}
    for max_norm in (1.0, 100.0):
        got, gn = clip_by_global_norm(
            {"b": {"y": torch.as_tensor(tree["b"]["y"])},
             "a": torch.as_tensor(tree["a"])}, max_norm)
        want, jgn = j_clip(jax.tree_util.tree_map(jnp.asarray, tree),
                           max_norm)
        assert float(gn) == pytest.approx(float(jgn), rel=1e-6)
        np.testing.assert_allclose(got["a"].numpy(), np.asarray(want["a"]),
                                   rtol=1e-6)
        np.testing.assert_allclose(got["b"]["y"].numpy(),
                                   np.asarray(want["b"]["y"]), rtol=1e-6)


def test_lr_schedule_matches_jax():
    cfg = dict(lr_peak=3e-4, lr_min=3e-5, warmup_steps=50, total_steps=300)
    jc, tc = JOptConfig(**cfg), OptConfig(**cfg)
    steps = np.arange(0, 301, dtype=np.int32)
    want = np.asarray(jax.vmap(lambda s: j_lr_schedule(jc, s))(
        jnp.asarray(steps)))
    got = lr_schedule(tc, torch.as_tensor(steps)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    assert float(lr_schedule(tc, 7)) == pytest.approx(
        float(j_lr_schedule(jc, 7)), rel=1e-6)


def test_pick_optimizer_matches_jax():
    for n in (1e6, 1.9e9, 100e9, 100e9 + 1, 314e9):
        assert pick_optimizer(n) == j_pick_optimizer(n)


def test_loss_decreases(ref):
    """The twin of the JAX package's test: 30 steps on one batch."""
    cfg, _, tree, tm = ref
    tcfg, _ = _tcfg_pair("adamw")
    params = _params(cfg, tree)
    state = {"params": params, "opt": init_opt_state("adamw", params),
             "step": torch.zeros((), dtype=torch.int32)}
    step = make_train_step(tm, tcfg)
    batch = _t(_batch(cfg, 1))
    losses = []
    for _ in range(30):
        state, metrics = step(state, batch)
        losses.append(float(metrics["loss"]))
    assert losses[-1] < losses[0] * 0.8
    assert int(state["step"]) == 30


def test_trainer_defaults_to_the_card(ref):
    """No ``device``: the card, and without one it raises rather than
    carry on on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default resolves to it")
    with pytest.raises(RuntimeError, match="CUDA"):
        Trainer(ref[3], TrainerConfig())


def test_trainer_fits_from_the_data_pipeline(ref, tmp_path):
    """``Trainer.fit`` on ``DataPipeline`` batches, with microbatches and
    checkpoints: the history and the FT monitor get the step stream, a
    fresh trainer resumes from the last checkpoint with equal state."""
    cfg, _, _, tm = ref
    tcfg = TrainerConfig(train=dataclasses.replace(
        _tcfg_pair("adamw", microbatches=2)[0]), ckpt_dir=str(tmp_path),
        ckpt_every=2, log_every=2)
    tr = Trainer(tm, tcfg, seed=0, device="cpu")
    pipe = DataPipeline(SyntheticLMSource(cfg.vocab_size, doc_len=64),
                        seq_len=16, batch_size=4, queue_capacity=8,
                        max_batches=12, device="cpu").start()
    try:
        hist = tr.fit(iter(pipe), steps=6)
    finally:
        pipe.stop()
    assert [h["step"] for h in hist] == [2, 4, 6]
    assert all(np.isfinite([h["loss"], h["grad_norm"]]).all() for h in hist)
    assert "host0" in tr.ft.rates.monitors
    assert tr.ckpt.steps() == [2, 4, 6]
    fresh = Trainer(tm, tcfg, seed=1, device="cpu")
    assert fresh.maybe_restore() == 6
    for a, b in zip(_leaves(fresh.state), _leaves(tr.state)):
        assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.fixture(scope="module")
def ssm_ref():
    """mamba2's smoke config: (port config, numpy params, batch, JAX loss,
    JAX gradient leaves), with the float32 mamba leaves moved off their
    0/1 init so the SSD's decay and skip carry gradient."""
    arch = "mamba2-2.7b"
    jm = j_build_model(j_get_smoke(arch), compute_dtype=jnp.float32)
    tree = jax.tree_util.tree_map(
        np.asarray, jm.init_params(jax.random.PRNGKey(3)))
    rng = np.random.default_rng(4)
    for name in ("A_log", "dt_bias", "D_skip", "gnorm"):
        leaf = tree["blocks"][name]
        base = 1.0 if name == "D_skip" else 0.0
        tree["blocks"][name] = (base + 0.3 * rng.standard_normal(
            leaf.shape)).astype(np.float32)
    cfg = get_smoke_config(arch)
    batch = _batch(cfg, 5, B=2, S=24)
    (loss, _), grads = jax.value_and_grad(jm.loss, has_aux=True)(
        jax.tree_util.tree_map(jnp.asarray, tree), _j(batch))
    return cfg, tree, batch, float(loss), [
        np.asarray(g) for g in jax.tree_util.tree_leaves(grads)]


class _CountedBwd:
    """``kernels.ssd.kernel.ssd_chunk_bwd`` with a count of its calls."""

    def __init__(self, fn):
        self.fn, self.calls = fn, 0

    def __call__(self, *a, **k):
        self.calls += 1
        return self.fn(*a, **k)


@pytest.mark.parametrize("policy,kernel_impl", [
    (None, "kernel"), ("full", "kernel"), (None, "plain"), ("full", "plain")],
    ids=["None", "full", "None-plain", "full-plain"])
def test_ssm_lm_loss_and_grads_match_jax(ssm_ref, monkeypatch, policy,
                                         kernel_impl):
    """mamba2's loss and every gradient leaf against
    ``jax.value_and_grad`` of the JAX model (1e-5 / 1e-4, as the dense
    model), with and without rematerialisation, on both SSD routes: the
    kernel route differentiates through ``SSDChunkFn`` (on CPU tensors
    its plain forward and ``ssd_chunk_bwd_ref``, its backward called once
    a layer), the plain route through autograd of the plain version."""
    from repro_torch.kernels.ssd import kernel as SK
    cfg, tree, batch, j_loss, j_grads = ssm_ref
    counted = _CountedBwd(SK.ssd_chunk_bwd)
    monkeypatch.setattr(SK, "ssd_chunk_bwd", counted)
    loss, _, grads = _loss_and_grads(
        build_model(cfg, torch.float32, kernel_impl=kernel_impl),
        _params(cfg, tree), batch, policy)
    assert counted.calls == (cfg.n_layers if kernel_impl == "kernel" else 0)
    assert loss == pytest.approx(j_loss, rel=1e-5)
    for g, jg in zip(grads, j_grads):
        assert g.shape == jg.shape
        assert _rel_l2(g.numpy(), jg) <= 1e-4


def test_three_ssm_train_steps_match_jax(ssm_ref):
    """mamba2's smoke model, three full AdamW steps in both packages (the
    port's SSD through ``SSDChunkFn``), from the fixture's weights: the
    step metrics, the parameters and the moments as for the dense
    model.  (AdamW8bit moves one embedding element of 32 768 by 2.7 x lr
    apart from JAX's on either SSD route, an int8 moment at its rounding
    floor, so it is not compared here.)"""
    cfg, tree, _, _, _ = ssm_ref
    jm = j_build_model(j_get_smoke("mamba2-2.7b"), compute_dtype=jnp.float32)
    state, jstate = _run_both((cfg, jm, tree, build_model(cfg, torch.float32)),
                              "adamw", 1, 3, B=2)
    assert int(state["step"]) == int(jstate["step"]) == 3
    _close_params(state, jstate)
    _close_moments(state, jstate)

"""The port's checkpoint manager: the JAX package's four checkpoint
tests (``tests/test_ckpt_ft.py``) as twins, and checkpoints read across
the packages both ways, bit for bit.

Both packages write ``step_N/leaf_i.npy`` with a manifest of per-leaf
shapes, dtypes and crc32s, leaves numbered in ``jax.tree_util``'s order
for nested dicts (sorted keys), so a train state written by either
restores in the other.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.ckpt import CheckpointManager as JCheckpointManager
from repro.train import init_opt_state as j_init_opt_state
from repro_torch.ckpt import CheckpointManager
from repro_torch.train import init_opt_state

torch.set_num_threads(1)


def _state(step=0):
    return {"params": {"w": torch.arange(12, dtype=torch.float32)
                       .reshape(3, 4),
                       "b": torch.ones((4,), dtype=torch.float32) * step},
            "step": torch.tensor(step, dtype=torch.int32)}


def test_ckpt_roundtrip(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    s = _state(7)
    mgr.save(7, s, blocking=True)
    restored, step = mgr.restore(_state())
    assert step == 7
    torch.testing.assert_close(restored["params"]["w"], s["params"]["w"])
    torch.testing.assert_close(restored["params"]["b"], s["params"]["b"])
    assert restored["step"].dtype == torch.int32 and int(
        restored["step"]) == 7


def test_ckpt_auto_resume_latest_and_gc(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    for step in (1, 2, 3, 4):
        mgr.save(step, _state(step), blocking=True)
    assert mgr.steps() == [3, 4]          # gc keeps last 2
    _, step = mgr.restore(_state())
    assert step == 4


def test_ckpt_corruption_detected(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, _state(1), blocking=True)
    leaf = next((tmp_path / "step_1").glob("leaf_0.npy"))
    arr = np.load(leaf)
    arr_corrupt = arr.copy()
    arr_corrupt.flat[0] += 1
    np.save(leaf, arr_corrupt)
    with pytest.raises(IOError, match="corrupt"):
        mgr.restore(_state())


def test_ckpt_crash_mid_write_is_invisible(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(5, _state(5), blocking=True)
    # simulate a crashed partial write: tmp dir left behind
    (tmp_path / ".tmp_step_6").mkdir()
    (tmp_path / ".tmp_step_6" / "leaf_0.npy").write_bytes(b"garbage")
    assert mgr.latest_step() == 5          # tmp dirs never count
    _, step = mgr.restore(_state())
    assert step == 5


def test_nonblocking_save_snapshots_before_in_place_updates(tmp_path):
    """A non-blocking save writes the state as it was at the call, even
    when every leaf is then updated in place before the writer runs (the
    train step updates its state in place).  The writer is held back on
    the manager's lock until the updates are done, so the order is
    forced, not raced."""
    mgr = CheckpointManager(str(tmp_path))
    state = {"w": torch.randn(64, 32), "h": torch.randn(8).to(torch.bfloat16),
             "n": np.arange(6, dtype=np.float32),
             "step": torch.tensor(3, dtype=torch.int32)}
    before = {k: (v.clone() if isinstance(v, torch.Tensor) else v.copy())
              for k, v in state.items()}
    with mgr._lock:
        mgr.save(3, state)
        state["w"].add_(1)
        state["h"].add_(1)
        state["n"] += 1
        state["step"].add_(1)
    mgr.wait()
    got, step = mgr.restore({k: (v.clone() if isinstance(v, torch.Tensor)
                                 else v.copy())
                             for k, v in before.items()})
    assert step == 3
    for k, v in before.items():
        if isinstance(v, torch.Tensor):
            assert got[k].dtype == v.dtype and torch.equal(got[k], v), k
        else:
            np.testing.assert_array_equal(got[k], v)


def test_restore_follows_the_like_state_device_and_dtype(tmp_path):
    """Tensors come back on the like state's device and in its dtype
    (bf16 goes through float32 on disk, exactly); a non-tensor like leaf
    gives the numpy array as written; a wrong structure raises; no
    checkpoint gives (None, None)."""
    mgr = CheckpointManager(str(tmp_path))
    assert mgr.restore(_state()) == (None, None)
    x = torch.randn(5, 3).to(torch.bfloat16)
    mgr.save(3, {"a": x, "n": np.arange(3)}, blocking=True)
    meta = (tmp_path / "step_3" / "manifest.json").read_text()
    assert '"dtype": "float32"' in meta
    got, _ = mgr.restore({"a": torch.zeros(5, 3, dtype=torch.bfloat16),
                          "n": np.zeros(3)})
    assert got["a"].dtype == torch.bfloat16 and torch.equal(got["a"], x)
    assert isinstance(got["n"], np.ndarray)
    np.testing.assert_array_equal(got["n"], np.arange(3))
    with pytest.raises(ValueError):
        mgr.restore({"a": torch.zeros(5, 3)})
    with pytest.raises(ValueError):
        mgr.restore({"a": torch.zeros(3, 5), "n": np.zeros(3)})


def _train_state(seed, opt):
    """A train state as numpy arrays: nested params, the optimizer's
    moments (random, so the cross-read is not of zeros) and the step."""
    rng = np.random.default_rng(seed)
    params = {"blocks": {"attn": {"wq": rng.standard_normal((2, 8, 2, 4))},
                         "ln1": {"w": rng.standard_normal((2, 8))}},
              "embed": rng.standard_normal((16, 8)),
              "final_norm": {"w": rng.standard_normal(8)}}
    params = jax.tree_util.tree_map(lambda a: a.astype(np.float32), params)
    opt_state = jax.tree_util.tree_map(
        lambda a: (rng.integers(-127, 128, a.shape).astype(a.dtype)
                   if a.dtype == np.int8 else
                   rng.standard_normal(a.shape).astype(np.float32)),
        jax.tree_util.tree_map(np.asarray, j_init_opt_state(
            opt, jax.tree_util.tree_map(jnp.asarray, params))))
    return {"params": params, "opt": opt_state,
            "step": np.asarray(9, np.int32)}


def _as_torch(tree):
    return jax.tree_util.tree_map(torch.as_tensor, tree)


def _zeros_like_torch(tree):
    return jax.tree_util.tree_map(lambda a: torch.zeros(
        a.shape, dtype=torch.as_tensor(a).dtype), tree)


@pytest.mark.parametrize("opt", ["adamw", "adamw8bit"])
def test_jax_checkpoint_restores_in_the_port(tmp_path, opt):
    state = _train_state(1, opt)
    JCheckpointManager(str(tmp_path)).save(
        9, jax.tree_util.tree_map(jnp.asarray, state), blocking=True)
    like = _zeros_like_torch(state)
    assert init_opt_state(opt, _as_torch(state["params"])).keys() == \
        like["opt"].keys()
    got, step = CheckpointManager(str(tmp_path)).restore(like)
    assert step == 9
    for a, b in zip(jax.tree_util.tree_leaves(_as_torch(got)),
                    jax.tree_util.tree_leaves(_as_torch(state))):
        assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.parametrize("opt", ["adamw", "adamw8bit"])
def test_port_checkpoint_restores_in_jax(tmp_path, opt):
    state = _train_state(2, opt)
    CheckpointManager(str(tmp_path)).save(9, _as_torch(state),
                                          blocking=True)
    like = jax.tree_util.tree_map(lambda a: jnp.zeros(a.shape, a.dtype),
                                  state)
    got, step = JCheckpointManager(str(tmp_path)).restore(like)
    assert step == 9
    for a, b in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(state)):
        assert np.asarray(a).dtype == b.dtype
        np.testing.assert_array_equal(np.asarray(a), b)


def test_jax_bf16_leaf_restores_from_its_raw_bytes(tmp_path):
    """The JAX package writes a bfloat16 leaf as ml_dtypes' 2-byte type,
    which numpy loads as raw bytes: the port reads the bits back."""
    x = jnp.asarray(np.random.default_rng(3).standard_normal((4, 6)),
                    jnp.bfloat16)
    JCheckpointManager(str(tmp_path)).save(1, {"x": x}, blocking=True)
    got, _ = CheckpointManager(str(tmp_path)).restore(
        {"x": torch.zeros(4, 6, dtype=torch.bfloat16)})
    want = torch.as_tensor(np.asarray(x, np.float32)).to(torch.bfloat16)
    assert torch.equal(got["x"], want)

"""The port's checkpoint manager (`repro_torch.checkpoint`) and run guard
(`repro_torch.launch.fault_tolerance`) on the CPU: the reference's
checkpoint cases of `tests/test_substrate.py` run on the port's manager,
a checkpoint of a reduced {"params", "opt"} tree written by either package
restores byte-equal in the other, and `RunGuard` resumes from the newest
complete step after an injected failure."""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint import CheckpointManager as JCheckpointManager  # noqa: E402
from repro.configs import get_config  # noqa: E402
from repro.models import init_params as j_init_params  # noqa: E402
from repro.optim import init_state as j_init_state  # noqa: E402
from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.core.tree import tree_items, tree_map  # noqa: E402
from repro_torch.launch.fault_tolerance import FailureInjector, RunGuard  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402


# ------------------------------------------- the reference's cases, on the port
def test_checkpoint_roundtrip(tmp_path):
    mgr = CheckpointManager(str(tmp_path), async_save=False)
    tree = {"p": {"w": torch.arange(6.0).reshape(2, 3)}, "s": torch.tensor(3, dtype=torch.int32)}
    mgr.save(10, tree, blocking=True)
    restored, step = mgr.restore(tree_map(torch.zeros_like, tree))
    assert step == 10
    assert torch.equal(restored["p"]["w"], tree["p"]["w"])
    assert restored["s"].dtype == torch.int32 and int(restored["s"]) == 3


def test_checkpoint_async_and_gc(tmp_path):
    mgr = CheckpointManager(str(tmp_path), max_to_keep=2)
    tree = {"w": torch.ones((64, 64))}
    for s in (1, 2, 3, 4):
        mgr.save(s, tree_map(lambda x: x * s, tree))
    mgr.wait()
    assert mgr.complete_steps() == [3, 4]
    restored, step = mgr.restore(tree_map(torch.zeros_like, tree))
    assert step == 4
    assert float(restored["w"][0, 0]) == 4.0


def test_checkpoint_save_snapshots_before_returning(tmp_path):
    """An async save copies the tensors to host memory at once: an in-place
    update after `save` returns (the train step updates its masters in
    place) does not reach the file."""
    mgr = CheckpointManager(str(tmp_path))
    w = torch.ones((256, 256))
    mgr.save(1, {"w": w})
    w.mul_(5.0)
    mgr.wait()
    restored, _ = mgr.restore({"w": torch.zeros_like(w)})
    assert float(restored["w"].max()) == 1.0


def test_checkpoint_crash_consistency(tmp_path):
    """A step dir without MANIFEST (simulated mid-save crash) is ignored."""
    mgr = CheckpointManager(str(tmp_path), async_save=False)
    tree = {"w": torch.ones((4,))}
    mgr.save(1, tree, blocking=True)
    d = os.path.join(str(tmp_path), "step_00000002")
    os.makedirs(d)
    np.savez(os.path.join(d, "shard_0.npz"), w=np.zeros(4))
    assert mgr.latest_step() == 1
    _, step = mgr.restore(tree_map(torch.zeros_like, tree))
    assert step == 1


def test_checkpoint_shape_mismatch_raises(tmp_path):
    mgr = CheckpointManager(str(tmp_path), async_save=False)
    mgr.save(1, {"w": torch.ones((4,))}, blocking=True)
    with pytest.raises(ValueError, match="shape mismatch"):
        mgr.restore({"w": torch.zeros((5,))})


def test_checkpoint_restore_of_an_empty_directory(tmp_path):
    assert CheckpointManager(str(tmp_path)).restore({"w": torch.zeros(2)}) == (None, None)


# ------------------------------------------------------------ across packages
def _train_tree(arch="qwen2-7b", seed=0):
    """A reduced {"params", "opt"} tree as the reference's driver saves it,
    with nonzero moments and step, as numpy."""
    cfg = get_config(arch).reduced()
    params = j_init_params(jax.random.PRNGKey(seed), cfg)
    opt = j_init_state(params)
    opt = {"m": jax.tree.map(lambda x: x + 0.25, opt["m"]),
           "v": jax.tree.map(lambda x: x + 0.5, opt["v"]), "step": jnp.int32(7)}
    return jax.tree.map(np.asarray, {"params": params, "opt": opt})


def _assert_bytes_equal(tree_t, tree_np):
    flat_np = jax.tree_util.tree_flatten_with_path(tree_np)[0]
    items = tree_items(tree_t)
    assert [tuple(str(k.key) for k in p) for p, _ in flat_np] == [p for p, _ in items]
    for (_, a), (_, t) in zip(flat_np, items):
        assert t.numpy().dtype == np.asarray(a).dtype
        assert t.numpy().tobytes() == np.asarray(a).tobytes()


@pytest.mark.parametrize("arch", ["qwen2-7b", "recurrentgemma-9b"])
def test_reference_checkpoint_restores_in_the_port(tmp_path, arch):
    """The JAX manager writes a reduced training tree; the port's manager
    restores it into a tree of tensors byte for byte, keys in the same
    order (a hybrid's tail too)."""
    tree = _train_tree(arch)
    JCheckpointManager(str(tmp_path), async_save=False).save(7, tree, blocking=True)
    like = tree_map(torch.zeros_like, params_from_numpy(tree))
    restored, step = CheckpointManager(str(tmp_path)).restore(like)
    assert step == 7
    _assert_bytes_equal(restored, tree)


@pytest.mark.parametrize("arch", ["qwen2-7b", "recurrentgemma-9b"])
def test_port_checkpoint_restores_in_the_reference(tmp_path, arch):
    """The port's manager writes the tree from tensors (async, then waited);
    the JAX manager restores it byte for byte."""
    tree = _train_tree(arch, seed=1)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(9, params_from_numpy(tree))
    mgr.wait()
    restored, step = JCheckpointManager(str(tmp_path), async_save=False).restore(
        jax.tree.map(np.zeros_like, tree))
    assert step == 9
    for a, b in zip(jax.tree.leaves(restored), jax.tree.leaves(tree)):
        assert np.asarray(a).dtype == b.dtype and np.asarray(a).tobytes() == b.tobytes()


# ------------------------------------------------------------------ run guard
def test_run_guard_resumes_from_the_newest_complete_step(tmp_path, monkeypatch):
    """A loop of the driver's shape: a checkpoint every 3 steps, a failure
    injected at step 7 (one after the save at 6) -> the guard restores step
    6's state and the loop ends at its last step with the state it would
    have had without the failure."""
    monkeypatch.setenv("REPRO_INJECT_FAIL_AT", "7")
    mgr = CheckpointManager(str(tmp_path))
    state = {"x": torch.zeros(3)}
    injector = FailureInjector()

    def restore_fn():
        mgr.wait()
        restored, step = mgr.restore(state)
        state["x"] = restored["x"]
        return step

    guard = RunGuard(restore_fn)
    ran, step = [], 0
    while step < 10:
        def one(step=step):
            injector.maybe_fail(step)
            state["x"] = state["x"] + step
            ran.append(step)
        nxt = guard.run(step, one)
        if nxt > step and (step + 1) % 3 == 0:
            mgr.save(step + 1, state)
        step = nxt
    mgr.wait()
    assert guard.restarts == 1
    assert ran == [0, 1, 2, 3, 4, 5, 6, 6, 7, 8, 9]
    assert torch.equal(state["x"], torch.full((3,), float(sum(range(10)))))
    assert mgr.latest_step() == 9

"""The port's checkpoints (``repro_torch.checkpoint.manager``) against the
JAX package's, on the CPU: the substrate tests of
``tests/test_substrate.py::TestCheckpoint`` on the port, the flattened keys
equal to the reference's ``_flatten``, checkpoints written by either
package restored by the other bit for bit, and a training run resumed from
a checkpoint equal to the uninterrupted run, bit for bit on the CPU.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import manager as jckpt
from repro.configs import registry as jregistry
from repro.models.model import Model as JModel
from repro.train import optimizer as jopt
from repro_torch.checkpoint import manager as ckpt
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs import registry
from repro_torch.data.pipeline import DataConfig, make_iterator
from repro_torch.models import params as pm
from repro_torch.models.model import Model
from repro_torch.train import optimizer as opt_lib
from repro_torch.train import step as step_lib


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Small ops: with several test processes sharing the cores, torch runs
    these on one thread (no op here is large enough for its result to
    depend on the count)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tree(k=0):
    return {"a": torch.arange(12.0).reshape(3, 4) + k,
            "b": {"c": torch.ones((5,)) * k, "d": torch.zeros((2, 2))}}


def _equal(a, b):
    la, lb = pm.tree_leaves(a), pm.tree_leaves(b)
    return len(la) == len(lb) and all(
        torch.equal(torch.as_tensor(np.asarray(x)), torch.as_tensor(
            np.asarray(y))) for x, y in zip(la, lb))


# --- tests/test_substrate.py::TestCheckpoint on the port -------------------------

def test_roundtrip(tmp_path):
    mgr = CheckpointManager(str(tmp_path), async_save=False)
    tree = _tree(3)
    mgr.save(7, tree, metadata={"arch": "x"})
    restored, step = mgr.restore(_tree(0))
    assert step == 7 and _equal(tree, restored)


def test_async_save_and_fence(tmp_path):
    mgr = CheckpointManager(str(tmp_path), async_save=True)
    mgr.save(1, _tree(1))
    mgr.wait()
    assert mgr.latest_step() == 1


def test_keep_last_prunes(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep_last=2, async_save=False)
    for s in range(5):
        mgr.save(s, _tree(s))
    assert mgr.all_steps() == [3, 4]


def test_corruption_detected(tmp_path):
    mgr = CheckpointManager(str(tmp_path), async_save=False)
    mgr.save(1, _tree(1))
    npz = os.path.join(str(tmp_path), "step_00000001", "arrays.npz")
    with open(npz, "r+b") as f:
        f.seek(30)
        f.write(b"\x00\x01\x02")
    with pytest.raises(IOError, match="corrupt"):
        mgr.restore(_tree(0))


def test_restore_specific_step(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep_last=5, async_save=False)
    for s in (2, 4, 6):
        mgr.save(s, _tree(s))
    restored, step = mgr.restore(_tree(0), step=4)
    assert step == 4 and float(restored["a"][0, 0]) == 4.0


def test_no_checkpoint_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        CheckpointManager(str(tmp_path)).restore(_tree(0))


# --- the port's own rules ------------------------------------------------------------

def test_bfloat16_leaf_raises(tmp_path):
    mgr = CheckpointManager(str(tmp_path), async_save=False)
    with pytest.raises(TypeError, match="bfloat16"):
        mgr.save(1, {"w": torch.ones(3, dtype=torch.bfloat16)})
    assert mgr.all_steps() == []


def test_save_snapshots_before_returning(tmp_path):
    """The host copy is taken at ``save``: writing the tensors while the
    async write runs does not reach the checkpoint."""
    mgr = CheckpointManager(str(tmp_path), async_save=True)
    tree = _tree(2)
    want = pm.tree_map(torch.clone, tree)
    mgr.save(1, tree)
    tree["a"].add_(100.0)
    mgr.wait()
    restored, _ = mgr.restore(_tree(0))
    assert _equal(restored, want)


# --- across the two packages ---------------------------------------------------------

@pytest.fixture(scope="module", params=["llama3.2-1b", "zamba2-1.2b"])
def states(request):
    """The reference's {params, AdamW state} for a reduced model (zamba2's
    hybrid stack has an empty ``tail``) and the same tree in torch."""
    jcfg = jregistry.get(request.param).reduced()
    jm = JModel(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    jo = jopt.Optimizer(jopt.OptConfig())
    js = jo.init(jp)
    g = jax.tree_util.tree_map(lambda p: jnp.full(p.shape, 0.01, p.dtype),
                               jp)
    jp, js, _ = jo.update(jp, g, js, 0)  # nonzero moments
    jtree = {"params": jp, "opt": js}
    host = jax.device_get(jtree)
    ttree = pm.tree_map(lambda a: torch.from_numpy(np.array(a)),
                        {"params": host["params"], "opt": host["opt"]})
    return jtree, ttree


def test_flattened_keys_are_the_references(states):
    jtree, ttree = states
    want = jckpt._flatten(jtree)
    got = ckpt._flatten(ttree)
    assert list(got) == list(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])


def test_reference_checkpoint_restores_in_the_port(states, tmp_path):
    jtree, ttree = states
    jckpt.CheckpointManager(str(tmp_path), async_save=False).save(
        3, jtree, metadata={"arch": "ref"})
    like = pm.tree_map(torch.zeros_like, ttree)
    restored, step = CheckpointManager(str(tmp_path)).restore(like)
    assert step == 3 and _equal(restored, ttree)


def test_port_checkpoint_restores_in_the_reference(states, tmp_path):
    jtree, ttree = states
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(5, ttree, metadata={"arch": "port"})
    mgr.wait()
    like = jax.tree_util.tree_map(jnp.zeros_like, jtree)
    restored, step = jckpt.CheckpointManager(str(tmp_path)).restore(like)
    assert step == 5
    jax.tree_util.tree_map(
        lambda a, b: np.testing.assert_array_equal(np.asarray(a),
                                                   np.asarray(b)),
        restored, jtree)


# --- resume ----------------------------------------------------------------------------

def test_resume_equals_the_uninterrupted_run(tmp_path):
    """Four steps of reduced llama (float32 masters, AdamW, 2 microbatches)
    against two steps, an async save, a restore into a fresh model and
    optimizer and two more steps: restored tensors equal the saved ones and
    the losses after the restore equal the uninterrupted run's, bit for
    bit."""
    cfg = registry.get("llama3.2-1b").reduced().replace(dtype="float32",
                                                        remat="full")
    dc = DataConfig(vocab_size=cfg.vocab_size, seq_len=16, global_batch=4)

    def fresh():
        model = Model(cfg, device="cpu").init(0)
        opt = opt_lib.make_optimizer(cfg, lr=3e-3, warmup_steps=2)
        return model, opt, step_lib.make_train_step(model, opt, n_accum=2)

    model, opt, train = fresh()
    params, state = model.weights(), opt.init(model.weights())
    it = make_iterator(cfg, dc, device="cpu")
    losses, saved = [], None
    mgr = CheckpointManager(str(tmp_path))
    for i in range(4):
        params, state, m = train(params, state, next(it), i)
        losses.append(float(m["loss"]))
        if i == 1:
            mgr.save(2, {"params": params, "opt": state})
            saved = pm.tree_map(torch.clone, {"params": params,
                                              "opt": state})
    mgr.wait()

    model2, opt2, train2 = fresh()
    like = {"params": model2.weights(), "opt": opt2.init(model2.weights())}
    restored, step = mgr.restore(like)
    assert step == 2 and _equal(restored, saved)
    params2, state2 = restored["params"], restored["opt"]
    model2.set_weights(params2)
    it2 = make_iterator(cfg, dc, start_step=step, device="cpu")
    for i in range(step, 4):
        params2, state2, m = train2(params2, state2, next(it2), i)
        assert float(m["loss"]) == losses[i]
    assert _equal(params2, params)

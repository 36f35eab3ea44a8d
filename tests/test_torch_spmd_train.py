"""The port's train step across ranks (``train/step.py``'s sharded step,
``sharding/spmd.py``) and ``launch/train --model-parallel`` against the
port's one-process step and the reference's sharded step.

One subprocess spawns a 4-rank gloo world on the CPU (a ``FileStore`` under
``tmp_path``: no TCP port) over a ``{data 2, model 2}`` ``DeviceMesh`` and
takes one AdamW step of the reference test's reduced llama3.2-1b (4/2
heads of 16, d_model 64, d_ff 128; ``tests/test_sharding_plan.py``'s
mini-mesh cfg) in float32, B 8, S 32, ``n_accum`` 2, with ``hoist_gather``
off and on, from the reference's initial weights; each rank gathers every
gradient, updated parameter and first moment (``spmd.full_tensor``), and
then the CLI takes 2 steps at ``--model-parallel 2`` in the same world.
Beside it a second subprocess runs the reference's step on a hand-built
``Mesh`` of 4 forced CPU devices (``jax.sharding.Mesh``, whose axes are
Auto: ``jax.make_mesh`` gives Explicit ones in this JAX, on which the
reference's ``with_sharding_constraint`` raises, ROADMAP queue 3), once
with an optimizer that hands the averaged gradients back as the new
parameters and once with AdamW. The loss, every gradient, parameter and
moment equal the port's one-process step and the reference's within 1e-5
of each leaf's largest magnitude. In the same world the other dense
configs (qwen3-1.7b, nemotron-4-15b, deepseek-67b, reduced) take the
sharded step's gradients, held against the port's one-process step.
"""
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from repro.configs import registry as jregistry
from repro.models.model import Model as JModel
from repro.sharding import plan as jplan
from repro_torch.configs import registry
from repro_torch.launch import train as launch
from repro_torch.models import params as pm
from repro_torch.models.model import Model
from repro_torch.train.optimizer import make_optimizer
from repro_torch.train.step import make_train_step

KW = dict(num_heads=4, num_kv_heads=2, head_dim=16, d_model=64, d_ff=128,
          dtype="float32")
B, S, N_ACCUM = 8, 32, 2
# the other dense configs (qk-norm, relu2 with layernorm, Adafactor's
# deepseek-67b), reduced, float32
DENSE = ("qwen3-1.7b", "nemotron-4-15b", "deepseek-67b")
HOIST = (False, True)
TOL = 1e-5

COMMON = r"""
import sys
import numpy as np


def unflatten(arrays, prefix):
    tree = {}
    for key in arrays.files:
        if not key.startswith(prefix + "/"):
            continue
        node = tree
        *path, leaf = key[len(prefix) + 1:].split("/")
        for k in path:
            node = node.setdefault(k, {})
        node[leaf] = arrays[key]
    return tree


def flatten(tree, prefix, out):
    if isinstance(tree, dict):
        for k in sorted(tree):
            flatten(tree[k], prefix + "/" + k, out)
    else:
        out[prefix] = np.asarray(tree)
    return out


def first_moments(state):
    if "m" in state and not isinstance(state["m"], dict):
        return state["m"]
    return {k: first_moments(v) for k, v in state.items()}


KW = dict(num_heads=4, num_kv_heads=2, head_dim=16, d_model=64, d_ff=128,
          dtype="float32")
N_ACCUM = 2
DENSE = ("qwen3-1.7b", "nemotron-4-15b", "deepseek-67b")
"""

WORLD = COMMON + r"""
import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def work(rank, world, store, out):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    from repro_torch.configs import registry
    from repro_torch.launch import train as launch
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import params as pm
    from repro_torch.models.model import Model
    from repro_torch.sharding import spmd
    from repro_torch.sharding.plan import make_plan
    from repro_torch.train.optimizer import make_optimizer
    from repro_torch.train.step import make_train_step
    arrays = np.load(out + ".in.npz")
    mesh = make_host_mesh(model=2, device="cpu")
    cfg = registry.get("llama3.2-1b").reduced().replace(**KW)
    plan = make_plan(cfg, mesh)
    model = Model(cfg, plan=plan, device="cpu")
    opt = make_optimizer(cfg)
    meta = model.param_meta()
    full = pm.tree_map(torch.from_numpy, unflatten(arrays, "params"))
    batch = {k: torch.from_numpy(arrays[k]) for k in ("tokens", "labels")}
    res = {}
    for hoist in (False, True):
        it = iter(pm.tree_leaves(plan.param_shardings(meta)))
        params = pm.tree_map(lambda t: spmd.place(t, next(it)), full)
        it = iter(pm.tree_leaves(plan.param_shardings(opt.state_meta(meta))))
        state = pm.tree_map(lambda t: spmd.place(t, next(it)),
                            opt.init(full))
        step = make_train_step(model, opt, n_accum=N_ACCUM,
                               hoist_gather=hoist)
        loss, metrics, grads = step.grads(params, batch)
        place_ok = all(g.placements == p.placements for g, p in zip(
            pm.tree_leaves(grads), pm.tree_leaves(params)))
        params, state, m = step.update(params, state, loss, metrics, grads,
                                       0)
        gather = lambda tree: pm.tree_map(
            lambda x: spmd.full_tensor(x).numpy(), tree)
        h = int(hoist)
        res[f"loss{h}"] = float(m["loss"])
        res[f"place_ok{h}"] = place_ok
        flatten(gather(grads), f"grads{h}", res)
        flatten(gather(params), f"params{h}", res)
        flatten(gather(first_moments(state)), f"m{h}", res)
    # the other dense configs, gradients only, from Model.init's weights
    from repro_torch.launch.train import init_sharded
    for arch in DENSE:
        cfg = registry.get(arch).reduced().replace(dtype="float32")
        opt = make_optimizer(cfg)
        model = Model(cfg, plan=make_plan(cfg, mesh), device="cpu")
        params, _ = init_sharded(model, opt, 0)
        loss, _, grads = make_train_step(model, opt, n_accum=N_ACCUM).grads(
            params, batch)
        res[f"{arch}/loss"] = float(loss)
        flatten(pm.tree_map(lambda x: spmd.full_tensor(x).numpy(), grads),
                f"{arch}/grads", res)
    res["cli"] = launch.main(["--device", "cpu", "--model-parallel", "2",
                              "--steps", "2", "--batch", "8", "--seq", "16",
                              "--n-accum", "2", "--log-every", "1"])
    np.savez(f"{out}.{rank}.npz", **res)
    dist.destroy_process_group()


if __name__ == "__main__":
    store, out = sys.argv[1:]
    mp.spawn(work, args=(4, store, out), nprocs=4)
"""

REFERENCE = COMMON + r"""
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from repro.configs import registry
from repro.models.model import Model
from repro.sharding.plan import make_plan
from repro.train.optimizer import make_optimizer
from repro.train.step import make_train_step


class GradsOut:
    # an optimizer whose new parameters are the step's averaged gradients
    def update(self, params, grads, opt_state, step):
        return grads, opt_state, {}


out = sys.argv[1]
arrays = np.load(out + ".in.npz")
mesh = Mesh(np.array(jax.devices()).reshape(2, 2), ("data", "model"))
cfg = registry.get("llama3.2-1b").reduced().replace(**KW)
plan = make_plan(cfg, mesh)
model = Model(cfg, plan)
opt = make_optimizer(cfg)
meta = model.param_meta()
res = {}
with mesh:
    for hoist in (False, True):
        h = int(hoist)
        for name, o in (("grads", GradsOut()), ("adamw", opt)):
            params = jax.device_put(unflatten(arrays, "params"),
                                    plan.param_shardings(meta))
            state = jax.device_put(
                opt.init(params), jax.tree_util.tree_map(
                    lambda s: NamedSharding(mesh, s),
                    plan.param_specs(opt.state_meta(meta)),
                    is_leaf=lambda x: isinstance(x, P)))
            batch = jax.device_put(
                {k: jnp.asarray(arrays[k]) for k in ("tokens", "labels")},
                NamedSharding(mesh, P("data", None)))
            step = make_train_step(model, o, n_accum=N_ACCUM,
                                   hoist_gather=hoist)
            p2, s2, m = jax.jit(step)(params, state, batch, 0)
            res[f"loss{h}"] = float(m["loss"])
            if name == "grads":
                flatten(jax.device_get(p2), f"grads{h}", res)
            else:
                flatten(jax.device_get(p2), f"params{h}", res)
                flatten(first_moments(jax.device_get(s2)), f"m{h}", res)
np.savez(out + ".ref.npz", **res)
"""


def _flat(tree, prefix):
    out = {}

    def walk(t, p):
        if isinstance(t, dict):
            for k in sorted(t):
                walk(t[k], p + "/" + k)
        else:
            out[p] = np.asarray(t)
    walk(tree, prefix)
    return out


def _first_moments(state):
    if "m" in state and not isinstance(state["m"], dict):
        return state["m"]
    return {k: _first_moments(v) for k, v in state.items()}


def _cfgs():
    return (jregistry.get("llama3.2-1b").reduced().replace(**KW),
            registry.get("llama3.2-1b").reduced().replace(**KW))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The 4-rank world's results (rank 0's, and every rank's CLI loss),
    the reference's on its Auto mesh, and the port's one-process step."""
    tmp = tmp_path_factory.mktemp("spmd")
    jcfg, cfg = _cfgs()
    jm = JModel(jcfg, jplan.make_plan(jcfg, None))
    params = jax.device_get(jm.init(jax.random.PRNGKey(0)))
    rng = np.random.default_rng(7)
    toks = rng.integers(0, cfg.vocab_size, (B, S + 1)).astype(np.int32)
    arrays = {"tokens": toks[:, :-1], "labels": toks[:, 1:],
              **_flat(params, "params")}
    out = str(tmp / "run")
    np.savez(out + ".in.npz", **arrays)
    src = os.path.join(os.path.dirname(__file__), "..", "src")
    world_py, ref_py = tmp / "world.py", tmp / "reference.py"
    world_py.write_text(WORLD)  # spawn re-imports it by path
    ref_py.write_text(REFERENCE)
    world = subprocess.Popen(
        [sys.executable, str(world_py), str(tmp / "store"), out],
        env=dict(os.environ, PYTHONPATH=src), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    ref = subprocess.Popen(
        [sys.executable, str(ref_py), out],
        env=dict(os.environ, PYTHONPATH=src, JAX_PLATFORMS="cpu",
                 XLA_FLAGS="--xla_force_host_platform_device_count=4"),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    w_out, w_err = world.communicate(timeout=240)
    r_out, r_err = ref.communicate(timeout=240)
    assert world.returncode == 0, w_err[-3000:]
    assert ref.returncode == 0, r_err[-3000:]
    ranks = [dict(np.load(f"{out}.{r}.npz")) for r in range(4)]
    reference = dict(np.load(out + ".ref.npz"))

    # the port's one-process step on the same weights and batch
    model = Model(cfg, device="cpu").load_reference(params)
    opt = make_optimizer(cfg)
    batch = {"tokens": torch.from_numpy(arrays["tokens"]),
             "labels": torch.from_numpy(arrays["labels"])}
    w0 = pm.tree_map(lambda t: t.clone(), model.weights())
    one = {}
    for h in (0, 1):  # the update sets the model's weights: start from w0
        p = pm.tree_map(lambda t: t.clone(), w0)
        state = opt.init(p)
        step = make_train_step(model, opt, n_accum=N_ACCUM)
        loss, metrics, grads = step.grads(p, batch)
        p, state, m = step.update(p, state, loss, metrics, grads, 0)
        one[f"loss{h}"] = float(m["loss"])
        one.update(_flat(pm.tree_map(lambda t: t.numpy(), grads),
                         f"grads{h}"))
        one.update(_flat(pm.tree_map(lambda t: t.numpy(), p), f"params{h}"))
        one.update(_flat(pm.tree_map(lambda t: t.numpy(),
                                     _first_moments(state)), f"m{h}"))
    for arch in DENSE:
        cfg = registry.get(arch).reduced().replace(dtype="float32")
        m = Model(cfg, device="cpu").init(0)
        loss, _, grads = make_train_step(
            m, make_optimizer(cfg), n_accum=N_ACCUM).grads(m.weights(), batch)
        one[f"{arch}/loss"] = float(loss)
        one.update(_flat(pm.tree_map(lambda t: t.numpy(), grads),
                         f"{arch}/grads"))
    return ranks, reference, one


def _leaves_close(got, want, prefix):
    keys = sorted(k for k in want if k.startswith(prefix + "/"))
    assert keys and keys == sorted(k for k in got
                                   if k.startswith(prefix + "/"))
    for k in keys:
        w = np.asarray(want[k], np.float64)
        err = float(np.abs(np.asarray(got[k], np.float64) - w).max())
        assert err <= TOL * max(float(np.abs(w).max()), 1e-30), (k, err)


@pytest.mark.parametrize("hoist", HOIST, ids=["gather", "hoist_gather"])
@pytest.mark.parametrize("what", ["grads", "params", "m"])
def test_sharded_step_equals_one_process(runs, hoist, what):
    ranks, _, one = runs
    h = int(hoist)
    _leaves_close(ranks[0], one, f"{what}{h}")
    assert abs(float(ranks[0][f"loss{h}"]) - one[f"loss{h}"]) <= \
        TOL * abs(one[f"loss{h}"])


@pytest.mark.parametrize("hoist", HOIST, ids=["gather", "hoist_gather"])
@pytest.mark.parametrize("what", ["grads", "params", "m"])
def test_sharded_step_equals_reference_auto_mesh(runs, hoist, what):
    ranks, ref, _ = runs
    h = int(hoist)
    _leaves_close(ranks[0], ref, f"{what}{h}")
    assert abs(float(ranks[0][f"loss{h}"]) - float(ref[f"loss{h}"])) <= \
        TOL * abs(float(ref[f"loss{h}"]))


@pytest.mark.parametrize("hoist", HOIST, ids=["gather", "hoist_gather"])
def test_every_rank_holds_the_same_step(runs, hoist):
    """Every rank's gathered gradients and parameters are rank 0's, bit for
    bit, and each gradient comes back at its parameter's placements."""
    ranks, _, _ = runs
    h = int(hoist)
    for r in ranks:
        assert bool(r[f"place_ok{h}"])
        for k in r:
            if k.startswith((f"grads{h}/", f"params{h}/")):
                np.testing.assert_array_equal(r[k], ranks[0][k])


def test_cli_trains_at_model_parallel_2(runs):
    ranks, _, _ = runs
    losses = [float(r["cli"]) for r in ranks]
    assert np.isfinite(losses[0]) and losses == [losses[0]] * 4


@pytest.mark.parametrize("arch", DENSE)
def test_other_dense_configs_shard(runs, arch):
    """qwen3's qk-norm, nemotron's relu2 MLP and layernorm, deepseek-67b
    (Adafactor's state placed as the parameters): the sharded gradients
    equal the one-process step's within 1e-5 of each leaf's largest
    magnitude."""
    ranks, _, one = runs
    _leaves_close(ranks[0], one, f"{arch}/grads")
    assert abs(float(ranks[0][f"{arch}/loss"]) - one[f"{arch}/loss"]) <= \
        TOL * abs(one[f"{arch}/loss"])

"""The port's train step across ranks for the moe, ssm and hybrid families
(``train/step.py``'s sharded step; ``models/moe.py``, ``models/ssm.py``
and MLA in ``models/attention.py`` inside an ``spmd.region``) against the
reference's sharded step and the port's one-process step.

One subprocess spawns a 4-rank gloo world on the CPU (a ``FileStore``
under ``tmp_path``: no TCP port). Over a ``{data 2, model 2}``
``DeviceMesh`` it takes one AdamW step of each config, reduced, float32,
B 8, S 32, ``n_accum`` 2, from the reference's initial weights: mixtral-8x7b
(8 experts, ``ep``: 4 a rank), mixtral-8x7b with 3 experts (``tp``: the
columns of every expert), deepseek-v2-236b (MLA, a shared expert, a
leading dense layer; AdamW in both packages, where the config names
Adafactor), mamba2-780m (4 of 8 heads a rank through the scan) and
zamba2-1.2b (the shared attention block reused by both groups). Each rank
gathers every gradient, updated parameter and first moment
(``spmd.full_tensor``). mixtral (``ep``) and mamba2 run again with
``hoist_gather``; the MoE configs take the step's gradients on a
``{data 1, model 4}`` mesh too; ``spmd.all_sum`` is checked on both axes;
and the CLI takes 2 steps at ``--model-parallel 2`` for mamba2-780m and
mixtral-8x7b. Beside it a second subprocess runs the reference's step on
a hand-built ``Mesh`` of 4 forced CPU devices (Auto axes, as in
``tests/test_torch_spmd_train.py``), one jitted AdamW step per config whose
optimizer also hands back the averaged gradients.

At data 2 the MoE configs equal the reference's sharded step only: each
data rank's rows form their own dispatch groups (the reference's
shard-local grouping), which changes the capacity, and the router's aux
loss is a product of means over every rank's groups. mamba2 and zamba2
equal the port's one-process step as well, and the MoE configs equal it at
data 1. The losses and every MoE leaf agree within 1e-5 of each leaf's
largest magnitude. The recurrent families' gradients carry a float32
floor that no reordering of the same sums gets under: the port's
one-process step lies more than 1e-5 of a leaf's largest magnitude from
the reference's step (``tests/test_torch_train.py`` measures 1.7e-5 on
mamba2 and 3.0e-4 on zamba2's embedding for the unsharded steps and holds
them at 1e-3). So for mamba2 and zamba2 each leaf must lie within 1e-5 of
its largest magnitude beyond that floor, measured leaf by leaf on the same
weights and batch (the distance between the port's one-process step and
the reference's sharded step): the sharding adds at most 1e-5 to the
distance between two correct float32 steps.
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
from repro_torch.models import params as pm
from repro_torch.models.model import Model
from repro_torch.train.optimizer import make_optimizer
from repro_torch.train.step import make_train_step

B, S, N_ACCUM = 8, 32, 2
TOL = 1e-5
# name -> (arch, the same replace in both packages)
CONFIGS = {
    "mixtral_ep": ("mixtral-8x7b", {}),
    "mixtral_tp": ("mixtral-8x7b", {"num_experts": 3}),
    "deepseek_v2": ("deepseek-v2-236b", {"optimizer": "adamw"}),
    "mamba2": ("mamba2-780m", {}),
    "zamba2": ("zamba2-1.2b", {}),
}
MOE = ("mixtral_ep", "mixtral_tp", "deepseek_v2")
RECURRENT = ("mamba2", "zamba2")
HOIST = ("mixtral_ep", "mamba2")
# held against the port's one-process step alone: two B/C groups, cut by
# group at model 2 and read whole by two ranks each at model 4
GROUPED = {"mamba2_g2": ("mamba2-780m", {"ssm_ngroups": 2})}

COMMON = r"""
import sys
import numpy as np

CONFIGS = {
    "mixtral_ep": ("mixtral-8x7b", {}),
    "mixtral_tp": ("mixtral-8x7b", {"num_experts": 3}),
    "deepseek_v2": ("deepseek-v2-236b", {"optimizer": "adamw"}),
    "mamba2": ("mamba2-780m", {}),
    "zamba2": ("zamba2-1.2b", {}),
}
MOE = ("mixtral_ep", "mixtral_tp", "deepseek_v2")
HOIST = ("mixtral_ep", "mamba2")
GROUPED = {"mamba2_g2": ("mamba2-780m", {"ssm_ngroups": 2})}
N_ACCUM = 2


def cfg_of(registry, name):
    arch, kw = {**CONFIGS, **GROUPED}[name]
    return registry.get(arch).reduced().replace(dtype="float32", **kw)


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
"""

WORLD = COMMON + r"""
import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def from_npz(meta, arrays, prefix):
    # the weight tree of meta's keys (an empty subtree stays empty)
    if isinstance(meta, dict):
        return {k: from_npz(v, arrays, prefix + "/" + k)
                for k, v in meta.items()}
    return torch.from_numpy(arrays[prefix])


def kv_heads(tree, fn):
    # fn applied to the GQA K/V projections (..., Hkv, dh) of a tree
    return {k: kv_heads(v, fn) if isinstance(v, dict)
            else fn(v) if k in ("wk", "wv") else v for k, v in tree.items()}


def all_sum_check(spmd, mesh):
    # spmd.all_sum over each axis: the value and the gradient both summed
    rank = dist.get_rank()
    ok = True
    with spmd.region(mesh.get_group("model"), mesh.get_group("data")):
        for axis in ("model", "data"):
            group = mesh.get_group(axis)
            x = torch.full((3,), float(rank + 1), requires_grad=True)
            y = spmd.all_sum(x, axis)
            (y * (rank + 1)).sum().backward()
            ranks = dist.get_process_group_ranks(group)
            want = float(sum(r + 1 for r in ranks))
            ok &= bool(torch.equal(y.detach(), torch.full((3,), want)))
            ok &= bool(torch.equal(x.grad, torch.full((3,), want)))
    return ok


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
    batch = {k: torch.from_numpy(arrays[k]) for k in ("tokens", "labels")}
    gather = lambda tree: pm.tree_map(
        lambda x: spmd.full_tensor(x).numpy(), tree)
    meshes = {"d2m2": make_host_mesh(model=2, device="cpu"),
              "d1m4": make_host_mesh(model=4, device="cpu")}
    res = {"all_sum_ok": all_sum_check(spmd, meshes["d2m2"])}
    for name in [*CONFIGS, *GROUPED]:
        cfg = cfg_of(registry, name)
        runs = [("d2m2", False, name in CONFIGS)]
        if name in HOIST:
            runs.append(("d2m2", True, True))
        if name in MOE or name in GROUPED:
            runs.append(("d1m4", False, False))
        for mesh_name, hoist, update in runs:
            plan = make_plan(cfg, meshes[mesh_name])
            model = Model(cfg, plan=plan, device="cpu")
            opt = make_optimizer(cfg)
            meta = model.param_meta()
            # a plan that replicates KV heads (mixtral's 2 over 4 ranks)
            # takes each head kv_repeat times in a row; their gradients
            # fold back to the unreplicated head's
            r = plan.kv_repeat
            full = kv_heads(from_npz(Model(cfg, device="cpu").param_meta(),
                                     arrays, name + "/params"),
                            lambda t: t.repeat_interleave(r, dim=-2))
            it = iter(pm.tree_leaves(plan.param_shardings(meta)))
            params = pm.tree_map(lambda t: spmd.place(t, next(it)), full)
            step = make_train_step(model, opt, n_accum=N_ACCUM,
                                   hoist_gather=hoist)
            loss, metrics, grads = step.grads(params, batch)
            key = f"{name}/{mesh_name}/{int(hoist)}"
            res[f"{key}/loss"] = float(loss)
            res[f"{key}/place_ok"] = all(
                g.placements == p.placements for g, p in zip(
                    pm.tree_leaves(grads), pm.tree_leaves(params)))
            for m in ("moe_aux", "moe_z"):
                if m in metrics:
                    res[f"{key}/{m}"] = float(metrics[m])
            flatten(kv_heads(gather(grads), lambda g: g.reshape(
                *g.shape[:-2], g.shape[-2] // r, r, g.shape[-1]).sum(-2)),
                f"{key}/grads", res)
            if not update:
                continue
            it = iter(pm.tree_leaves(plan.param_shardings(
                opt.state_meta(meta))))
            state = pm.tree_map(lambda t: spmd.place(t, next(it)),
                                opt.init(full))
            params, state, _ = step.update(params, state, loss, metrics,
                                           grads, 0)
            flatten(gather(params), f"{key}/params", res)
            flatten(gather(first_moments(state)), f"{key}/m", res)
    for arch, seq in (("mamba2-780m", "32"), ("mixtral-8x7b", "16")):
        res[f"cli/{arch}"] = launch.main([
            "--device", "cpu", "--arch", arch, "--model-parallel", "2",
            "--steps", "2", "--batch", "8", "--seq", seq, "--n-accum", "2",
            "--log-every", "1"])
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


class WithGrads:
    # the config's optimizer, its state handed back beside the step's
    # averaged gradients
    def __init__(self, opt):
        self.opt = opt

    def update(self, params, grads, opt_state, step):
        p, s, m = self.opt.update(params, grads, opt_state, step)
        return p, {"state": s, "grads": grads}, m


out = sys.argv[1]
arrays = np.load(out + ".in.npz")
mesh = Mesh(np.array(jax.devices()).reshape(2, 2), ("data", "model"))
res = {}
with mesh:
    for name in CONFIGS:
        cfg = cfg_of(registry, name)
        plan = make_plan(cfg, mesh)
        model = Model(cfg, plan)
        opt = make_optimizer(cfg)
        meta = model.param_meta()
        params = unflatten(arrays, name + "/params")
        if cfg.family == "hybrid" and "tail" not in params["blocks"]:
            params["blocks"]["tail"] = {}
        params = jax.device_put(params, plan.param_shardings(meta))
        state = jax.device_put(
            opt.init(params), jax.tree_util.tree_map(
                lambda s: NamedSharding(mesh, s),
                plan.param_specs(opt.state_meta(meta)),
                is_leaf=lambda x: isinstance(x, P)))
        batch = jax.device_put(
            {k: jnp.asarray(arrays[k]) for k in ("tokens", "labels")},
            NamedSharding(mesh, P("data", None)))
        step = make_train_step(model, WithGrads(opt), n_accum=N_ACCUM)
        p2, s2, m = jax.jit(step)(params, state, batch, 0)
        res[f"{name}/loss"] = float(m["loss"])
        for k in ("moe_aux", "moe_z"):
            if k in m:
                res[f"{name}/{k}"] = float(m[k])
        s2 = jax.device_get(s2)
        flatten(s2["grads"], f"{name}/grads", res)
        flatten(jax.device_get(p2), f"{name}/params", res)
        flatten(first_moments(s2["state"]), f"{name}/m", res)
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


def _cfgs(name):
    arch, kw = {**CONFIGS, **GROUPED}[name]
    return (jregistry.get(arch).reduced().replace(dtype="float32", **kw),
            registry.get(arch).reduced().replace(dtype="float32", **kw))


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Many small ops: with several test processes sharing the cores torch
    runs on one thread here (as in ``tests/test_torch_faults.py``)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def runs(tmp_path_factory, one_thread):
    """Rank 0's results (and every rank's CLI losses), the reference's on
    its Auto mesh, and the port's one-process step, per config."""
    tmp = tmp_path_factory.mktemp("spmd_families")
    rng = np.random.default_rng(11)
    toks = rng.integers(0, 256, (B, S + 1)).astype(np.int32)
    arrays = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    inits = {}
    for i, name in enumerate([*CONFIGS, *GROUPED]):
        jcfg, _ = _cfgs(name)
        jm = JModel(jcfg, jplan.make_plan(jcfg, None))
        inits[name] = jax.device_get(jm.init(jax.random.PRNGKey(i)))
        arrays.update(_flat(inits[name], name + "/params"))
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

    # meanwhile the port's one-process step on the same weights and batch
    batch = {k: torch.from_numpy(arrays[k]) for k in ("tokens", "labels")}
    one = {}
    for name in [*CONFIGS, *GROUPED]:
        _, cfg = _cfgs(name)
        model = Model(cfg, device="cpu").load_reference(inits[name])
        opt = make_optimizer(cfg)
        p = pm.tree_map(lambda t: t.clone(), model.weights())
        state = opt.init(p)
        step = make_train_step(model, opt, n_accum=N_ACCUM)
        loss, metrics, grads = step.grads(p, batch)
        p, state, m = step.update(p, state, loss, metrics, grads, 0)
        one[f"{name}/loss"] = float(m["loss"])
        one.update(_flat(pm.tree_map(lambda t: t.numpy(), grads),
                         f"{name}/grads"))
        one.update(_flat(pm.tree_map(lambda t: t.numpy(), p),
                         f"{name}/params"))
        one.update(_flat(pm.tree_map(lambda t: t.numpy(),
                                     _first_moments(state)), f"{name}/m"))

    w_out, w_err = world.communicate(timeout=300)
    r_out, r_err = ref.communicate(timeout=300)
    assert world.returncode == 0, w_err[-3000:]
    assert ref.returncode == 0, r_err[-3000:]
    ranks = [dict(np.load(f"{out}.{r}.npz")) for r in range(4)]
    reference = dict(np.load(out + ".ref.npz"))
    return ranks, reference, one


def _dist(a, b) -> float:
    return float(np.abs(np.asarray(a, np.float64)
                        - np.asarray(b, np.float64)).max())


def _leaves_close(got, got_prefix, want, want_prefix, floor=None):
    """Every leaf of ``got`` within TOL of the largest magnitude of
    ``want`` 's leaf; with ``floor`` = (one, prefix, ref, prefix), beyond
    the distance between those two correct float32 steps on that leaf
    (the recurrent families' floor: module docstring)."""
    keys = sorted(k[len(want_prefix):] for k in want
                  if k.startswith(want_prefix + "/"))
    assert keys and keys == sorted(k[len(got_prefix):] for k in got
                                   if k.startswith(got_prefix + "/"))
    for k in keys:
        w = want[want_prefix + k]
        err = _dist(got[got_prefix + k], w)
        bound = TOL * max(float(np.abs(w).max()), 1e-30)
        if floor is not None:
            a, ap, b, bp = floor
            bound += _dist(a[ap + k], b[bp + k])
        assert err <= bound, (k, err, bound)


def _floor(name, what, one, ref):
    """The recurrent families' floor for leaves ``what`` (module
    docstring); None for the MoE configs."""
    if name not in RECURRENT:
        return None
    return (one, f"{name}/{what}", ref, f"{name}/{what}")


def _loss_close(got, want):
    assert abs(float(got) - float(want)) <= TOL * abs(float(want))


@pytest.mark.parametrize("what", ["grads", "params", "m"])
@pytest.mark.parametrize("name", list(CONFIGS))
def test_sharded_step_equals_reference_sharded(runs, name, what):
    """{data 2, model 2}: the loss, every gradient, AdamW's parameters and
    first moments equal the reference's sharded step."""
    ranks, ref, one = runs
    key = f"{name}/d2m2/0"
    _leaves_close(ranks[0], f"{key}/{what}", ref, f"{name}/{what}",
                  _floor(name, what, one, ref))
    _loss_close(ranks[0][f"{key}/loss"], ref[f"{name}/loss"])
    assert bool(ranks[0][f"{key}/place_ok"])


@pytest.mark.parametrize("what", ["grads", "params", "m"])
@pytest.mark.parametrize("name", RECURRENT)
def test_recurrent_sharded_step_equals_one_process(runs, name, what):
    """mamba2 and zamba2 (no dispatch groups) equal the port's one-process
    step at {data 2, model 2} too."""
    ranks, ref, one = runs
    key = f"{name}/d2m2/0"
    _leaves_close(ranks[0], f"{key}/{what}", one, f"{name}/{what}",
                  _floor(name, what, one, ref))
    _loss_close(ranks[0][f"{key}/loss"], one[f"{name}/loss"])


@pytest.mark.parametrize("name", MOE)
def test_moe_data1_equals_one_process(runs, name):
    """{data 1, model 4} (mixtral ``ep``: 2 experts a rank; 3 experts:
    ``tp``, 16 of 64 columns; deepseek-v2: one MLA head and 2 experts a
    rank): one data rank dispatches the whole microbatch, so the step's
    loss and gradients equal the port's one-process step."""
    ranks, _, one = runs
    key = f"{name}/d1m4/0"
    _leaves_close(ranks[0], f"{key}/grads", one, f"{name}/grads")
    _loss_close(ranks[0][f"{key}/loss"], one[f"{name}/loss"])
    assert bool(ranks[0][f"{key}/place_ok"])


@pytest.mark.parametrize("mesh", ["d2m2", "d1m4"])
def test_grouped_bc_heads_read_their_groups(runs, mesh):
    """mamba2 with two B/C groups: at model 2 each rank's 4 heads read one
    group (``wB`` and ``wC`` cut by group), at model 4 two ranks read each
    group; the gradients equal the one-process step's."""
    ranks, _, one = runs
    key = f"mamba2_g2/{mesh}/0"
    _leaves_close(ranks[0], f"{key}/grads", one, "mamba2_g2/grads")
    _loss_close(ranks[0][f"{key}/loss"], one["mamba2_g2/loss"])


@pytest.mark.parametrize("what", ["grads", "params", "m"])
@pytest.mark.parametrize("name", HOIST)
def test_hoist_gather_equals_reference(runs, name, what):
    """``hoist_gather`` (one gather a step, float32 reduce-scatter per
    microbatch) takes the same step: held against the reference's."""
    ranks, ref, one = runs
    key = f"{name}/d2m2/1"
    _leaves_close(ranks[0], f"{key}/{what}", ref, f"{name}/{what}",
                  _floor(name, what, one, ref))
    _loss_close(ranks[0][f"{key}/loss"], ref[f"{name}/loss"])


@pytest.mark.parametrize("name", MOE)
def test_moe_data2_loss_is_the_reference_sharded_loss(runs, name):
    """Pinned: at data 2 each data rank's rows form their own dispatch
    groups (a group of 64 tokens, capacity 20, against 128 and 40 in one
    process) and the aux loss is a product of means over both ranks'
    groups, as in the reference under a mesh. So the loss is the
    reference's sharded loss and not the one-process loss, and moe_aux and
    moe_z are reported at the batch's value (not times the data ranks)."""
    ranks, ref, one = runs
    got = ranks[0][f"{name}/d2m2/0/loss"]
    _loss_close(got, ref[f"{name}/loss"])
    assert abs(float(got) - one[f"{name}/loss"]) > 10 * TOL * abs(
        one[f"{name}/loss"])
    for m in ("moe_aux", "moe_z"):
        _loss_close(ranks[0][f"{name}/d2m2/0/{m}"], ref[f"{name}/{m}"])


def test_every_rank_holds_the_same_step(runs):
    """Every rank's gathered gradients, parameters and moments are rank
    0's, bit for bit."""
    ranks, _, _ = runs
    for r in ranks[1:]:
        for k in ranks[0]:
            if "/grads/" in k or "/params/" in k or "/m/" in k:
                np.testing.assert_array_equal(r[k], ranks[0][k])


def test_all_sum_sums_value_and_gradient(runs):
    """``spmd.all_sum`` over the model and the data axis: every rank reads
    the sum of the ranks' values, and each rank's gradient is the sum of
    the ranks' gradients."""
    ranks, _, _ = runs
    assert all(bool(r["all_sum_ok"]) for r in ranks)


@pytest.mark.parametrize("arch", ["mamba2-780m", "mixtral-8x7b"])
def test_cli_trains_at_model_parallel_2(runs, arch):
    ranks, _, _ = runs
    losses = [float(r[f"cli/{arch}"]) for r in ranks]
    assert np.isfinite(losses[0]) and losses == [losses[0]] * 4

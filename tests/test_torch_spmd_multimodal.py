"""The port's train step across ranks for the vlm and audio families, on a
``(pod, data, model)`` mesh, and the CLI's checkpoints across ranks
(``train/step.py``'s sharded step, ``models/multimodal.py`` inside an
``spmd.region``, ``spmd.dp_group``, ``CheckpointManager(...,
across_ranks=True)``), against the reference's sharded step and the
port's one-process step.

One subprocess spawns a 4-rank gloo world on the CPU (a ``FileStore``
under ``tmp_path``: no TCP port). It takes one AdamW step of each run,
reduced, float32, B 8, S 32, ``n_accum`` 2, from the reference's initial
weights drawn under the plan of the run's mesh (so the padded and
replicated heads hold the reference's values), the cross gates opened
(the init's zero gates would shut every cross-attention's gradient):
- llama-3.2-vision-11b (one group of 2 self blocks and a gated cross block
  over 16 image tokens) on ``{data 2, model 2}``, ``hoist_gather`` off and
  on, and on ``{data 1, model 4}``, where its 2 kv heads replicate to 4
  (``kv_repeat`` 2);
- whisper-small (2 encoder and 2 decoder layers over 32 frames) on both
  meshes, and with 6 heads on ``{data 1, model 4}``, padded to 8;
- llama3.2-1b and mixtral-8x7b (``ep``) on ``{pod 2, data 2, model 1}``:
  FSDP over both data axes, the rows over their product, and the MoE
  router's sums over both (``hoist_gather`` on for llama as well).
Each rank gathers every gradient, updated parameter and first moment
(``spmd.full_tensor``). Beside it a second subprocess runs the
reference's jitted step of each on a hand-built ``Mesh`` of 4 forced CPU
devices of the same shape (Auto axes, as in
``tests/test_torch_spmd_train.py``). Every leaf agrees within 1e-5 of its
largest magnitude with the reference's sharded step and, but for
mixtral (whose dispatch groups are each data rank's rows), with the
port's one-process step on the same padded weights.

The world also runs the CLI at ``--model-parallel 2`` (whisper-small): 4
steps with ``--checkpoint-every 2``, then 2 steps and ``--resume`` to 4 in
a second directory; the two runs end on the same loss and the same saved
state, bit for bit, and rank 0 alone writes. A sharded state saved
across ranks restores into the one-process tree as the gathered state,
and into every rank at its placements, bit for bit.
"""
import os
import subprocess
import sys
import types

import jax
import numpy as np
import pytest
import torch

from repro.configs import registry as jregistry
from repro.models.model import Model as JModel
from repro.sharding import plan as jplan
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs import registry
from repro_torch.launch.mesh import MeshShape
from repro_torch.models import params as pm
from repro_torch.models.model import Model
from repro_torch.sharding.plan import make_plan
from repro_torch.train.optimizer import make_optimizer
from repro_torch.train.step import make_train_step

B, S = 8, 32
TOL = 1e-5

COMMON = r"""
import sys
import numpy as np

# name -> (arch, the same replace in both packages)
CONFIGS = {
    "vlm": ("llama-3.2-vision-11b", {}),
    "whisper": ("whisper-small", {}),
    "whisper6": ("whisper-small", {"num_heads": 6, "num_kv_heads": 6}),
    "dense": ("llama3.2-1b", {}),
    "mixtral": ("mixtral-8x7b", {}),
}
# mesh -> (axis names, sizes)
MESHES = {
    "d2m2": (("data", "model"), (2, 2)),
    "d1m4": (("data", "model"), (1, 4)),
    "p2d2m1": (("pod", "data", "model"), (2, 2, 1)),
}
# (config, mesh): the reference's step and the port's
CASES = (("vlm", "d2m2"), ("vlm", "d1m4"), ("whisper", "d2m2"),
         ("whisper", "d1m4"), ("whisper6", "d1m4"), ("dense", "p2d2m1"),
         ("mixtral", "p2d2m1"))
# the port's runs again with hoist_gather
HOIST = (("vlm", "d2m2"), ("dense", "p2d2m1"))
N_ACCUM = 2


def cfg_of(registry, name):
    arch, kw = CONFIGS[name]
    return registry.get(arch).reduced().replace(dtype="float32", **kw)


def batch_keys(cfg):
    return ("tokens", "labels") + {"vlm": ("image_embeds",),
                                   "audio": ("audio_frames",)}.get(
        cfg.family, ())


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
    if isinstance(meta, dict):
        return {k: from_npz(v, arrays, prefix + "/" + k)
                for k, v in meta.items()}
    return torch.from_numpy(arrays[prefix])


def all_sum_check(spmd, mesh):
    # spmd.all_sum over "data" on the 3-D mesh sums over pod x data
    rank = dist.get_rank()
    with spmd.region(mesh.get_group("model"),
                     spmd.dp_group(mesh, ("pod", "data"))):
        x = torch.full((3,), float(rank + 1), requires_grad=True)
        y = spmd.all_sum(x, "data")
        (y * (rank + 1)).sum().backward()
        ok = spmd.size("data") == 4
    return ok and bool(torch.equal(y.detach(), torch.full((3,), 10.0))) \
        and bool(torch.equal(x.grad, torch.full((3,), 10.0)))


def work(rank, world, store, out):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    from torch.distributed.device_mesh import DeviceMesh

    from repro_torch.checkpoint import manager as M
    from repro_torch.configs import registry
    from repro_torch.launch import train as launch
    from repro_torch.models import params as pm
    from repro_torch.models.model import Model
    from repro_torch.sharding import spmd
    from repro_torch.sharding.plan import make_plan
    from repro_torch.train.optimizer import make_optimizer
    from repro_torch.train.step import make_train_step
    writes = []
    write = M.CheckpointManager._write
    M.CheckpointManager._write = lambda self, *a: (writes.append(a[0]),
                                                   write(self, *a))
    arrays = np.load(out + ".in.npz")
    gather = lambda tree: pm.tree_map(
        lambda x: spmd.full_tensor(x).numpy(), tree)
    meshes = {k: DeviceMesh("cpu", torch.arange(4).reshape(sizes),
                            mesh_dim_names=names)
              for k, (names, sizes) in MESHES.items()}
    res = {"all_sum_ok": all_sum_check(spmd, meshes["p2d2m1"])}
    runs = [(n, m, False) for n, m in CASES] + [(n, m, True)
                                                for n, m in HOIST]
    for name, mesh_name, hoist in runs:
        cfg = cfg_of(registry, name)
        batch = {k: torch.from_numpy(arrays[k]) for k in batch_keys(cfg)}
        plan = make_plan(cfg, meshes[mesh_name])
        model = Model(cfg, plan=plan, device="cpu")
        opt = make_optimizer(cfg)
        meta = model.param_meta()
        full = from_npz(meta, arrays, f"{name}/{mesh_name}/params")
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
        flatten(gather(grads), f"{key}/grads", res)
        it = iter(pm.tree_leaves(plan.param_shardings(
            opt.state_meta(meta))))
        state = pm.tree_map(lambda t: spmd.place(t, next(it)),
                            opt.init(full))
        params, state, _ = step.update(params, state, loss, metrics,
                                       grads, 0)
        flatten(gather(params), f"{key}/params", res)
        flatten(gather(first_moments(state)), f"{key}/m", res)
        if key == "whisper/d2m2/0":
            # the sharded state saved across ranks, restored at its
            # placements on every rank
            tree = {"params": params, "opt": state}
            mgr = M.CheckpointManager(out + ".ckpt", across_ranks=True)
            mgr.save(1, tree)
            mgr.wait()
            flatten(gather(tree), "saved", res)
            back, at = mgr.restore(tree, shardings={
                "params": plan.param_shardings(meta),
                "opt": plan.param_shardings(opt.state_meta(meta))})
            res["restore_ok"] = at == 1 and all(
                a.placements == b.placements
                and torch.equal(a.to_local(), b.to_local())
                for a, b in zip(pm.tree_leaves(back), pm.tree_leaves(tree)))
    cli = ["--device", "cpu", "--arch", "whisper-small", "--model-parallel",
           "2", "--batch", "8", "--seq", "16", "--n-accum", "2",
           "--log-every", "1", "--checkpoint-every", "2"]
    res["cli/whole"] = launch.main(cli + ["--steps", "4",
                                          "--checkpoint-dir", out + ".A"])
    res["cli/first"] = launch.main(cli + ["--steps", "2",
                                          "--checkpoint-dir", out + ".B"])
    res["cli/resumed"] = launch.main(cli + ["--steps", "4", "--resume",
                                            "--checkpoint-dir", out + ".B"])
    res["writes"] = np.asarray(writes, np.int64)
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
res = {}
for name, mesh_name in CASES:
    names, sizes = MESHES[mesh_name]
    mesh = Mesh(np.array(jax.devices()).reshape(sizes), names)
    with mesh:
        cfg = cfg_of(registry, name)
        plan = make_plan(cfg, mesh)
        model = Model(cfg, plan)
        opt = make_optimizer(cfg)
        meta = model.param_meta()
        params = jax.device_put(
            unflatten(arrays, f"{name}/{mesh_name}/params"),
            plan.param_shardings(meta))
        state = jax.device_put(
            opt.init(params), jax.tree_util.tree_map(
                lambda s: NamedSharding(mesh, s),
                plan.param_specs(opt.state_meta(meta)),
                is_leaf=lambda x: isinstance(x, P)))
        batch = jax.device_put(
            {k: jnp.asarray(arrays[k]) for k in batch_keys(cfg)},
            NamedSharding(mesh, P(plan.dp_axes)))
        step = make_train_step(model, WithGrads(opt), n_accum=N_ACCUM)
        p2, s2, m = jax.jit(step)(params, state, batch, 0)
        key = f"{name}/{mesh_name}"
        res[f"{key}/loss"] = float(m["loss"])
        s2 = jax.device_get(s2)
        flatten(s2["grads"], f"{key}/grads", res)
        flatten(jax.device_get(p2), f"{key}/params", res)
        flatten(first_moments(s2["state"]), f"{key}/m", res)
np.savez(out + ".ref.npz", **res)
"""

ns = {}
exec(COMMON, ns)
CONFIGS, MESHES, CASES, HOIST = (ns["CONFIGS"], ns["MESHES"], ns["CASES"],
                                 ns["HOIST"])
N_ACCUM, batch_keys, flatten = ns["N_ACCUM"], ns["batch_keys"], ns["flatten"]
first_moments = ns["first_moments"]
#: the runs whose data ranks dispatch their own MoE groups: held against
#: the reference's sharded step only
DISPATCH = (("mixtral", "p2d2m1"),)


def _cfgs(name):
    arch, kw = CONFIGS[name]
    return (jregistry.get(arch).reduced().replace(dtype="float32", **kw),
            registry.get(arch).reduced().replace(dtype="float32", **kw))


def _open_gates(tree, rng):
    """The tree with each cross gate drawn in [0.3, 0.9): the init's zero
    gates shut the cross-attention (tanh(0) = 0), so no gradient would
    reach its K/V projections, the image embeddings' path or, through
    them, whisper's encoder."""
    if isinstance(tree, dict):
        return {k: rng.uniform(0.3, 0.9, np.shape(v)).astype(np.float32)
                if k == "gate" else _open_gates(v, rng)
                for k, v in tree.items()}
    return tree


def _shape(mesh_name):
    names, sizes = MESHES[mesh_name]
    return MeshShape(names, sizes)


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
    """Every rank's results, the reference's on its Auto meshes, the
    port's one-process step per case, and the output prefix."""
    tmp = tmp_path_factory.mktemp("spmd_multimodal")
    rng = np.random.default_rng(13)
    toks = rng.integers(0, 256, (B, S + 1)).astype(np.int32)
    arrays = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    vcfg, wcfg = _cfgs("vlm")[1], _cfgs("whisper")[1]
    arrays["image_embeds"] = (0.1 * rng.standard_normal(
        (B, vcfg.num_image_tokens, vcfg.d_model))).astype(np.float32)
    arrays["audio_frames"] = (0.1 * rng.standard_normal(
        (B, wcfg.encoder_frames, wcfg.d_model))).astype(np.float32)
    inits = {}
    for i, (name, mesh_name) in enumerate(CASES):
        jcfg, _ = _cfgs(name)
        # the reference's plan of the run's mesh shape: padded heads,
        # replicated kv heads, the padded vocabulary
        names, sizes = MESHES[mesh_name]
        fake = types.SimpleNamespace(axis_names=names,
                                     shape=dict(zip(names, sizes)))
        jm = JModel(jcfg, jplan.make_plan(jcfg, fake))
        inits[name, mesh_name] = _open_gates(jax.device_get(jm.init(
            jax.random.PRNGKey(i))), rng)
        flatten(inits[name, mesh_name], f"{name}/{mesh_name}/params",
                arrays)
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

    # meanwhile the port's one-process step on the same weights and batch,
    # under a shape-only plan of the run's mesh (its padded shapes)
    one = {}
    for name, mesh_name in CASES:
        _, cfg = _cfgs(name)
        batch = {k: torch.from_numpy(arrays[k]) for k in batch_keys(cfg)}
        model = Model(cfg, plan=make_plan(cfg, _shape(mesh_name)),
                      device="cpu").load_reference(inits[name, mesh_name])
        opt = make_optimizer(cfg)
        p = pm.tree_map(lambda t: t.clone(), model.weights())
        state = opt.init(p)
        step = make_train_step(model, opt, n_accum=N_ACCUM)
        loss, metrics, grads = step.grads(p, batch)
        p, state, m = step.update(p, state, loss, metrics, grads, 0)
        key = f"{name}/{mesh_name}"
        one[f"{key}/loss"] = float(m["loss"])
        for what, tree in (("grads", grads), ("params", p),
                           ("m", first_moments(state))):
            flatten(pm.tree_map(lambda t: t.numpy(), tree),
                    f"{key}/{what}", one)

    w_out, w_err = world.communicate(timeout=400)
    r_out, r_err = ref.communicate(timeout=400)
    assert world.returncode == 0, w_err[-3000:]
    assert ref.returncode == 0, r_err[-3000:]
    ranks = [dict(np.load(f"{out}.{r}.npz")) for r in range(4)]
    reference = dict(np.load(out + ".ref.npz"))
    return ranks, reference, one, out


def _dist(a, b) -> float:
    return float(np.abs(np.asarray(a, np.float64)
                        - np.asarray(b, np.float64)).max())


def _leaves_close(got, got_prefix, want, want_prefix, floor=None):
    """Every leaf of ``got`` within TOL of the largest magnitude of
    ``want`` 's leaf, the two trees of the same keys; with ``floor`` =
    (one, ref, prefix), beyond the distance between the port's
    one-process step and the reference's sharded step on that leaf (the
    updated parameters' float32 floor: :func:`_floor`)."""
    keys = sorted(k[len(want_prefix):] for k in want
                  if k.startswith(want_prefix + "/"))
    assert keys and keys == sorted(k[len(got_prefix):] for k in got
                                   if k.startswith(got_prefix + "/"))
    for k in keys:
        w = want[want_prefix + k]
        err = _dist(got[got_prefix + k], w)
        bound = TOL * max(float(np.abs(w).max()), 1e-30)
        if floor is not None:
            one, ref, prefix = floor
            bound += _dist(one[prefix + k], ref[prefix + k])
        assert err <= bound, (k, err, bound)


def _floor(runs, name, mesh, what):
    """AdamW's first step moves each element of a parameter by about
    ``lr * g / (|g| + eps)``: an element whose gradient is a thousandth of
    its leaf's largest takes that gradient's relative rounding, 1e-4 to
    1e-3 of float32 sums in another order, nearly whole. So the updated
    parameters of a run that also has the port's one-process step are
    held within TOL beyond the distance between that step and the
    reference's sharded step, two correct float32 steps, leaf by leaf (as
    ``tests/test_torch_spmd_families.py`` holds its recurrent families);
    the gradients and moments take TOL alone."""
    if what != "params" or (name, mesh) in DISPATCH:
        return None
    _, ref, one, _ = runs
    return one, ref, f"{name}/{mesh}/params"


def _loss_close(got, want):
    assert abs(float(got) - float(want)) <= TOL * abs(float(want))


def _ids(cases):
    return [f"{n}-{m}" for n, m in cases]


@pytest.mark.parametrize("what", ["grads", "params", "m"])
@pytest.mark.parametrize("name,mesh", CASES, ids=_ids(CASES))
def test_sharded_step_equals_reference_sharded(runs, name, mesh, what):
    """The loss, every gradient, AdamW's parameters and first moments
    equal the reference's sharded step on the same mesh."""
    ranks, ref, _, _ = runs
    key = f"{name}/{mesh}/0"
    _leaves_close(ranks[0], f"{key}/{what}", ref, f"{name}/{mesh}/{what}",
                  _floor(runs, name, mesh, what))
    _loss_close(ranks[0][f"{key}/loss"], ref[f"{name}/{mesh}/loss"])
    assert bool(ranks[0][f"{key}/place_ok"])


ONE = [c for c in CASES if c not in DISPATCH]


@pytest.mark.parametrize("what", ["grads", "params", "m"])
@pytest.mark.parametrize("name,mesh", ONE, ids=_ids(ONE))
def test_sharded_step_equals_one_process(runs, name, mesh, what):
    """The same step as the port's one-process step on the same padded
    weights: the padded whisper heads and vlm's replicated kv heads hold
    the one-process values and gradients."""
    ranks, _, one, _ = runs
    key = f"{name}/{mesh}"
    _leaves_close(ranks[0], f"{key}/0/{what}", one, f"{key}/{what}",
                  _floor(runs, name, mesh, what))
    _loss_close(ranks[0][f"{key}/0/loss"], one[f"{key}/loss"])


@pytest.mark.parametrize("what", ["grads", "params", "m"])
@pytest.mark.parametrize("name,mesh", HOIST, ids=_ids(HOIST))
def test_hoist_gather_equals_reference(runs, name, mesh, what):
    """``hoist_gather`` (one gather a step over every data axis, float32
    reduce-scatter per microbatch) takes the same step."""
    ranks, ref, _, _ = runs
    _leaves_close(ranks[0], f"{name}/{mesh}/1/{what}", ref,
                  f"{name}/{mesh}/{what}", _floor(runs, name, mesh, what))
    _loss_close(ranks[0][f"{name}/{mesh}/1/loss"], ref[f"{name}/{mesh}/loss"])


@pytest.mark.parametrize("name,mesh", [("whisper6", "d1m4"),
                                       ("vlm", "d1m4")])
def test_padded_and_replicated_heads(runs, name, mesh):
    """whisper's 6 heads pad to 8 over 4 ranks and vlm's 2 kv heads
    replicate to 4: the gradients reach every head of every K projection,
    self and cross (each padded or replicated head's gradient is nonzero,
    as in the reference)."""
    ranks, ref, _, _ = runs
    _, cfg = _cfgs(name)
    plan = make_plan(cfg, _shape(mesh))
    assert (plan.num_heads, plan.num_kv_heads, plan.kv_repeat) == \
        {"whisper6": (8, 8, 1), "vlm": (4, 4, 2)}[name]
    prefix = f"{name}/{mesh}/0/grads/"
    wk = [k for k in ranks[0] if k.startswith(prefix) and k.endswith("/wk")]
    assert wk
    for k in wk:
        g = ranks[0][k]
        assert g.shape[-2] == plan.num_kv_heads
        assert np.all(np.abs(g).reshape(-1, *g.shape[-2:]).max(
            axis=(0, 2)) > 0), k


def test_the_gate_takes_the_whole_gradient(runs):
    """The cross blocks' gates (vlm's cross block, whisper's decoder
    cross-attention) take the reference's gradient on every mesh: the
    gate multiplies the output after its sum over the model axis."""
    ranks, ref, _, _ = runs
    n = 0
    for name, mesh in CASES[:5]:
        prefix = f"{name}/{mesh}/0/grads/"
        for k in ranks[0]:
            if k.startswith(prefix) and k.endswith("/gate"):
                w = ref[f"{name}/{mesh}/grads/" + k[len(prefix):]]
                assert np.abs(w).max() > 0
                assert _dist(ranks[0][k], w) <= TOL * np.abs(w).max(), k
                n += 1
    assert n == 5  # one stacked gate leaf a model


def test_every_rank_holds_the_same_step(runs):
    """Every rank's gathered gradients, parameters and moments are rank
    0's, bit for bit."""
    ranks, _, _, _ = runs
    for r in ranks[1:]:
        for k in ranks[0]:
            if "/grads/" in k or "/params/" in k or "/m/" in k:
                np.testing.assert_array_equal(r[k], ranks[0][k])


def test_all_sum_over_pod_and_data(runs):
    """On ``{pod 2, data 2, model 1}`` a region's "data" group spans both
    data axes: ``spmd.all_sum`` over it sums the value and the gradient
    over all four ranks."""
    ranks, _, _, _ = runs
    assert all(bool(r["all_sum_ok"]) for r in ranks)


def test_cli_resume_across_ranks_is_bit_for_bit(runs):
    """``--model-parallel 2``: 4 steps with a checkpoint every 2, against
    2 steps and ``--resume`` to 4: the same final loss on every rank and
    the same saved state at step 4, bit for bit."""
    ranks, _, _, out = runs
    whole = [float(r["cli/whole"]) for r in ranks]
    assert np.isfinite(whole[0]) and whole == [whole[0]] * 4
    assert [float(r["cli/resumed"]) for r in ranks] == whole
    for d in (".A", ".B"):
        assert sorted(os.listdir(out + d)) == ["step_00000002",
                                               "step_00000004"]
    a = np.load(out + ".A/step_00000004/arrays.npz")
    b = np.load(out + ".B/step_00000004/arrays.npz")
    assert a.files and sorted(a.files) == sorted(b.files)
    for k in a.files:
        np.testing.assert_array_equal(a[k], b[k])


def test_only_rank_0_writes(runs):
    """Every rank gathers, rank 0 alone writes: the direct save (step 1)
    and the CLI's (steps 2 and 4, then 2, then 4)."""
    ranks, _, _, _ = runs
    assert ranks[0]["writes"].tolist() == [1, 2, 4, 2, 4]
    assert all(r["writes"].size == 0 for r in ranks[1:])


def test_sharded_checkpoint_restores_on_every_rank(runs):
    """The sharded state saved across ranks restores with ``shardings``
    on every rank at its placements, each shard equal bit for bit."""
    ranks, _, _, _ = runs
    assert all(bool(r["restore_ok"]) for r in ranks)


def test_sharded_checkpoint_restores_into_one_process(runs):
    """The checkpoint saved across ranks restores into the one-process
    tree (whisper's weights and AdamW state, plain tensors) as the
    gathered state, bit for bit: the format is the one-process one."""
    ranks, _, _, out = runs
    _, cfg = _cfgs("whisper")
    model = Model(cfg, device="cpu").init(0)
    like = {"params": model.weights(),
            "opt": make_optimizer(cfg).init(model.weights())}
    back, step = CheckpointManager(out + ".ckpt").restore(like)
    assert step == 1
    got = flatten(pm.tree_map(lambda t: t.numpy(), back), "saved", {})
    saved = {k: v for k, v in ranks[0].items() if k.startswith("saved/")}
    assert sorted(got) == sorted(saved)
    for k in got:
        assert isinstance(got[k], np.ndarray)
        np.testing.assert_array_equal(got[k], saved[k])

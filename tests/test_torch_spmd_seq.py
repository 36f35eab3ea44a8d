"""Sequence parallelism in the port's train step across ranks
(``make_plan(..., sequence_parallel=True)``: the residual stream split
along the sequence over the model axis; ``sharding/spmd.py``'s sequence
operators in every family's layers) against the port's own step without
the flag and the reference's sharded step with ``sequence_parallel=True``.

One subprocess spawns a 4-rank gloo world on the CPU (a ``FileStore``
under ``tmp_path``: no TCP port). It takes one AdamW step of each run,
reduced, float32, B 8, S 32, ``n_accum`` 2, from the reference's initial
weights drawn under the plan of the run's mesh, the cross gates opened
(the init's zero gates would shut every cross-attention's gradient), with
the flag and without it, ``hoist_gather`` off and on: llama3.2-1b at the
mini-mesh widths of ``tests/test_torch_spmd_train.py``, qwen3-1.7b
(qk-norm), mixtral-8x7b with its 8 experts (``ep``) and with 3 (``tp``),
deepseek-v2-236b (MLA), mamba2-780m, zamba2-1.2b, llama-3.2-vision-11b
and whisper-small over ``{data 2, model 2}``, and llama3.2-1b over
``{pod 2, data 1, model 2}``. Each rank gathers every gradient, updated
parameter and first moment (``spmd.full_tensor``). For mamba2 and zamba2
the world also takes the step without the flag from masters moved by one
float32 ulp (times a random sign): their float32 floor. The world checks
the three sequence operators against their definitions, and that an S
that does not split over the model axis raises. Beside it two
subprocesses, each taking every other case, run the reference's jitted
step with ``sequence_parallel=True`` on a hand-built ``Mesh`` of 4 forced
CPU devices of each shape (Auto axes, as in
``tests/test_torch_spmd_train.py``), its optimizer handing back the
averaged gradients beside AdamW's state. All three start once the batch
is written, and the test draws each case's weights (one file a case)
while they run the cases before it.

The loss and every leaf agree within 1e-5 of the leaf's largest
magnitude with both; the parameters that AdamW updates, within 1e-5
beyond the distance between the port's step without the flag and the
reference's (:func:`_update_floor`). For mamba2 and zamba2 the bound is
chip_smoke's phase 13d gate: 1e-4 plus 10 times the one-ulp floor, leaf
by leaf (a Mamba2 chunk's decay exponent amplifies any rounding hundreds
of times).
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
from repro_torch.sharding import spmd

B, S = 8, 32
TOL = 1e-5
# chip_smoke.py's phase 13d gate for the recurrent families
REC_TOL, FLOOR_FACTOR = 1e-4, 10.0

COMMON = r"""
import os
import sys
import time

import numpy as np

# name -> (arch, the same replace in both packages)
CONFIGS = {
    "llama": ("llama3.2-1b", dict(num_heads=4, num_kv_heads=2, head_dim=16,
                                  d_model=64, d_ff=128)),
    "qwen3": ("qwen3-1.7b", {}),
    "mixtral_ep": ("mixtral-8x7b", {}),
    "mixtral_tp": ("mixtral-8x7b", {"num_experts": 3}),
    "deepseek_v2": ("deepseek-v2-236b", {"optimizer": "adamw"}),
    "mamba2": ("mamba2-780m", {}),
    "zamba2": ("zamba2-1.2b", {}),
    "vlm": ("llama-3.2-vision-11b", {}),
    "whisper": ("whisper-small", {}),
}
MESHES = {
    "d2m2": (("data", "model"), (2, 2)),
    "p2d1m2": (("pod", "data", "model"), (2, 1, 2)),
}
CASES = tuple((n, "d2m2") for n in CONFIGS) + (("llama", "p2d1m2"),)
RECURRENT = ("mamba2", "zamba2")
N_ACCUM = 2
FLOOR_ULP = 2.0 ** -23


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


def case_path(out, name, mesh_name):
    return f"{out}.{name}.{mesh_name}.npz"


def case_arrays(out, name, mesh_name, timeout=600.0):
    # a case's initial weights, waited for: the test writes each case's
    # file as its weights are drawn, while the runs of the cases before it
    # go on
    path, t0 = case_path(out, name, mesh_name), time.monotonic()
    while not os.path.exists(path):
        if time.monotonic() - t0 > timeout:
            raise TimeoutError(path)
        time.sleep(0.05)
    return np.load(path)
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


def operators_check(spmd, group):
    # the three sequence operators over a 2-rank model group against
    # their definitions: value and gradient, each rank's x and g distinct
    r, n = dist.get_rank(group), dist.get_world_size(group)
    ok = {}

    def x_of(q, s):
        return torch.arange(2 * s * 3, dtype=torch.float32).reshape(
            2, s, 3) * (q + 1) + 100 * q

    def g_of(q, s):
        return torch.cos(torch.arange(2 * s * 3, dtype=torch.float32)
                         ).reshape(2, s, 3) * (q + 2)

    x = x_of(r, 2).requires_grad_(True)
    y = spmd.seq_gather(x, group)
    y.backward(g_of(r, 4))
    ok["gather"] = torch.equal(y.detach(), torch.cat(
        [x_of(q, 2) for q in range(n)], 1)) and torch.equal(
        x.grad, sum(g_of(q, 4) for q in range(n)).chunk(n, 1)[r])
    x = x_of(r, 4).requires_grad_(True)
    y = spmd.seq_scatter(x, group)
    y.backward(g_of(r, 2))
    ok["scatter"] = torch.equal(y.detach(), sum(
        x_of(q, 4) for q in range(n)).chunk(n, 1)[r]) and torch.equal(
        x.grad, torch.cat([g_of(q, 2) for q in range(n)], 1))
    x = x_of(r, 2).requires_grad_(True)
    y = spmd.seq_gather_whole(x, group)
    y.backward(g_of(r, 4))
    ok["gather_whole"] = torch.equal(y.detach(), torch.cat(
        [x_of(q, 2) for q in range(n)], 1)) and torch.equal(
        x.grad, g_of(r, 4).chunk(n, 1)[r])
    return ok


def nudged(tree, gen):
    # every master moved by one float32 ulp times a random sign
    return {k: nudged(v, gen) if isinstance(v, dict) else v * (
        1 + FLOOR_ULP * (torch.randint(0, 2, v.shape, generator=gen) * 2
                         - 1)) for k, v in tree.items()}


def work(rank, world, store, out):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    from torch.distributed.device_mesh import DeviceMesh

    from repro_torch.configs import registry
    from repro_torch.models import params as pm
    from repro_torch.models.model import Model
    from repro_torch.sharding import spmd
    from repro_torch.sharding.plan import make_plan
    from repro_torch.train.optimizer import make_optimizer
    from repro_torch.train.step import make_train_step
    arrays = np.load(out + ".in.npz")
    gather = lambda tree: pm.tree_map(
        lambda x: spmd.full_tensor(x).numpy(), tree)
    meshes = {k: DeviceMesh("cpu", torch.arange(4).reshape(sizes),
                            mesh_dim_names=names)
              for k, (names, sizes) in MESHES.items()}
    res = {f"op/{k}": v for k, v in operators_check(
        spmd, meshes["d2m2"].get_group("model")).items()}

    def step_of(name, mesh_name, sp, hoist, key, full=None, update=True):
        cfg = cfg_of(registry, name)
        batch = {k: torch.from_numpy(arrays[k]) for k in batch_keys(cfg)}
        plan = make_plan(cfg, meshes[mesh_name], sequence_parallel=sp)
        model = Model(cfg, plan=plan, device="cpu")
        opt = make_optimizer(cfg)
        meta = model.param_meta()
        if full is None:
            full = from_npz(meta, case_arrays(out, name, mesh_name),
                            f"{name}/{mesh_name}/params")
        it = iter(pm.tree_leaves(plan.param_shardings(meta)))
        params = pm.tree_map(lambda t: spmd.place(t, next(it)), full)
        step = make_train_step(model, opt, n_accum=N_ACCUM,
                               hoist_gather=hoist)
        loss, metrics, grads = step.grads(params, batch)
        res[f"{key}/loss"] = float(loss)
        flatten(gather(grads), f"{key}/grads", res)
        if not update:
            return
        it = iter(pm.tree_leaves(plan.param_shardings(
            opt.state_meta(meta))))
        state = pm.tree_map(lambda t: spmd.place(t, next(it)),
                            opt.init(full))
        params, state, _ = step.update(params, state, loss, metrics,
                                       grads, 0)
        flatten(gather(params), f"{key}/params", res)
        flatten(gather(first_moments(state)), f"{key}/m", res)

    for name, mesh_name in CASES:
        for sp in (True, False):
            for hoist in (False, True):
                step_of(name, mesh_name, sp, hoist,
                        f"{name}/{mesh_name}/{int(sp)}{int(hoist)}")
        if name in RECURRENT:
            cfg = cfg_of(registry, name)
            full = from_npz(Model(cfg, device="cpu").param_meta(),
                            case_arrays(out, name, mesh_name),
                            f"{name}/{mesh_name}/params")
            step_of(name, mesh_name, False, False,
                    f"{name}/{mesh_name}/moved", full=nudged(
                        full, torch.Generator().manual_seed(1)),
                    update=False)
    # an S that does not split over the model axis
    cfg = cfg_of(registry, "llama")
    plan = make_plan(cfg, meshes["d2m2"], sequence_parallel=True)
    model = Model(cfg, plan=plan, device="cpu")
    meta = model.param_meta()
    full = from_npz(meta, case_arrays(out, "llama", "d2m2"),
                    "llama/d2m2/params")
    it = iter(pm.tree_leaves(plan.param_shardings(meta)))
    params = pm.tree_map(lambda t: spmd.place(t, next(it)), full)
    odd = {k: torch.from_numpy(arrays[k])[:, :31] for k in ("tokens",
                                                             "labels")}
    try:
        make_train_step(model, make_optimizer(cfg), n_accum=N_ACCUM).grads(
            params, odd)
        res["odd_error"] = ""
    except ValueError as e:
        res["odd_error"] = str(e)
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


out, part, parts = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
arrays = np.load(out + ".in.npz")
res = {}
for name, mesh_name in CASES[part::parts]:
    names, sizes = MESHES[mesh_name]
    mesh = Mesh(np.array(jax.devices()).reshape(sizes), names)
    with mesh:
        cfg = cfg_of(registry, name)
        plan = make_plan(cfg, mesh, sequence_parallel=True)
        model = Model(cfg, plan)
        opt = make_optimizer(cfg)
        meta = model.param_meta()
        params = unflatten(case_arrays(out, name, mesh_name),
                           f"{name}/{mesh_name}/params")
        if cfg.family == "hybrid" and "tail" not in params["blocks"]:
            params["blocks"]["tail"] = {}
        params = jax.device_put(params, plan.param_shardings(meta))
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
np.savez(f"{out}.ref{part}.npz", **res)
"""

ns = {}
exec(COMMON, ns)
CONFIGS, MESHES, CASES = ns["CONFIGS"], ns["MESHES"], ns["CASES"]
RECURRENT, batch_keys, flatten, case_path = (
    ns["RECURRENT"], ns["batch_keys"], ns["flatten"], ns["case_path"])
HOIST = (False, True)
REF_PARTS = 2  # reference subprocesses, each jitting every other case


def _open_gates(tree, rng):
    """The tree with each cross gate drawn in [0.3, 0.9): the init's zero
    gates shut the cross-attention (tanh(0) = 0), and with them the
    gate's own gradient, which sequence parallelism makes a partial sum."""
    if isinstance(tree, dict):
        return {k: rng.uniform(0.3, 0.9, np.shape(v)).astype(np.float32)
                if k == "gate" else _open_gates(v, rng)
                for k, v in tree.items()}
    return tree


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
    """Every rank's results and the reference's on its Auto meshes. Both
    subprocesses start once the batch is written; each case's weights
    follow, drawn here while they run the cases before it."""
    tmp = tmp_path_factory.mktemp("spmd_seq")
    rng = np.random.default_rng(17)
    toks = rng.integers(0, 256, (B, S + 1)).astype(np.int32)
    arrays = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    vcfg = jregistry.get("llama-3.2-vision-11b").reduced()
    wcfg = jregistry.get("whisper-small").reduced()
    arrays["image_embeds"] = (0.1 * rng.standard_normal(
        (B, vcfg.num_image_tokens, vcfg.d_model))).astype(np.float32)
    arrays["audio_frames"] = (0.1 * rng.standard_normal(
        (B, wcfg.encoder_frames, wcfg.d_model))).astype(np.float32)
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
    refs = [subprocess.Popen(
        [sys.executable, str(ref_py), out, str(k), str(REF_PARTS)],
        env=dict(os.environ, PYTHONPATH=src, JAX_PLATFORMS="cpu",
                 XLA_FLAGS="--xla_force_host_platform_device_count=4"),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for k in range(REF_PARTS)]
    try:
        for i, (name, mesh_name) in enumerate(CASES):
            arch, kw = CONFIGS[name]
            jcfg = jregistry.get(arch).reduced().replace(dtype="float32",
                                                         **kw)
            # the reference's plan of the run's mesh shape (padded heads,
            # replicated kv heads, the padded vocabulary)
            names, sizes = MESHES[mesh_name]
            fake = types.SimpleNamespace(axis_names=names,
                                         shape=dict(zip(names, sizes)))
            jm = JModel(jcfg, jplan.make_plan(jcfg, fake))
            weights = flatten(_open_gates(jax.device_get(
                jm.init(jax.random.PRNGKey(i))), rng),
                f"{name}/{mesh_name}/params", {})
            part = f"{out}.part.npz"
            np.savez(part, **weights)
            os.replace(part, case_path(out, name, mesh_name))
        _, w_err = world.communicate(timeout=400)
        r_errs = [ref.communicate(timeout=400)[1] for ref in refs]
    finally:
        for p in [world] + refs:
            p.kill()
    assert world.returncode == 0, w_err[-3000:]
    for ref, r_err in zip(refs, r_errs):
        assert ref.returncode == 0, r_err[-3000:]
    ranks = [dict(np.load(f"{out}.{r}.npz")) for r in range(4)]
    return ranks, {k: v for part in range(REF_PARTS)
                   for k, v in np.load(f"{out}.ref{part}.npz").items()}


def _dist(a, b) -> float:
    return float(np.abs(np.asarray(a, np.float64)
                        - np.asarray(b, np.float64)).max())


def _rel(a, b) -> float:
    """max |a - b| over the largest magnitude of b."""
    return _dist(a, b) / max(float(np.abs(b).max()), 1e-30)


def _leaves_close(got, got_prefix, want, want_prefix, bound=None):
    """Every leaf of ``got`` within ``bound(leaf key)`` (TOL without one)
    of the largest magnitude of ``want`` 's leaf, the two trees of the
    same keys."""
    keys = sorted(k[len(want_prefix):] for k in want
                  if k.startswith(want_prefix + "/"))
    assert keys and keys == sorted(k[len(got_prefix):] for k in got
                                   if k.startswith(got_prefix + "/"))
    for k in keys:
        rel = _rel(got[got_prefix + k], want[want_prefix + k])
        tol = TOL if bound is None else bound(k)
        assert rel <= tol, (k, rel, tol)


def _ulp_floor(ranks, name, mesh):
    """mamba2's and zamba2's bound (module docstring): REC_TOL plus
    FLOOR_FACTOR times the relative distance that a one-ulp move of the
    masters makes in the step's gradient, leaf by leaf (the first moments
    and the update follow the gradients leaf for leaf); None for the
    others."""
    if name not in RECURRENT:
        return None
    r0, base = ranks[0], f"{name}/{mesh}"
    return lambda k: REC_TOL + FLOOR_FACTOR * _rel(
        r0[f"{base}/moved/grads" + k], r0[f"{base}/00/grads" + k])


def _update_floor(ranks, ref, name, mesh, h):
    """AdamW's first step moves an element by about ``lr * g / (|g| +
    eps)``, so an element whose gradient is a thousandth of its leaf's
    largest takes that gradient's float32 rounding nearly whole into the
    update (``tests/test_torch_spmd_multimodal.py``, whisper's biases): the
    updated parameters are held within TOL beyond the distance between the
    port's step without the flag and the reference's step with it, two
    correct float32 steps, leaf by leaf."""
    base = f"{name}/{mesh}/0{h}/params"
    return lambda k: TOL + _rel(ranks[0][base + k],
                                ref[f"{name}/{mesh}/params" + k])


def _loss_close(got, want, name):
    tol = REC_TOL if name in RECURRENT else TOL
    assert abs(float(got) - float(want)) <= tol * abs(float(want))


def _ids(cases):
    return [f"{n}-{m}" for n, m in cases]


@pytest.mark.parametrize("hoist", HOIST, ids=["gather", "hoist_gather"])
@pytest.mark.parametrize("what", ["grads", "params", "m"])
@pytest.mark.parametrize("name,mesh", CASES, ids=_ids(CASES))
def test_sequence_parallel_equals_the_step_without_it(runs, name, mesh,
                                                      what, hoist):
    """The loss, every gradient, AdamW's updated parameters and first
    moments of the step with the flag equal the port's step without it on
    the same mesh, weights and batch."""
    ranks, _ = runs
    h = int(hoist)
    got, want = f"{name}/{mesh}/1{h}", f"{name}/{mesh}/0{h}"
    _leaves_close(ranks[0], f"{got}/{what}", ranks[0], f"{want}/{what}",
                  _ulp_floor(ranks, name, mesh))
    _loss_close(ranks[0][f"{got}/loss"], ranks[0][f"{want}/loss"], name)


@pytest.mark.parametrize("hoist", HOIST, ids=["gather", "hoist_gather"])
@pytest.mark.parametrize("what", ["grads", "params", "m"])
@pytest.mark.parametrize("name,mesh", CASES, ids=_ids(CASES))
def test_sequence_parallel_equals_reference(runs, name, mesh, what, hoist):
    """... and the reference's sharded step with ``sequence_parallel=True``
    on an Auto mesh of the same shape."""
    ranks, ref = runs
    h = int(hoist)
    got = f"{name}/{mesh}/1{h}"
    bound = _ulp_floor(ranks, name, mesh)
    if bound is None and what == "params":
        bound = _update_floor(ranks, ref, name, mesh, h)
    _leaves_close(ranks[0], f"{got}/{what}", ref, f"{name}/{mesh}/{what}",
                  bound)
    _loss_close(ranks[0][f"{got}/loss"], ref[f"{name}/{mesh}/loss"], name)


def test_every_rank_holds_the_same_step(runs):
    """Every rank's gathered gradients, parameters and moments are rank
    0's, bit for bit."""
    ranks, _ = runs
    for r in ranks[1:]:
        for k in ranks[0]:
            if "/grads/" in k or "/params/" in k or "/m/" in k:
                np.testing.assert_array_equal(r[k], ranks[0][k])


def test_the_gate_takes_a_gradient(runs):
    """The cross gates (vlm's cross block, whisper's decoder) are open and
    take a gradient, summed over the model axis under the flag."""
    ranks, ref = runs
    n = 0
    for name in ("vlm", "whisper"):
        prefix = f"{name}/d2m2/10/grads/"
        for k in ranks[0]:
            if k.startswith(prefix) and k.endswith("/gate"):
                w = ref[f"{name}/d2m2/grads/" + k[len(prefix):]]
                assert np.abs(w).min() > 0
                assert _rel(ranks[0][k], w) <= TOL, k
                n += 1
    assert n == 2


@pytest.mark.parametrize("op", ["gather", "scatter", "gather_whole"])
def test_sequence_operators(runs, op):
    """``seq_gather``: all-gather along dim 1 forward, reduce-scatter
    backward; ``seq_scatter``: reduce-scatter forward, all-gather
    backward; ``seq_gather_whole``: all-gather forward, this rank's chunk
    of its own gradient backward. Exact, on every rank."""
    ranks, _ = runs
    assert all(bool(r[f"op/{op}"]) for r in ranks)


def test_uneven_sequence_raises(runs):
    """S 31 over a model axis of 2: the step raises ``ValueError`` naming
    S and tp, on every rank."""
    ranks, _ = runs
    for r in ranks:
        msg = str(r["odd_error"])
        assert "S = 31" in msg and "tp = 2" in msg, msg


def test_meta_group_operators_give_shapes():
    """On meta tensors inside a region of ``MetaGroup`` s (the dry run) a
    gather multiplies dim 1 by the group's size and a scatter divides it;
    an uneven split raises there too."""
    x = torch.empty(2, 8, 4, device="meta")
    g = spmd.MetaGroup(4)
    assert spmd.seq_gather(x, g).shape == (2, 32, 4)
    assert spmd.seq_gather_whole(x, g).shape == (2, 32, 4)
    assert spmd.seq_scatter(x, g).shape == (2, 2, 4)
    with spmd.region(g, spmd.MetaGroup(2), seq=True):
        assert spmd.enter_seq(x).shape == (2, 32, 4)
        assert spmd.leave_seq(x).shape == (2, 2, 4)
        assert spmd.size("model") == 4 and spmd.size("data") == 2
        with spmd.no_sequence_split():
            assert spmd.enter_seq(x).shape == (2, 8, 4)
        with pytest.raises(ValueError, match="S = 6 .* tp = 4"):
            spmd.leave_seq(torch.empty(2, 6, 4, device="meta"))
    assert spmd.REGION is None

"""The port's SPMD tier against the JAX package: the sharding plan
(``repro_torch.sharding.plan``), the padded models it sizes, the meshes
(``launch/mesh``), the checkpoint's rescale onto a rebuilt mesh
(``ft/elastic``) and the GPipe pipeline over a process group
(``sharding/pipeline``).

- **Plan.** For every arch of the registry on the shape-only meshes
  ``{data 16, model 16}``, ``{pod 2, data 16, model 16}`` and
  ``{data 4, model 2}``, ``make_plan``'s fields equal the reference's, and
  so do ``param_spec`` and ``zero_spec`` of every leaf of
  ``Model(cfg, plan=...).param_meta()`` and every cache spec, as tuples.
  ``tests/test_sharding_plan.py:33-88`` is mirrored on the port.
- **Padded models.** Reduced llama3.2-1b (2 KV heads repeated to 4) and a
  reduced whisper-small with 6 heads (padded to 8, as 12 are to 16 at full
  width) at a ``{data 2, model 4}`` plan: ``apply``, ``prefill`` and a
  decode step equal the reference's padded model (its plan with
  ``mesh=None``, so that its ``act`` is the identity while the padded
  dims stay) within 1e-5, the float32 bound of ``test_torch_models.py``.
- **Rescale.** The reference's ``CheckpointManager`` writes a reduced
  llama checkpoint; the port's ``rescale`` restores it under a world-1
  gloo group on the CPU, every leaf a ``DTensor`` equal bit for bit to the
  saved array, with the plan of the reference's ``rebuild(cfg, 1)``.
- **Pipeline.** One subprocess spawns a 4-rank gloo world on the CPU (a
  ``FileStore`` under ``tmp_path``: no TCP port) and runs the reference
  test's stage ``tanh(x @ w + b)`` (D 16, B 8) for M in (2, 4, 8): the
  output equals the port's sequential composition over the same
  microbatches bit for bit, and the same four stages composed in JAX here
  within 1e-5.
"""
import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.manager import CheckpointManager as JCheckpointManager
from repro.configs import registry as jregistry
from repro.ft import elastic as jelastic
from repro.launch import mesh as jmesh
from repro.models import params as jpm
from repro.models.model import Model as JModel
from repro.sharding import plan as jplan
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs import registry
from repro_torch.ft import elastic
from repro_torch.launch import mesh as tmesh
from repro_torch.models import params as pm
from repro_torch.models.model import Model
from repro_torch.sharding import plan as tplan

MESHES = [{"data": 16, "model": 16}, {"pod": 2, "data": 16, "model": 16},
          {"data": 4, "model": 2}]
FIELDS = ("tp", "dp_axes", "tp_axis", "expert_mode", "num_heads",
          "num_kv_heads", "kv_repeat", "vocab", "sequence_parallel",
          "zero_opt", "fsdp", "replicate_batch", "rules", "batch_axes")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Many small ops: with several test processes sharing the cores, torch
    runs these on one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class FakeMesh:
    """Just enough of a mesh for plan arithmetic (the reference test's)."""

    def __init__(self, shape):
        self.shape = dict(shape)
        self.axis_names = tuple(shape)


def _tuples(tree):
    """A dict tree of specs (the reference's ``PartitionSpec`` or the port's
    ``Spec``) or of anything else, with every spec as a plain tuple."""
    if isinstance(tree, dict):
        return {k: _tuples(v) for k, v in tree.items()}
    return tuple(tree)


def _leaf_specs(meta, plan, zero_spec, is_leaf):
    out = []

    def walk(t, path=()):
        if isinstance(t, dict):
            for k in sorted(t):
                walk(t[k], path + (k,))
        else:
            assert is_leaf(t), path
            out.append((path, tuple(t.shape), tuple(plan.param_spec(t)),
                        tuple(zero_spec(t, plan))))
    walk(meta)
    return out


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: "x".join(
    f"{k}{v}" for k, v in s.items()))
@pytest.mark.parametrize("arch", sorted(registry.ARCHS))
def test_plan_equals_reference(arch, shape):
    jcfg, cfg = jregistry.get(arch), registry.get(arch)
    want = jplan.make_plan(jcfg, FakeMesh(shape))
    got = tplan.make_plan(cfg, FakeMesh(shape))
    for f in FIELDS:
        assert getattr(got, f) == getattr(want, f), f
    jm, tm = JModel(jcfg, want), Model(cfg, plan=got, device="cpu")
    assert _leaf_specs(tm.param_meta(), got, tplan.zero_spec,
                       lambda m: isinstance(m, pm.ParamMeta)) == \
        _leaf_specs(jm.param_meta(), want, jplan.zero_spec, jpm.is_meta)
    assert _tuples(tm.cache_specs()) == _tuples(jm.cache_specs())
    assert _tuples(tm.cache_specs("data")) == _tuples(jm.cache_specs("data"))
    # the same plan from the production mesh's shape
    if shape in MESHES[:2]:
        prod = tmesh.make_production_mesh(multi_pod="pod" in shape)
        assert tplan.make_plan(cfg, prod) == dataclasses.replace(
            got, mesh=prod)


# --- tests/test_sharding_plan.py:33-88, on the port ---------------------------

def _mk_plan(cfg, pod=False):
    return tplan.make_plan(cfg, FakeMesh(MESHES[int(pod)]))


@pytest.mark.parametrize("arch", sorted(registry.ARCHS))
def test_dims_divisible_by_tp(arch):
    cfg = registry.get(arch)
    plan = _mk_plan(cfg)
    assert plan.vocab % plan.tp == 0 and plan.vocab >= cfg.vocab_size
    if cfg.num_heads:
        assert plan.num_heads % plan.tp == 0
        assert plan.num_kv_heads % plan.tp == 0
        assert plan.num_heads >= cfg.num_heads
    if cfg.is_moe:
        if cfg.num_experts % plan.tp == 0:
            assert plan.expert_mode == "ep"
        else:
            assert plan.expert_mode == "tp"
            assert cfg.moe_d_ff % plan.tp == 0


def test_kv_repeat_rules():
    plan = _mk_plan(registry.get("llama3.2-1b"))  # GQA kv 8, tp 16
    assert plan.num_kv_heads == 16 and plan.kv_repeat == 2
    plan = _mk_plan(registry.get("whisper-small"))  # 12 heads -> 16
    assert plan.num_heads == 16 and plan.num_kv_heads == 16


@pytest.mark.parametrize("arch", ["deepseek-67b", "deepseek-v2-236b",
                                  "whisper-small"])
@pytest.mark.parametrize("pod", [False, True])
def test_param_specs_shard_consistently(arch, pod):
    cfg = registry.get(arch)
    plan = _mk_plan(cfg, pod)
    sizes = {"pod": 2, "data": 16, "model": 16}

    def check(m):
        spec = plan.param_spec(m)
        assert isinstance(spec, tplan.Spec) and len(spec) == len(m.shape)
        for dim, ax in zip(m.shape, spec):
            if ax is None:
                continue
            axes = ax if isinstance(ax, tuple) else (ax,)
            assert dim % int(np.prod([sizes[a] for a in axes])) == 0

    pm.tree_map(check, Model(cfg, plan=plan, device="cpu").param_meta())


def test_fsdp_shards_large_params_over_dp():
    cfg = registry.get("deepseek-67b")
    plan = _mk_plan(cfg)
    meta = Model(cfg, plan=plan, device="cpu").param_meta()
    spec = plan.param_spec(meta["embed"]["embedding"])
    assert spec[0] == "model" and spec[1] in ("data", ("data",))
    assert plan.act(meta, "batch") is meta  # no sharding hint in PyTorch


# --- padded models --------------------------------------------------------------

PADDED = {
    # 2 KV heads repeated to 4 at tp 4
    "llama3.2-1b": {},
    # 6 heads padded to 8 at tp 4 (whisper-small's 12 go to 16 at tp 16)
    "whisper-small": {"num_heads": 6, "num_kv_heads": 6},
}
B, S = 2, 12


@pytest.fixture(scope="module", params=sorted(PADDED))
def padded(request):
    arch = request.param
    kw = dict(dtype="float32", param_dtype="float32", **PADDED[arch])
    jcfg = jregistry.get(arch).reduced().replace(**kw)
    cfg = registry.get(arch).reduced().replace(**kw)
    shape = FakeMesh({"data": 2, "model": 4})
    jp_, tp_ = jplan.make_plan(jcfg, shape), tplan.make_plan(cfg, shape)
    jm = JModel(jcfg, dataclasses.replace(jp_, mesh=None))
    params = jm.init(jax.random.PRNGKey(3))
    model = Model(cfg, plan=tp_, device="cpu").load_reference(
        jax.device_get(params))
    rng = np.random.default_rng(4)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(
        np.int32)}
    if cfg.family == "audio":
        batch["audio_frames"] = (0.1 * rng.standard_normal(
            (B, cfg.encoder_frames, cfg.d_model))).astype(np.float32)
    return cfg, tp_, jm, params, model, batch


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=1e-5, atol=1e-5)


def test_padded_dims(padded):
    cfg, plan, jm, params, model, _ = padded
    assert plan.tp == 4 and plan.num_heads % 4 == 0
    assert plan.num_kv_heads % 4 == 0
    assert plan.num_kv_heads > cfg.num_kv_heads
    want = jax.tree_util.tree_map(lambda a: tuple(a.shape), params)
    got = pm.tree_map(lambda t: tuple(t.shape), model.weights())
    assert got == pm.tree_map(lambda s: s, want)
    jc = jax.tree_util.tree_map(lambda a: tuple(a.shape),
                                jm.cache(B, 16, abstract=True))
    assert pm.tree_map(lambda t: tuple(t.shape), model.cache(B, 16)) == \
        pm.tree_map(lambda s: s, jc)


def test_padded_apply(padded):
    _, _, jm, params, model, batch = padded
    _close(model.apply(batch)[0].numpy(), jm.apply(params, batch)[0])


def test_padded_prefill_and_decode(padded):
    _, _, jm, params, model, batch = padded
    pre = dict(batch, tokens=batch["tokens"][:, :S - 1])
    jl, jc = jm.prefill(params, pre, max_len=16)
    tl, tc = model.prefill(pre, max_len=16)
    _close(tl.numpy(), jl)
    tok = batch["tokens"][:, S - 1:]
    jl, _ = jm.decode(params, jnp.asarray(tok), jc, S - 1)
    tl, _ = model.decode(tok, tc, S - 1)
    _close(tl.numpy(), jl)


# --- meshes and the rescale ---------------------------------------------------

class _JaxShaped:
    """What the reference's ``from_mesh`` reads of a jax mesh."""

    def __init__(self, shape):
        self.devices = np.empty(shape)


@pytest.mark.parametrize("multi_pod", [False, True])
def test_production_mesh_and_topology(multi_pod):
    mesh = tmesh.make_production_mesh(multi_pod=multi_pod)
    sizes = (2, 16, 16) if multi_pod else (16, 16)
    assert mesh.sizes == sizes and mesh.size == int(np.prod(sizes))
    assert mesh.axis_names == (("pod",) if multi_pod else ()) + ("data",
                                                                 "model")
    got = tmesh.PodTopology.from_mesh(mesh)
    want = jmesh.PodTopology.from_mesh(_JaxShaped(sizes))
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


@pytest.fixture
def world1(tmp_path):
    """A world-1 gloo group on the CPU (a FileStore: no port)."""
    import torch.distributed as dist
    dist.init_process_group("gloo", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()


def test_host_mesh_and_rescale(world1, tmp_path):
    from torch.distributed.tensor import DTensor
    kw = dict(dtype="float32")
    jcfg = jregistry.get("llama3.2-1b").reduced().replace(**kw)
    cfg = registry.get("llama3.2-1b").reduced().replace(**kw)
    params = jax.device_get(JModel(jcfg).init(jax.random.PRNGKey(5)))
    JCheckpointManager(str(tmp_path / "ckpt"), async_save=False).save(
        7, params)
    host = tmesh.make_host_mesh(device="cpu")
    assert host.mesh_dim_names == ("data", "model")
    assert tuple(host.shape) == (1, 1)
    assert dataclasses.asdict(tmesh.PodTopology.from_mesh(host)) == \
        dataclasses.asdict(jmesh.PodTopology.from_mesh(jmesh.make_host_mesh()))
    mesh, plan, got, step = elastic.rescale(
        cfg, CheckpointManager(str(tmp_path / "ckpt")),
        Model(cfg, device="cpu"), 1, device="cpu")
    assert step == 7 and tuple(mesh.shape) == (1, 1)
    _, want_plan = jelastic.rebuild(jcfg, 1)
    for f in FIELDS:
        assert getattr(plan, f) == getattr(want_plan, f), f
    shardings = plan.param_shardings(Model(cfg, device="cpu").param_meta())
    n = 0

    def check(path, leaf, want, sh):
        nonlocal n
        assert isinstance(leaf, DTensor), path
        assert tuple(leaf.placements) == sh.placements, path
        assert torch.equal(leaf.full_tensor(), torch.from_numpy(
            np.array(want))), path
        n += 1

    from repro_torch.serve.cache import tree_map
    tree_map(check, got, params, shardings)
    assert n == len(jax.tree_util.tree_leaves(params))


RESCALE2 = r"""
import json
import sys

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def work(rank, world, store, ckpt, out):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    from torch.distributed.tensor import distribute_tensor
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.configs import registry
    from repro_torch.ft import elastic
    from repro_torch.models import params as pm
    from repro_torch.models.model import Model
    cfg = registry.get("llama3.2-1b").reduced().replace(dtype="float32")
    res = {}
    for prefer_model in (1, 2):
        mesh, plan, got, step = elastic.rescale(
            cfg, CheckpointManager(ckpt), Model(cfg, device="cpu"), world,
            prefer_model=prefer_model, device="cpu")
        rows, fulls = [], []
        for leaf in pm.tree_leaves(got):
            full = leaf.full_tensor()
            want = distribute_tensor(full, mesh, leaf.placements,
                                     src_data_rank=None).to_local()
            local = leaf.to_local()
            rows.append({"local": list(local.shape),
                         "global": list(full.shape),
                         "same": torch.equal(local, want),
                         "alone": local.untyped_storage().nbytes()
                         == local.numel() * local.element_size()})
            fulls.append(full.numpy())
        res[prefer_model] = {"mesh": list(mesh.shape), "step": step,
                             "rows": rows}
        np.savez(f"{out}.{rank}.{prefer_model}.npz", *fulls)
    with open(f"{out}.{rank}.json", "w") as f:
        json.dump(res, f)
    dist.destroy_process_group()


if __name__ == "__main__":
    store, ckpt, out = sys.argv[1:]
    mp.spawn(work, args=(2, store, ckpt, out), nprocs=2)
"""


def test_rescale_keeps_only_this_ranks_shard(tmp_path):
    """``rescale`` over a 2-rank gloo world on the CPU, on the (2, 1) and
    (1, 2) meshes: each rank's local shard has the shape and the values
    that ``distribute_tensor`` gives it, in a storage of its own size (no
    view of the whole leaf), some leaves really split, and the gathered
    leaves equal the reference's saved arrays bit for bit."""
    import json
    jcfg = jregistry.get("llama3.2-1b").reduced().replace(dtype="float32")
    params = jax.device_get(JModel(jcfg).init(jax.random.PRNGKey(5)))
    ckpt = str(tmp_path / "ckpt")
    JCheckpointManager(ckpt, async_save=False).save(3, params)
    env = dict(os.environ, PYTHONPATH=os.path.join(
        os.path.dirname(__file__), "..", "src"))
    script = tmp_path / "rescale_run.py"  # spawn re-imports it by path
    script.write_text(RESCALE2)
    out = str(tmp_path / "rescale")
    run = subprocess.run([sys.executable, str(script),
                          str(tmp_path / "store"), ckpt, out], env=env,
                         capture_output=True, text=True, timeout=60)
    assert run.returncode == 0, run.stderr[-2000:]
    res = [json.loads(open(f"{out}.{r}.json").read()) for r in range(2)]
    saved = jax.tree_util.tree_leaves(params)
    shapes = [np.shape(a) for a in saved]
    for prefer_model, mesh in (("1", [2, 1]), ("2", [1, 2])):
        split = 0
        for r in range(2):
            got = res[r][prefer_model]
            assert got["mesh"] == mesh and got["step"] == 3
            assert [tuple(row["global"]) for row in got["rows"]] == shapes
            for row in got["rows"]:
                assert row["same"] and row["alone"], (prefer_model, r, row)
                split += row["local"] != row["global"]
            fulls = np.load(f"{out}.{r}.{prefer_model}.npz")
            for i, want in enumerate(saved):
                np.testing.assert_array_equal(fulls[f"arr_{i}"],
                                              np.asarray(want))
        assert split > 0, prefer_model


# --- the pipeline ---------------------------------------------------------------

PIPELINE = r"""
import sys
import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def work(rank, world, store, out):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    from repro_torch.sharding.pipeline import pipeline_apply
    arrays = np.load(out + ".in.npz")
    ws, bs, x = (torch.from_numpy(arrays[k]) for k in ("ws", "bs", "x"))
    stage = lambda p, h: torch.tanh(h @ p["w"] + p["b"])
    res = {}
    for M in (2, 4, 8):
        got = pipeline_apply(stage, {"w": ws[rank], "b": bs[rank]}, x,
                             dist.group.WORLD, M)
        seq = []
        for mb in x.reshape(M, -1, x.shape[1]):
            for i in range(world):
                mb = stage({"w": ws[i], "b": bs[i]}, mb)
            seq.append(mb)
        res[f"got{M}"] = got.numpy()
        res[f"seq{M}"] = torch.cat(seq).numpy()
    np.savez(f"{out}.{rank}.npz", **res)
    dist.destroy_process_group()


if __name__ == "__main__":
    store, out = sys.argv[1:]
    mp.spawn(work, args=(4, store, out), nprocs=4)
"""


def test_gpipe_schedule_matches_sequential(tmp_path):
    P, D = 4, 16
    rng = np.random.default_rng(0)
    ws = (rng.standard_normal((P, D, D)) * (0.5 / np.sqrt(D))).astype(
        np.float32)
    bs = (rng.standard_normal((P, D)) * 0.1).astype(np.float32)
    x = rng.standard_normal((8, D)).astype(np.float32)
    out = str(tmp_path / "pipe")
    np.savez(out + ".in.npz", ws=ws, bs=bs, x=x)
    env = dict(os.environ, PYTHONPATH=os.path.join(
        os.path.dirname(__file__), "..", "src"))
    script = tmp_path / "pipeline_run.py"  # spawn re-imports it by path
    script.write_text(PIPELINE)
    run = subprocess.run([sys.executable, str(script),
                          str(tmp_path / "store"), out], env=env,
                         capture_output=True, text=True, timeout=60)
    assert run.returncode == 0, run.stderr[-2000:]
    ref = jnp.asarray(x)
    for i in range(P):
        ref = jnp.tanh(ref @ ws[i] + bs[i])
    for rank in range(P):
        res = np.load(f"{out}.{rank}.npz")
        for M in (2, 4, 8):
            got = res[f"got{M}"]
            np.testing.assert_array_equal(got, res[f"seq{M}"])
            assert float(np.abs(got - np.asarray(ref)).max()) < 1e-5, M

"""The port's dry run (``launch/inputs.py``, ``launch/dryrun.py``) and the
kernels' meta branches against the JAX package.

- **Inputs.** For every (arch, shape) cell on the production mesh's plan,
  the port's stand-ins (meta tensors) have the shapes and dtypes of the
  reference's ``ShapeDtypeStruct`` s, and their specs equal the
  reference's as tuples: train and prefill batches with the vlm and audio
  extras, and the decode cache, tokens and position (the cache sequence
  sharded over ``data`` where the batch does not divide the data axes).
- **Microbatches.** ``choose_n_accum`` equals the reference's for every
  cell on both production meshes.
- **Bytes per rank.** ``argument_bytes_per_device`` equals, for all 32
  cells on both production meshes, the shard bytes summed from the
  reference's own metas and specs (``ParamMeta`` trees, its optimizer's
  state metas, its input specs), each sharded dimension divided by its
  axes' sizes and rounded up.
- **XLA's count.** One subprocess with 8 forced CPU devices lowers and
  compiles the reference's ``lower_cell`` on a hand-built ``Mesh`` of
  ``{data 4, model 2}`` (``jax.sharding.Mesh``, Auto axes: the reference's
  own ``make_production_mesh`` takes ``jax.make_mesh``, whose Explicit axes
  its ``with_sharding_constraint`` refuses in this JAX, ROADMAP queue 3)
  for reduced llama3.2-1b train (B 8, S 64), prefill and decode and a
  reduced mixtral train cell: ``memory_analysis().argument_size_in_bytes``
  equals the port's count exactly, and ``output_size_in_bytes`` is within
  1 % above the port's output count.
- **Meta branches.** On meta tensors the flash and scan wrappers return
  their plain versions' shapes and dtypes and launch nothing.
- **Meta runs.** One cell of each family runs its step on meta tensors.
  A train cell runs at one device's shapes (its shard of each weight,
  inside a region of shape-only groups): its ``flops_model`` equals a
  count worked out from a reduced config's shapes, and under sequence
  parallelism (``--sequence-parallel``, ``REPRO_SP=1``) the train cells
  run, ok, with the bytes of the cells without it.
"""
import dataclasses
import math
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from repro.configs import registry as jregistry
from repro.launch import inputs as jI
from repro.models import params as jpm
from repro.models.model import Model as JModel
from repro.sharding import plan as jplan
from repro.train.optimizer import make_optimizer as jmake_optimizer
from repro_torch.configs import registry
from repro_torch.configs.base import ShapeSpec
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import mamba_scan as MS
from repro_torch.launch import dryrun as D
from repro_torch.launch import inputs as I
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models.model import Model
from repro_torch.sharding.plan import make_plan

CELLS = sorted(registry.all_cells())
MESHES = {"pod": {"data": 16, "model": 16},
          "multipod": {"pod": 2, "data": 16, "model": 16}}


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
    """A dict tree of specs (``PartitionSpec`` s or ``Spec`` s) with every
    spec as a plain tuple."""
    if isinstance(tree, dict):
        return {k: _tuples(v) for k, v in tree.items()}
    return tuple(tree)


def _layout(tree):
    """A tree of stand-ins as (shape, dtype name) leaves."""
    if isinstance(tree, dict):
        return {k: _layout(v) for k, v in tree.items()}
    return tuple(tree.shape), str(tree.dtype).replace("torch.", "")


def _cell(arch, shape_name, mesh_kind="pod"):
    jcfg, cfg = jregistry.get(arch), registry.get(arch)
    shape = registry.get_shape(shape_name)
    return jcfg, cfg, shape, FakeMesh(MESHES[mesh_kind])


def _serve(cfg):
    return cfg.replace(param_dtype="bfloat16")


def _dp(mesh):
    return math.prod(mesh.shape.get(a, 1) for a in ("pod", "data"))


def _decode_plans(jcfg, cfg, shape, mesh):
    rep = shape.global_batch % _dp(mesh) != 0
    jp = jplan.make_plan(_serve(jcfg), mesh, replicate_batch=rep)
    tp = make_plan(_serve(cfg), mesh, replicate_batch=rep)
    return jp, tp, ("data" if rep else None)


@pytest.mark.parametrize("arch,shape_name", CELLS)
def test_inputs_equal_reference(arch, shape_name):
    jcfg, cfg, shape, mesh = _cell(arch, shape_name)
    if shape.kind == "decode":
        jp, tp, seq = _decode_plans(jcfg, cfg, shape, mesh)
        jm, tm = JModel(_serve(jcfg), jp), Model(_serve(cfg), plan=tp,
                                                device="meta")
        want = jI.decode_input_specs(_serve(jcfg), shape, jm)
        got = I.decode_input_specs(_serve(cfg), shape, tm)
        for g, w in zip(got, want):
            assert _layout(g) == _layout(w)
        wsh = jI.decode_input_shardings(_serve(jcfg), jp, jm, seq_axis=seq)
        gsh = I.decode_input_shardings(_serve(cfg), tp, tm, seq_axis=seq)
        for g, w in zip(gsh, wsh):
            assert _tuples(g) == _tuples(w)
        return
    jp, tp = jplan.make_plan(jcfg, mesh), make_plan(cfg, mesh)
    fn = {"train": (jI.train_input_specs, I.train_input_specs,
                    jI.train_input_shardings, I.train_input_shardings),
          "prefill": (jI.prefill_input_specs, I.prefill_input_specs,
                      jI.prefill_input_shardings, I.prefill_input_shardings)
          }[shape.kind]
    got, want = fn[1](cfg, shape), fn[0](jcfg, shape)
    assert _layout(got) == _layout(want)
    assert all(t.device.type == "meta" for t in got.values())
    assert _tuples(fn[3](cfg, tp)) == _tuples(fn[2](jcfg, jp))


@pytest.mark.parametrize("mesh_kind", sorted(MESHES))
def test_choose_n_accum_equals_reference(mesh_kind):
    from repro.launch.dryrun import choose_n_accum as jchoose
    dp = _dp(FakeMesh(MESHES[mesh_kind]))
    for arch, shape_name in CELLS:
        cfg, shape = registry.get(arch), registry.get_shape(shape_name)
        assert D.choose_n_accum(cfg, shape, dp) == jchoose(
            jregistry.get(arch), shape, dp), (arch, shape_name)
    assert D.dp_size(make_production_mesh(
        multi_pod=mesh_kind == "multipod")) == dp


# --- bytes per rank from the reference's own metas and specs --------------------

def _jbytes(tree, specs, sizes):
    """One rank's bytes of a tree of ``ShapeDtypeStruct`` s under a tree of
    ``PartitionSpec`` s."""
    from jax.sharding import PartitionSpec as P
    leaves = jax.tree_util.tree_leaves(tree)
    spec_leaves = jax.tree_util.tree_leaves(
        specs, is_leaf=lambda x: isinstance(x, P))
    assert len(leaves) == len(spec_leaves)
    total = 0
    for a, s in zip(leaves, spec_leaves):
        n = np.dtype(a.dtype).itemsize
        for i, dim in enumerate(a.shape):
            entry = s[i] if i < len(s) else None
            axes = () if entry is None else (
                entry if isinstance(entry, tuple) else (entry,))
            n *= -(-dim // math.prod(sizes[x] for x in axes))
        total += n
    return total


def _reference_argument_bytes(arch, shape_name, mesh):
    """The reference's ``lower_cell`` inputs, counted from its metas and
    specs (its three branches, as written in ``repro/launch/dryrun.py``)."""
    from jax.sharding import PartitionSpec as P
    jcfg, shape = jregistry.get(arch), registry.get_shape(shape_name)
    sizes = mesh.shape
    if shape.kind == "train":
        plan = jplan.make_plan(jcfg, mesh)
        meta = JModel(jcfg, plan).param_meta()
        opt = jmake_optimizer(jcfg)
        trees = (jpm.abstract(meta, jcfg.param_dtype),
                 jpm.abstract(opt.state_meta(meta)),
                 jI.train_input_specs(jcfg, shape),
                 jax.ShapeDtypeStruct((), np.int32))
        specs = (plan.param_specs(meta), plan.param_specs(
            opt.state_meta(meta)), jI.train_input_shardings(jcfg, plan), P())
    elif shape.kind == "prefill":
        plan = jplan.make_plan(_serve(jcfg), mesh)
        meta = JModel(_serve(jcfg), plan).param_meta()
        trees = (jpm.abstract(meta, "bfloat16"),
                 jI.prefill_input_specs(_serve(jcfg), shape))
        specs = (plan.param_specs(meta),
                 jI.prefill_input_shardings(_serve(jcfg), plan))
    else:
        plan, _, seq = _decode_plans(jcfg, registry.get(arch), shape, mesh)
        jm = JModel(_serve(jcfg), plan)
        meta = jm.param_meta()
        trees = (jpm.abstract(meta, "bfloat16"),
                 *jI.decode_input_specs(_serve(jcfg), shape, jm))
        specs = (plan.param_specs(meta),
                 *jI.decode_input_shardings(_serve(jcfg), plan, jm,
                                            seq_axis=seq))
    return sum(_jbytes(t, s, sizes) for t, s in zip(trees, specs))


@pytest.mark.parametrize("mesh_kind", sorted(MESHES))
@pytest.mark.parametrize("arch,shape_name", CELLS)
def test_argument_bytes_equal_reference_specs(arch, shape_name, mesh_kind):
    mesh = make_production_mesh(multi_pod=mesh_kind == "multipod")
    low = D.lower_cell(arch, shape_name, mesh)
    assert low.argument_bytes() == _reference_argument_bytes(
        arch, shape_name, FakeMesh(MESHES[mesh_kind]))
    assert low.output_bytes() > 0


# --- XLA's own count on an Auto mesh of 8 CPU devices ----------------------------

SHAPES = {"train": ShapeSpec("train_small", 64, 8, "train"),
          "prefill": ShapeSpec("prefill_small", 64, 8, "prefill"),
          "decode": ShapeSpec("decode_small", 64, 8, "decode")}
XLA_CELLS = [("llama3.2-1b", "train"), ("llama3.2-1b", "prefill"),
             ("llama3.2-1b", "decode"), ("mixtral-8x7b", "train")]

XLA_RUN = r"""
import os, sys, json
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax
import numpy as np
assert len(jax.devices()) == 8  # before the dry run's module asks for 512
from jax.sharding import Mesh
from repro.configs import registry
from repro.configs.base import ShapeSpec
import repro.launch.dryrun as D

shapes = {k: ShapeSpec(*v) for k, v in json.loads(sys.argv[1]).items()}
cells = json.loads(sys.argv[2])


class Registry:
    get = staticmethod(lambda arch: registry.get(arch).reduced())
    get_shape = staticmethod(lambda name: shapes[name])


D.registry = Registry
mesh = Mesh(np.array(jax.devices()).reshape(4, 2), ("data", "model"))
out = {}
for arch, kind in cells:
    lowered, info = D.lower_cell(arch, kind, mesh)
    mem = lowered.compile().memory_analysis()
    out[f"{arch}/{kind}"] = [mem.argument_size_in_bytes,
                             mem.output_size_in_bytes]
print("XLA_COUNTS", json.dumps(out))
"""


def test_argument_bytes_equal_xla_on_auto_mesh():
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=os.path.join(
        os.path.dirname(__file__), "..", "src"))
    shapes = {k: dataclasses.astuple(v) for k, v in SHAPES.items()}
    import json
    run = subprocess.run(
        [sys.executable, "-c", XLA_RUN, json.dumps(shapes),
         json.dumps(XLA_CELLS)], env=env, capture_output=True, text=True,
        timeout=180)
    line = [s for s in run.stdout.splitlines() if s.startswith("XLA_COUNTS")]
    assert line, run.stderr[-3000:]
    xla = json.loads(line[0].split(" ", 1)[1])
    mesh = FakeMesh({"data": 4, "model": 2})
    for arch, kind in XLA_CELLS:
        low = D.lower_cell(registry.get(arch).reduced(), SHAPES[kind], mesh)
        args, outs = xla[f"{arch}/{kind}"]
        assert low.argument_bytes() == args, (arch, kind)
        # the outputs: XLA's own layout of the logits and its buffers'
        # sizes put its figure a few hundred bytes above the count
        assert 0 <= outs - low.output_bytes() <= 0.01 * outs, (arch, kind)
    # the reference's probe figures: train 137156, prefill 23200
    assert xla["llama3.2-1b/train"][0] == 137156
    assert xla["llama3.2-1b/prefill"][0] == 23200


# --- the kernels' meta branches ---------------------------------------------------

@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_meta_branch_has_the_plain_layout(dtype, causal):
    g = torch.Generator().manual_seed(0)
    q = torch.randn((2, 24, 4, 32), generator=g).to(dtype)
    k = torch.randn((2, 40, 2, 32), generator=g).to(dtype)
    v = torch.randn((2, 40, 2, 32), generator=g).to(dtype)
    want = FA.flash_attention_ref(q, k, v, causal=causal)
    before = FA.flash_attention.launches
    got = FA.flash_attention(*(t.to("meta") for t in (q, k, v)),
                             causal=causal)
    assert got.device.type == "meta" and FA.flash_attention.launches == before
    assert (tuple(got.shape), got.dtype) == (tuple(want.shape), want.dtype)
    with pytest.raises(ValueError, match="head_dim"):
        FA.flash_attention(*(t[..., :24].contiguous().to("meta")
                             for t in (q, k, v)))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_scan_meta_branch_has_the_plain_layout(dtype):
    g = torch.Generator().manual_seed(1)
    b, S, H, P, G, N = 2, 64, 4, 16, 2, 32
    xh = torch.randn((b, S, H, P), generator=g).to(dtype)
    dt = torch.rand((b, S, H), generator=g).to(dtype)
    A = -torch.rand((H,), generator=g)
    B = torch.randn((b, S, G, N), generator=g).to(dtype)
    C = torch.randn((b, S, G, N), generator=g).to(dtype)
    want = MS.mamba_scan_ref(xh, dt, A, B, C, chunk=32)
    before = MS.mamba_scan.launches
    got = MS.mamba_scan(*(t.to("meta") for t in (xh, dt, A, B, C)),
                        chunk=32)
    assert MS.mamba_scan.launches == before
    for x, w in zip(got, want):
        assert x.device.type == "meta"
        assert (tuple(x.shape), x.dtype) == (tuple(w.shape), w.dtype)


# --- one meta run per family --------------------------------------------------------

FAMILY_CELLS = [("llama3.2-1b", "train_4k"), ("mixtral-8x7b", "decode_32k"),
                ("mamba2-780m", "prefill_32k"), ("zamba2-1.2b", "long_500k"),
                ("llama-3.2-vision-11b", "decode_32k"),
                ("whisper-small", "prefill_32k")]


@pytest.mark.parametrize("arch,shape_name", FAMILY_CELLS)
def test_meta_run_per_family(arch, shape_name):
    rec = D.run_cell(arch, shape_name, "multipod")
    assert rec["ok"], rec.get("error")
    assert rec["flops_model"] > 0 and rec["temp_bytes_per_device"] is None
    assert rec["argument_bytes_per_device"] > 0


# --- the reference's Explicit-mesh fault (ROADMAP queue 3) -------------------------

def test_reference_explicit_mesh_fault_is_pinned():
    """The reference's meshes come from ``jax.make_mesh``
    (``repro/launch/mesh.py:32``, ``:39``), which in this JAX gives Explicit
    axes, and its ``Plan.act`` (``repro/sharding/plan.py:94``) then raises:
    why its dry run and ``test_mini_mesh_train_step_subprocess`` fail, and
    why the oracles here build a ``jax.sharding.Mesh`` (Auto axes) by hand.
    The port's plan places no activation and does not reproduce it."""
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from repro.launch import mesh as jmesh
    cfg = jregistry.get("llama3.2-1b").reduced()
    explicit = jmesh.make_host_mesh()
    assert "Explicit" in str(explicit.axis_types)
    plan = jplan.make_plan(cfg, explicit)
    with pytest.raises(ValueError, match="Auto axes"):
        jax.jit(lambda x: plan.act(x, "batch", None))(jnp.zeros((4, 8)))
    auto = Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "model"))
    plan = jplan.make_plan(cfg, auto)
    assert jax.jit(lambda x: plan.act(x, "batch", None))(
        jnp.zeros((4, 8))).shape == (4, 8)
    port = make_plan(registry.get("llama3.2-1b").reduced(),
                     make_production_mesh())
    x = torch.zeros(4, 8)
    assert port.act(x, "batch", None) is x


# --- sequence parallelism and the per-device count ----------------------------------

SP_CELLS = [("llama3.2-1b", "pod"), ("llama3.2-1b", "multipod"),
            ("whisper-small", "pod"), ("whisper-small", "multipod")]


def _bytes(arch, mesh_kind, sp):
    low = D.lower_cell(arch, "train_4k", make_production_mesh(
        multi_pod=mesh_kind == "multipod"), sequence_parallel=sp)
    return low.argument_bytes(), low.output_bytes()


@pytest.mark.parametrize("arch,mesh_kind", SP_CELLS)
def test_sequence_parallel_lower_cell(arch, mesh_kind):
    """``lower_cell(..., sequence_parallel=True)``: the train cell's meta
    run goes through the sharded layers with the residual stream split
    along the sequence, ok, with the argument and output bytes of the cell
    without the flag (it moves activations only) and the same products."""
    rec = D.run_cell(arch, "train_4k", mesh_kind, sequence_parallel=True)
    assert rec["ok"], rec.get("error")
    assert rec["sequence_parallel"] and rec["flops_scope"] == "device"
    assert (rec["argument_bytes_per_device"],
            rec["output_bytes_per_device"]) == _bytes(arch, mesh_kind, False)
    assert rec["flops_model"] == D.run_cell(arch, "train_4k",
                                            mesh_kind)["flops_model"]


@pytest.mark.parametrize("how", ["flag", "REPRO_SP"])
@pytest.mark.parametrize("arch", ["llama3.2-1b", "whisper-small"])
def test_sequence_parallel_cli(arch, how, monkeypatch):
    """``--sequence-parallel``, and ``REPRO_SP=1`` as the reference spells
    it, run the train cell on both production meshes with the flag: ok,
    the bytes of the cell without it."""
    argv = ["--arch", arch, "--shape", "train_4k", "--mesh", "both"]
    if how == "flag":
        argv.append("--sequence-parallel")
    else:
        monkeypatch.setenv("REPRO_SP", "1")
    recs = D.main(argv)
    assert [r["mesh"] for r in recs] == ["pod", "multipod"]
    for r in recs:
        assert r["ok"] and r["sequence_parallel"], r.get("error")
        assert (r["argument_bytes_per_device"],
                r["output_bytes_per_device"]) == _bytes(arch, r["mesh"],
                                                        False)


def test_sequence_parallel_leaves_serving_cells():
    """Serving cells are as without the flag, as in the reference: the
    same record but for the walls."""
    walls = ("lower_s", "run_s")
    for shape in ("prefill_32k", "decode_32k"):
        a = D.run_cell("llama3.2-1b", shape, "pod", sequence_parallel=True)
        b = D.run_cell("llama3.2-1b", shape, "pod")
        assert a["ok"] and a["flops_scope"] == "unsharded"
        assert {k: v for k, v in a.items() if k not in walls} == \
            {k: v for k, v in b.items() if k not in walls}


@pytest.mark.parametrize("sp", [False, True], ids=["whole", "sequence"])
def test_flops_model_is_one_devices_count(sp):
    """A train cell's ``flops_model`` is one device's: reduced llama3.2-1b
    (2 layers, d 64, 4 / 2 heads of 16, d_ff 128, a tied vocabulary of
    256) over a shape-only ``{data 4, model 2}`` at B 8, S 64 runs one
    microbatch of 2 rows a device. Each product of x (T, n) by a weight
    (n, m) counts 2 T n m forward and twice that backward (the input's
    and the weight's gradients): every product of this config is split
    over the model axis and counts at its 1 / tp share (heads, kv heads,
    MLP columns, vocabulary rows); a replicated one would count whole. The
    flash attention is not counted (a kernel). Sequence parallelism moves
    activations and keeps the count."""
    from repro_torch.launch.mesh import MeshShape
    cfg = registry.get("llama3.2-1b").reduced()
    mesh = MeshShape(("data", "model"), (4, 2))
    low = D.lower_cell(cfg, ShapeSpec("train_small", 64, 8, "train"), mesh,
                       sequence_parallel=sp)
    assert low.info["n_accum"] == 1 and low.info["rows_per_rank"] == 2
    from torch.utils.flop_counter import FlopCounterMode
    with FlopCounterMode(display=False) as fc:
        low.run()
    tp, T = 2, 2 * 64
    d, dh, ff, V = cfg.d_model, cfg.head_dim, cfg.d_ff, 256
    split = lambda n, m, parts: (n, m // parts)  # noqa: E731
    per_layer = [split(d, cfg.num_heads * dh, tp),       # wq
                 split(d, cfg.num_kv_heads * dh, tp),    # wk
                 split(d, cfg.num_kv_heads * dh, tp),    # wv
                 (cfg.num_heads * dh // tp, d),          # wo
                 split(d, ff, tp), split(d, ff, tp),     # wg, wu
                 (ff // tp, d)]                          # wd
    products = per_layer * cfg.num_layers + [split(d, V, tp)]  # unembed
    assert cfg.tie_embeddings and cfg.remat == "none"
    want = sum(3 * 2 * T * n * m for n, m in products)
    assert fc.get_total_flops() == want

"""The dry run over every (arch x shape x mesh) cell: the port of the
reference's ``launch/dryrun.py``.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-1.7b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both --out dryrun.json
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both --sequence-parallel

The reference lowers and compiles each cell's step for the production
meshes (256 or 512 devices) and reads XLA's memory and cost analyses. The
port has no compiler to ask, so for each cell it builds the step's inputs
as meta tensors (``launch/inputs.py``: shapes and dtypes, no memory), with
the plan's specs, and

- counts each input's bytes on one rank: every dimension a spec shards is
  divided by the product of its mesh axes' sizes, rounded up, as XLA pads
  an uneven shard (``argument_bytes_per_device``, equal to XLA's
  ``argument_size_in_bytes`` on the same specs);
- counts the outputs the same way (``output_bytes_per_device``): the
  train step's updated parameters and optimizer state at their input
  specs and its float32 metrics replicated, the serving steps' caches at
  the plan's cache specs and their last logits over (batch axes, vocab on
  the model axis), the layout the plan gives the logits. XLA's figure
  takes for the logits, which the reference's step gives no output
  sharding, the layout its own propagation picks, and sizes its own
  buffers: on reduced models over ``{data 4, model 2}`` it is a few
  hundred bytes (under 1 %) above this count
  (``tests/test_torch_dryrun.py``);
- runs the step on meta tensors at one rank's rows
  (``rows_per_rank``: the global batch over the data axes, and for train
  over the microbatches too). A train cell runs at one device's shapes:
  forward and autograd backward of one microbatch through the sharded
  layers, on the device's shard of each weight (``plan.spec``: its heads,
  columns, experts and vocabulary), inside an ``spmd.region`` of
  ``spmd.MetaGroup`` s whose collectives only give their outputs' shapes.
  A serving cell runs the prefill or decode step with the model at full
  (plan-padded) width. A decode cell keeps every cache entry of its rows
  (the ``long_500k`` cell's cache sequence is sharded over the data axis
  in the specs, not in this run). ``run_s`` is the run's wall time on the
  host and ``flops_model`` the operations that
  ``torch.utils.flop_counter.FlopCounterMode`` counts in it: the products
  outside the flash attention and the Mamba2 scan (``flops_scope`` says
  which count it is). For a train cell it is one device's count of those
  products in a microbatch (``"device"``: a product split over the model
  axis counted at its ``1 / tp`` share, a replicated one whole; XLA's
  cost analysis of the partitioned program, the reference's figure, also
  counts the rest). For a serving cell it is the whole, unsharded model's
  products at one rank's rows (``"unsharded"``: about ``tp`` times one
  device's share). On meta tensors the flash attention and the scan
  (their kernels' wrappers and their ``autograd.Function`` s' backward)
  give their outputs' layout and compute nothing, so neither their work
  nor the host time of their plain backward (hundreds of ops per chunk of
  the scan) is in the run;
- leaves ``temp_bytes_per_device`` null: XLA's temporary buffer belongs
  to its compiled program, and an eager PyTorch step has no counterpart.

A cell whose run raises becomes an ``"ok": false`` record with its error,
and the CLI exits 1 if any cell failed. Nothing is allocated and no card
is used. ``--sequence-parallel``, or ``REPRO_SP=1`` in the environment as
the reference spells it, runs the train cells under
``make_plan(..., sequence_parallel=True)``: the meta run splits the
residual stream along the sequence over the model axis (a gather
multiplies dimension 1 by ``tp``, a scatter divides it). The serving cells
are as without it, as in the reference. It moves activations only, so
the argument and output bytes are those without it.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import time
import traceback
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional

import torch
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import registry
from repro_torch.configs.base import ModelConfig, ShapeSpec
from repro_torch.launch import inputs as I
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import params as pm
from repro_torch.models.layers import cdt
from repro_torch.models.model import Model
from repro_torch.serve.step import make_decode_step, make_prefill_step
from repro_torch.sharding import spmd
from repro_torch.sharding.plan import Spec, make_plan, mesh_axes
from repro_torch.train.optimizer import make_optimizer
from repro_torch.train.step import make_grad_fn

SERVE_DTYPE = "bfloat16"  # the serving cells' weights, as the reference's

#: the train step's metrics: the loss's, the optimizer's and the loss
TRAIN_METRICS = ("nll", "z_loss", "accuracy", "tokens", "grad_norm", "lr",
                 "loss")
MOE_METRICS = ("moe_aux", "moe_z")


def choose_n_accum(cfg: ModelConfig, shape: ShapeSpec, dp_total: int) -> int:
    if shape.kind != "train":
        return 1
    per_dp = max(shape.global_batch // dp_total, 1)
    seqs_per_mb = 1 if cfg.d_model >= 4096 else 4
    return max(per_dp // seqs_per_mb, 1)


def dp_size(mesh) -> int:
    """The product of the mesh's data axes (``pod``, ``data``)."""
    sizes = mesh_axes(mesh)
    return math.prod(sizes.get(a, 1) for a in ("pod", "data"))


def _axes(entry):
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def shard_bytes(t: torch.Tensor, spec: Spec, sizes: Dict[str, int]) -> int:
    """The bytes of one rank's shard of ``t`` under ``spec``: each
    dimension the spec shards divided by its axes' sizes, rounded up."""
    n = t.element_size()
    for i, dim in enumerate(t.shape):
        entry = spec[i] if i < len(spec) else None
        n *= -(-dim // math.prod(sizes[a] for a in _axes(entry)))
    return n


def _leaves(tree, specs):
    """(tensor, spec) pairs of a tree of tensors (dicts, tuples) and its
    tree of specs (a ``Spec`` is a leaf)."""
    if isinstance(tree, dict):
        if sorted(tree) != sorted(specs):
            raise ValueError(f"spec keys {sorted(specs)} for {sorted(tree)}")
        for k in tree:
            yield from _leaves(tree[k], specs[k])
    elif isinstance(tree, (tuple, list)):
        if isinstance(specs, Spec) or len(tree) != len(specs):
            raise ValueError("a spec tree that does not match its tree")
        for t, s in zip(tree, specs):
            yield from _leaves(t, s)
    else:
        if not isinstance(specs, Spec):
            raise ValueError(f"{specs!r} is not a Spec")
        yield tree, specs


def tree_bytes(tree, specs, mesh) -> int:
    """One rank's bytes of every tensor of ``tree`` under ``specs``."""
    sizes = mesh_axes(mesh)
    return sum(shard_bytes(t, s, sizes) for t, s in _leaves(tree, specs))


def stand_ins(meta_tree, dtype: Optional[str] = None):
    """Meta tensors for a ``ParamMeta`` tree, in ``dtype`` or each leaf's
    own (the reference's ``params.abstract``)."""
    return pm.tree_map(lambda m: I.stand_in(m.shape, pm.torch_dtype(
        dtype or m.dtype)), meta_tree)


def device_stand_ins(meta_tree, plan, dtype: str):
    """Meta tensors of one device's tensor-parallel shard of each leaf of
    a ``ParamMeta`` tree: each dimension that the leaf's spec
    (``plan.spec``) shards divided by its mesh axes' sizes (the plan pads
    what it shards, so each divides evenly)."""
    sizes = mesh_axes(plan.mesh)

    def local(m):
        spec = plan.spec(m.logical)
        shape = []
        for i, dim in enumerate(m.shape):
            n = math.prod(sizes[a] for a in _axes(spec[i]))
            if dim % n:
                raise ValueError(f"dimension {i} of {tuple(m.shape)} does "
                                 f"not split over {n} devices")
            shape.append(dim // n)
        return I.stand_in(tuple(shape), pm.torch_dtype(dtype))
    return pm.tree_map(local, meta_tree)


def meta_region(plan):
    """An ``spmd.region`` over one device of ``plan`` 's mesh, in shape
    only: ``spmd.MetaGroup`` s of the model axis and of the data axes
    together, sequence-parallel where the plan is."""
    sizes = mesh_axes(plan.mesh)
    tp = spmd.MetaGroup(sizes["model"]) if "model" in sizes else None
    dp = (spmd.MetaGroup(math.prod(sizes[a] for a in plan.dp_axes))
          if plan.dp_axes else None)
    return spmd.region(tp, dp, seq=plan.sequence_parallel)


@dataclass
class Lowered:
    """One cell's step: its inputs and outputs as meta tensors with their
    specs on ``mesh``, and ``run``, the step on meta tensors at one rank's
    rows."""
    mesh: Any
    args: tuple
    arg_specs: tuple
    outs: tuple
    out_specs: tuple
    run: Callable[[], Any]
    info: Dict[str, Any]

    def argument_bytes(self) -> int:
        return tree_bytes(self.args, self.arg_specs, self.mesh)

    def output_bytes(self) -> int:
        return tree_bytes(self.outs, self.out_specs, self.mesh)


def _logits(cfg: ModelConfig, plan, B: int):
    """A serving step's last logits (B, V) and their spec."""
    return (I.stand_in((B, plan.vocab), cdt(cfg)),
            Spec(plan.batch_axes, plan.rules.get("vocab")))


def _serving_model(cfg: ModelConfig, plan):
    model = Model(cfg, plan=plan, device="meta")
    params = stand_ins(model.param_meta(), SERVE_DTYPE)
    model.set_weights(params)
    return model, params


def lower_cell(arch, shape, mesh, *, sequence_parallel: bool = False
               ) -> Lowered:
    """Build one cell (``arch`` a registry name or a config, ``shape`` a
    shape name or a ``ShapeSpec``) on ``mesh`` (a shape-only mesh or a
    ``DeviceMesh``), with the reference's three branches: train at
    ``param_dtype`` with the optimizer state, the batch and the step;
    prefill and decode at bf16 weights, decode replicating the batch and
    sharding the cache sequence over ``data`` where the batch does not
    divide the data axes (``long_500k``). ``sequence_parallel``: the
    train step's plan splits the residual stream along the sequence over
    the model axis (the serving cells are as without it)."""
    cfg = registry.get(arch) if isinstance(arch, str) else arch
    shape = registry.get_shape(shape) if isinstance(shape, str) else shape
    dp = dp_size(mesh)
    B, S = shape.global_batch, shape.seq_len

    if shape.kind == "train":
        plan = make_plan(cfg, mesh, sequence_parallel=sequence_parallel)
        model = Model(cfg, plan=plan, device="meta")
        meta = model.param_meta()
        opt = make_optimizer(cfg)
        n_accum = choose_n_accum(cfg, shape, dp)
        params = stand_ins(meta, cfg.param_dtype)
        opt_meta = opt.state_meta(meta)
        opt_state = stand_ins(opt_meta)
        names = TRAIN_METRICS + (MOE_METRICS if cfg.is_moe else ())
        metrics = {k: I.stand_in((), torch.float32) for k in names}
        specs = (plan.param_specs(meta), plan.param_specs(opt_meta))
        rows = max(max(B // dp, 1) // n_accum, 1)
        mb = I.train_input_specs(cfg, dataclasses.replace(
            shape, global_batch=rows))
        grad_fn = make_grad_fn(model)
        local = device_stand_ins(meta, plan, cfg.param_dtype)

        def run():
            with meta_region(plan):
                return grad_fn(local, mb)
        return Lowered(
            mesh,
            (params, opt_state, I.train_input_specs(cfg, shape),
             I.stand_in((), torch.int32)),
            specs + (I.train_input_shardings(cfg, plan), Spec()),
            (params, opt_state, metrics),
            specs + ({k: Spec() for k in names},),
            run,
            {"kind": "train", "n_accum": n_accum,
             "n_params": pm.n_params(meta), "rows_per_rank": rows,
             "sequence_parallel": sequence_parallel,
             "flops_scope": "device"})

    cfg_srv = cfg.replace(param_dtype=SERVE_DTYPE)
    if shape.kind == "prefill":
        plan = make_plan(cfg_srv, mesh)
        model, params = _serving_model(cfg_srv, plan)
        rows = max(B // dp, 1)
        step = make_prefill_step(model, max_len=S)
        mb = I.prefill_input_specs(cfg_srv, dataclasses.replace(
            shape, global_batch=rows))
        logits, logits_spec = _logits(cfg_srv, plan, B)
        return Lowered(
            mesh,
            (params, I.prefill_input_specs(cfg_srv, shape)),
            (plan.param_specs(model.param_meta()),
             I.prefill_input_shardings(cfg_srv, plan)),
            (logits, model.cache(B, S, device="meta")),
            (logits_spec, model.cache_specs()),
            lambda: step(mb),
            {"kind": "prefill", "n_params": model.n_params(),
             "rows_per_rank": rows, "flops_scope": "unsharded"})

    replicate_batch = B % dp != 0
    seq_axis = "data" if replicate_batch else None  # long_500k
    plan = make_plan(cfg_srv, mesh, replicate_batch=replicate_batch)
    model, params = _serving_model(cfg_srv, plan)
    cache, tok, pos = I.decode_input_specs(cfg_srv, shape, model)
    cache_sh, tok_sh, pos_sh = I.decode_input_shardings(
        cfg_srv, plan, model, seq_axis=seq_axis)
    rows = B if replicate_batch else B // dp
    step = make_decode_step(model)
    mine = I.decode_input_specs(cfg_srv, dataclasses.replace(
        shape, global_batch=rows), model)
    logits, logits_spec = _logits(cfg_srv, plan, B)
    return Lowered(
        mesh,
        (params, cache, tok, pos),
        (plan.param_specs(model.param_meta()), cache_sh, tok_sh, pos_sh),
        (logits, cache), (logits_spec, cache_sh),
        lambda: step(*mine),
        {"kind": "decode", "n_params": model.n_params(),
         "rows_per_rank": rows, "flops_scope": "unsharded"})


def run_cell(arch: str, shape_name: str, mesh_kind: str, *,
             sequence_parallel: bool = False) -> Dict[str, Any]:
    mesh = make_production_mesh(multi_pod=(mesh_kind == "multipod"))
    t0 = time.perf_counter()
    rec: Dict[str, Any] = {"arch": arch, "shape": shape_name,
                           "mesh": mesh_kind}
    try:
        low = lower_cell(arch, shape_name, mesh,
                         sequence_parallel=sequence_parallel)
        rec.update(low.info)
        rec.update({
            "argument_bytes_per_device": low.argument_bytes(),
            "output_bytes_per_device": low.output_bytes(),
            "temp_bytes_per_device": None})
        t1 = time.perf_counter()
        with FlopCounterMode(display=False) as fc:
            low.run()
        t2 = time.perf_counter()
        rec.update({"ok": True, "lower_s": round(t1 - t0, 3),
                    "run_s": round(t2 - t1, 3),
                    "flops_model": fc.get_total_flops()})
        print(f"[dryrun] {arch} {shape_name} {mesh_kind}: OK "
              f"(lower {rec['lower_s']}s, meta run {rec['run_s']}s, "
              f"args/dev {rec['argument_bytes_per_device']}, "
              f"out/dev {rec['output_bytes_per_device']}, "
              f"flops {rec['flops_model']:.4g} {rec['flops_scope']})")
    except Exception as e:  # noqa: BLE001 -- the record carries the error
        rec.update({"ok": False, "error": f"{type(e).__name__}: {e}",
                    "traceback": traceback.format_exc()[-2000:]})
        print(f"[dryrun] {arch} {shape_name} {mesh_kind}: FAIL "
              f"{rec['error']}")
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="pod",
                    choices=["pod", "multipod", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=None)
    ap.add_argument("--sequence-parallel", action="store_true",
                    help="train cells with the residual stream split along "
                         "the sequence over the model axis (also "
                         "REPRO_SP=1, the reference's spelling)")
    args = ap.parse_args(argv)
    sp = args.sequence_parallel or os.environ.get("REPRO_SP", "") == "1"

    meshes = ["pod", "multipod"] if args.mesh == "both" else [args.mesh]
    if args.all:
        cells = list(registry.all_cells())
    elif args.arch and args.shape:
        cells = [(args.arch, args.shape)]
    else:
        ap.error("give --arch and --shape, or --all")

    t0 = time.perf_counter()
    results = [run_cell(arch, shape, mk, sequence_parallel=sp)
               for arch, shape in cells for mk in meshes]
    n_ok = sum(r["ok"] for r in results)
    print(f"[dryrun] {n_ok}/{len(results)} cells OK in "
          f"{time.perf_counter() - t0:.1f} s")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
    if n_ok < len(results):
        raise SystemExit(1)
    return results


if __name__ == "__main__":
    main()

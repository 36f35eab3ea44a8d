"""Train and eval steps with microbatch gradient accumulation: the port of
the reference's ``train/step.py``.

``make_train_step(model, opt, n_accum)`` returns

    train_step(params, opt_state, batch, step) -> (params, opt_state, metrics)

over a tree of float32 masters (``model.weights()``). The global batch
(B, S) is split into ``n_accum`` microbatches of B / n_accum rows, run in
sequence so activation memory is one microbatch's; each one's float32
gradients are taken by ``torch.autograd.grad`` through
``Model.loss_forward`` and summed in order, then divided by ``n_accum``;
the loss and the metrics are averaged. The optimizer then writes the new
masters into ``params`` and ``opt_state`` in place (``Optimizer.update``)
and the model takes them (``Model.set_weights``), so that ``apply`` and
serving read the trained weights.

Under a plan whose mesh is a ``DeviceMesh`` (``Model(cfg, plan=make_plan(
cfg, mesh))``, every rank of the mesh running the same calls) the step is
the reference's sharded one: ``params`` and ``opt_state`` are ``DTensor`` s
at ``plan.param_shardings`` (FSDP: the tensor-parallel spec plus the
largest replicated dimension over the data axes), ``batch`` is the global
batch on every rank, and each rank runs its rows of each microbatch
(every batch leaf's rows, the frontend's image embeddings or audio frames
as the tokens, split over the data axes, as the reference shards them)
through the model on its share of the heads, the MLP's columns and the
vocabulary (``sharding/spmd.py``). The mesh is ``(data, model)`` or
``(pod, data, model)``: the data axes are ``plan.dp_axes``, and over two
of them a leaf's FSDP dimension and the batch's rows split over their
product, pod-major, as the reference's ``zero_spec`` and batch spec do.
Per microbatch the masters are all-gathered over the data axes to
``plan.tp_shardings`` inside the graph, whose backward reduce-scatters
the gradient back. With
``hoist_gather`` (the reference's option, default off; it applies with
FSDP, a data axis and ``n_accum > 1``) the gather and the cast to
``cfg.dtype`` happen once per step outside the graph, and each
microbatch's gradient is reduce-scattered back to the FSDP placement in
float32 (the reference's ``scatter_grad``), leaf by leaf as the backward
produces it (``spmd.hoisted``). The gradients come back as
``DTensor`` s at the FSDP placement, the loss and metrics as the batch's,
and ``Optimizer.update`` runs on the ``DTensor`` s. The sharded step
leaves the model's stored weights alone: its forward takes the masters it
is given.

The sharded step runs every family; each layer places its
tensor-parallel operators itself (``sharding/spmd.py`` lists where
``enter``, ``leave`` and ``all_sum`` sit): attention and MLA on their
local heads, the cross-attention's K/V of the image embeddings or of
whisper's encoder output on them too, the MLP on its columns, the MoE
experts over the model axis (``ep``) or inside each expert (``tp``)
behind a router that runs whole on every rank, and Mamba2 on its local
heads (the scan kernel on ``H / tp`` of them). Each rank's rows form
their own MoE dispatch groups, as the reference's under a mesh, so at
more than one data rank the MoE losses are the reference's sharded
step's, not the one-process step's. The MoE aux and z terms are the
whole batch's on every data rank (``models/moe.py``), so each rank's
loss adds its ``1 / dp`` share of them, and they are reported at the
batch's value, not summed over the data axes.

Under a plan made with ``sequence_parallel=True`` (the reference's
``"seq"`` rule on the model axis, reached through ``make_plan`` and the
dry run's ``--sequence-parallel``) the region also splits the residual
stream along the sequence over the model axis: each rank holds its
``S / tp`` rows of every microbatch row between the tensor-parallel
blocks, gathered at a block's input and scattered at its output
(``sharding/spmd.py``), with ``hoist_gather`` off or on, under remat (the
recomputed forward makes the same collectives in the same order on every
rank) and on either mesh. S must split evenly over the model axis. The
loss, the gradients and the update are the step's without the flag.
"""
from __future__ import annotations

from typing import Any, Dict, List

import torch

from repro_torch.models import params as pm
from repro_torch.models.model import Model
from repro_torch.sharding import spmd
from repro_torch.train.loss import lm_loss
from repro_torch.train.optimizer import Optimizer


def _split_batch(batch: Dict[str, Any], n: int) -> List[Dict[str, Any]]:
    """The batch as ``n`` microbatches of consecutive rows."""
    def rows(x, i):
        b = x.shape[0] // n
        return x[i * b:(i + 1) * b]
    return [{k: rows(v, i) for k, v in batch.items()} for i in range(n)]


def make_loss_fn(model: Model):
    def loss_fn(params, mb):
        logits, aux = model.loss_forward(params, mb)
        labels = torch.as_tensor(mb["labels"], device=logits.device)
        loss, metrics = lm_loss(logits, labels)
        cfg = model.cfg
        if cfg.is_moe:
            # inside an spmd.region aux and z are the batch's on every data
            # rank, whose losses sum over the data axis: each adds its share
            n_dp = spmd.size("data")
            loss = loss + cfg.router_aux_coef * aux["moe_aux"] / n_dp \
                        + cfg.router_z_coef * aux["moe_z"] / n_dp
            metrics = {**metrics, **aux}
        return loss, metrics

    return loss_fn


def _grads(loss_fn, params, mb):
    """(loss, metrics, float32 gradients of every leaf in tree order),
    all detached; a leaf the loss does not read gets zeros."""
    leaves = pm.tree_map(lambda p: p.detach().requires_grad_(True), params)
    flat = pm.tree_leaves(leaves)
    loss, metrics = loss_fn(leaves, mb)
    gs = torch.autograd.grad(loss, flat, allow_unused=True)
    gs = [torch.zeros_like(p) if g is None else g for p, g in zip(flat, gs)]
    return loss.detach(), {k: v.detach() for k, v in metrics.items()}, gs


def make_grad_fn(model: Model, n_accum: int = 1):
    """-> ``grad_fn(params, batch) -> (loss, metrics, grads)``: the loss and
    metrics averaged over ``n_accum`` microbatches and the float32
    gradients summed over them in order, then divided by ``n_accum``, as a
    tree like ``params``; all detached."""
    loss_fn = make_loss_fn(model)

    def grad_fn(params, batch):
        if n_accum == 1:
            loss, metrics, grads = _grads(loss_fn, params, batch)
        else:
            grads, loss, ms = None, 0.0, []
            for mb in _split_batch(batch, n_accum):
                l, m, g = _grads(loss_fn, params, mb)
                if grads is None:
                    grads = g
                else:
                    for acc, gi in zip(grads, g):
                        acc.add_(gi)
                loss = loss + l
                ms.append(m)
            grads = [g / n_accum for g in grads]
            loss = loss / n_accum
            metrics = {k: torch.stack([m[k] for m in ms]).mean(0)
                       for k in ms[0]}
        it = iter(grads)
        return loss, metrics, pm.tree_map(lambda _: next(it), params)

    return grad_fn


def _replicated(x):
    """A metric as a plain tensor (a ``DTensor`` replicated on every
    rank, as the optimizer's norm is, by its local value)."""
    from torch.distributed.tensor import DTensor
    return x.to_local() if isinstance(x, DTensor) else x


def make_train_step(model: Model, opt: Optimizer, n_accum: int = 1,
                    hoist_gather: bool = False):
    """-> ``train_step``, with its two halves as attributes:
    ``train_step.grads(params, batch) -> (loss, metrics, grads)`` changes
    nothing, so a failed attempt can be run again; ``train_step.update(
    params, opt_state, loss, metrics, grads, step)`` writes ``params`` and
    ``opt_state`` in place, leaf by leaf, so a failure inside it leaves a
    step half applied and is not to be retried. ``hoist_gather`` acts on a
    sharded step only (module docstring)."""
    sharded = is_sharded(model)
    grad_fn = (make_sharded_grad_fn(model, n_accum, hoist_gather) if sharded
               else make_grad_fn(model, n_accum))

    def update(params, opt_state, loss, metrics, grads, step):
        params, opt_state, opt_metrics = opt.update(params, grads, opt_state,
                                                    step)
        if not sharded:
            model.set_weights(params)
        opt_metrics = {k: _replicated(v) for k, v in opt_metrics.items()}
        return params, opt_state, {**metrics, **opt_metrics, "loss": loss}

    def train_step(params, opt_state, batch, step):
        return update(params, opt_state, *grad_fn(params, batch), step)

    train_step.grads, train_step.update = grad_fn, update
    return train_step


# --- the sharded step ------------------------------------------------------------

def is_sharded(model: Model) -> bool:
    """Whether the model's plan is over a ``DeviceMesh`` (the step runs
    across its ranks)."""
    return hasattr(model.plan.mesh, "mesh_dim_names")


#: metrics that are the whole batch's on every data rank (the others are
#: each rank's share of it and sum over the data axis)
BATCH_METRICS = ("tokens", "moe_aux", "moe_z")


def _rank_rows(x, rank: int, n: int):
    b = x.shape[0] // n
    return x[rank * b:(rank + 1) * b]


def make_sharded_grad_fn(model: Model, n_accum: int = 1,
                         hoist_gather: bool = False):
    """:func:`make_grad_fn` across the ranks of the plan's ``DeviceMesh``
    (module docstring): ``grad_fn(params, batch) -> (loss, metrics,
    grads)`` with ``params`` and the returned ``grads`` trees of
    ``DTensor`` s at ``plan.param_shardings``, ``batch`` the global batch
    on every rank, the loss and metrics those of the whole batch."""
    from torch.distributed.tensor import DTensor

    from repro_torch.models.layers import cdt
    cfg, plan = model.cfg, model.plan
    mesh = plan.mesh
    names = mesh.mesh_dim_names
    if set(names) - {"pod", "data", "model"}:
        raise ValueError(f"the sharded step takes a (data, model) or (pod, "
                         f"data, model) mesh, got {names}")
    meta = model.param_meta()
    fsdp = pm.tree_leaves(plan.param_shardings(meta))
    tp = pm.tree_leaves(plan.tp_shardings(meta))
    for m, f, t in zip(pm.tree_leaves(meta), fsdp, tp):
        spmd.check_even(m.shape, mesh, f.placements)
        spmd.check_even(m.shape, mesh, t.placements)
    # the data axes, pod-major: the mesh dimensions a gradient sums over,
    # and this rank's index among the data ranks (its rows of the batch)
    partial = [names.index(a) for a in plan.dp_axes]
    tp_group = mesh.get_group("model") if "model" in names else None
    dp_group = spmd.dp_group(mesh, plan.dp_axes)
    coord = mesh.get_coordinate()
    dp_rank, dp_n = 0, 1
    for i in partial:
        dp_rank, dp_n = dp_rank * mesh.size(i) + coord[i], dp_n * mesh.size(i)
    hoist = bool(hoist_gather and n_accum > 1 and plan.fsdp and plan.dp_axes)
    loss_fn = make_loss_fn(model)
    dtype = cdt(cfg)

    def mb_grads(leaves, mb, gathered):
        """One microbatch: (loss share, metric shares, this rank's FSDP
        gradient of every leaf, float32)."""
        xs = [p.detach().requires_grad_(True) for p in leaves]
        if gathered is None:  # gather inside the graph
            full = [spmd.gather(x, mesh, f.placements, t.placements,
                                partial) for x, f, t in zip(xs, fsdp, tp)]
        else:  # the reference's scatter_grad, leaf by leaf
            full = [spmd.hoisted(x, g, mesh, f.placements, partial)
                    for x, g, f in zip(xs, gathered, fsdp)]
        it = iter(full)
        loss, metrics = loss_fn(pm.tree_map(lambda _: next(it), meta), mb)
        gs = torch.autograd.grad(loss, xs, allow_unused=True)
        gs = [torch.zeros_like(x) if g is None else g
              for x, g in zip(xs, gs)]
        return loss.detach(), {k: v.detach() for k, v in metrics.items()}, \
            [g.float() for g in gs]

    def grad_fn(params, batch):
        B = next(iter(batch.values())).shape[0]
        if B % (n_accum * dp_n):
            raise ValueError(f"a batch of {B} rows does not split into "
                             f"{n_accum} microbatches over {dp_n} data ranks")
        dts = pm.tree_leaves(params)
        leaves = [p.to_local() for p in dts]
        gathered = None
        if hoist:
            gathered = [spmd.gather_local(x.to(dtype), mesh, f.placements,
                                          t.placements)
                        for x, f, t in zip(leaves, fsdp, tp)]
        grads, loss, ms = None, 0.0, []
        with spmd.region(tp_group, dp_group, seq=plan.sequence_parallel):
            for mb in _split_batch(batch, n_accum):
                mine = {k: _rank_rows(v, dp_rank, dp_n)
                        for k, v in mb.items()}
                l, m, g = mb_grads(leaves, mine, gathered)
                grads = g if grads is None else [
                    a.add_(b) for a, b in zip(grads, g)]
                loss = loss + l
                ms.append(m)
        del gathered
        # this rank's shares of the loss and metrics, summed over the data
        # axis; the token count and the MoE losses are already the batch's
        loss = spmd.all_reduce(loss / n_accum, dp_group)
        metrics = {k: torch.stack([m[k] for m in ms]).mean(0) for k in ms[0]}
        metrics = {k: v if k in BATCH_METRICS
                   else spmd.all_reduce(v, dp_group)
                   for k, v in metrics.items()}
        grads = [DTensor.from_local(g / n_accum, p.device_mesh, p.placements,
                                    run_check=False, shape=p.shape,
                                    stride=p.stride())
                 for g, p in zip(grads, dts)]
        it = iter(grads)
        return loss, metrics, pm.tree_map(lambda _: next(it), params)

    return grad_fn


def make_eval_step(model: Model):
    loss_fn = make_loss_fn(model)

    @torch.no_grad()
    def eval_step(params, batch):
        loss, metrics = loss_fn(params, batch)
        return {**metrics, "loss": loss}

    return eval_step

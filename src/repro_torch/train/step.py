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
serving read the trained weights. The reference's ``hoist_gather`` is a
mesh option; the port takes no sharding plan, so it is left out, as
``Model`` leaves out the plan.
"""
from __future__ import annotations

from typing import Any, Dict, List

import torch

from repro_torch.models import params as pm
from repro_torch.models.model import Model
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
            loss = loss + cfg.router_aux_coef * aux["moe_aux"] \
                        + cfg.router_z_coef * aux["moe_z"]
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


def make_train_step(model: Model, opt: Optimizer, n_accum: int = 1):
    """-> ``train_step``, with its two halves as attributes:
    ``train_step.grads(params, batch) -> (loss, metrics, grads)`` changes
    nothing, so a failed attempt can be run again; ``train_step.update(
    params, opt_state, loss, metrics, grads, step)`` writes ``params`` and
    ``opt_state`` in place, leaf by leaf, so a failure inside it leaves a
    step half applied and is not to be retried."""
    grad_fn = make_grad_fn(model, n_accum)

    def update(params, opt_state, loss, metrics, grads, step):
        params, opt_state, opt_metrics = opt.update(params, grads, opt_state,
                                                    step)
        model.set_weights(params)
        return params, opt_state, {**metrics, **opt_metrics, "loss": loss}

    def train_step(params, opt_state, batch, step):
        return update(params, opt_state, *grad_fn(params, batch), step)

    train_step.grads, train_step.update = grad_fn, update
    return train_step


def make_eval_step(model: Model):
    loss_fn = make_loss_fn(model)

    @torch.no_grad()
    def eval_step(params, batch):
        loss, metrics = loss_fn(params, batch)
        return {**metrics, "loss": loss}

    return eval_step

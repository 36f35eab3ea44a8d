"""In-house optimizers, AdamW and Adafactor (factored second moments): the
port of the reference's ``train/optimizer.py``, term for term.

They act on a parameter tree (nested dicts of tensors, the model's
weights), not through ``torch.optim``, whose AdamW orders and places its
terms otherwise: here weight decay is added to the update of every leaf,
the warmup counts from 1 (step 0 trains) and the bias corrections use
``step + 1``. The state mirrors the tree, one dict of moments per leaf, and
:meth:`Optimizer.state_meta` describes it as a ``ParamMeta`` tree.

:meth:`Optimizer.update` writes the new parameters and moments into the
tensors it is given (the reference returns new arrays): at llama3.2-1b's
width a second copy of the float32 masters and both moments would be 15
GB. The schedule's scalars (learning rate, bias corrections) are float32
values computed on the host, as the reference computes them in float32.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass

import torch

from repro_torch.models import params as pm


@dataclass(frozen=True)
class OptConfig:
    kind: str = "adamw"  # adamw | adafactor
    lr: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    moment_dtype: str = "float32"
    # adafactor
    decay_rate: float = 0.8
    min_dim_factored: int = 128


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32)


def lr_schedule(oc: OptConfig, step) -> torch.Tensor:
    """Linear warmup + cosine decay, a float32 scalar on the host. Warmup
    counts from 1 (step 0 trains)."""
    step = _f32(step)
    warm = torch.clamp((step + 1.0) / max(oc.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - oc.warmup_steps)
                       / max(oc.total_steps - oc.warmup_steps, 1), 0.0, 1.0)
    return oc.lr * warm * 0.5 * (1.0 + torch.cos(math.pi * prog))


def global_norm(tree) -> torch.Tensor:
    leaves = pm.tree_leaves(tree)
    return torch.sqrt(sum(torch.sum(torch.square(l.float()))
                          for l in leaves))


def clip_by_global_norm(tree, max_norm):
    """-> (the tree scaled to norm at most ``max_norm``, its norm)."""
    gn = global_norm(tree)
    scale = torch.clamp(max_norm / (gn + 1e-9), max=1.0)
    return pm.tree_map(lambda g: g * scale.to(g.dtype), tree), gn


def _is_factored(shape, oc: OptConfig) -> bool:
    return (len(shape) >= 2 and shape[-1] >= oc.min_dim_factored
            and shape[-2] >= oc.min_dim_factored)


class Optimizer:
    def __init__(self, oc: OptConfig):
        self.oc = oc

    # --- state as ParamMeta ---------------------------------------------------
    def state_meta(self, param_meta):
        oc = self.oc

        def per_param(m: pm.ParamMeta):
            if oc.kind == "adamw":
                z = dataclasses.replace(m, init="zeros", dtype=oc.moment_dtype)
                return {"m": z, "v": z}
            if _is_factored(m.shape, oc):
                vr = pm.ParamMeta(m.shape[:-1], m.logical[:-1], init="zeros",
                                  dtype=oc.moment_dtype)
                vc = pm.ParamMeta(m.shape[:-2] + m.shape[-1:],
                                  m.logical[:-2] + m.logical[-1:],
                                  init="zeros", dtype=oc.moment_dtype)
                return {"vr": vr, "vc": vc}
            return {"v": dataclasses.replace(m, init="zeros",
                                             dtype=oc.moment_dtype)}

        return pm.tree_map(per_param, param_meta)

    def init(self, params):
        """Zero moments on each leaf's device."""
        oc = self.oc
        mdt = pm.torch_dtype(oc.moment_dtype)

        def per_param(p):
            zeros = lambda shape: torch.zeros(shape, dtype=mdt,
                                              device=p.device)
            if oc.kind == "adamw":
                return {"m": zeros(p.shape), "v": zeros(p.shape)}
            if _is_factored(p.shape, oc):
                return {"vr": zeros(p.shape[:-1]),
                        "vc": zeros(p.shape[:-2] + p.shape[-1:])}
            return {"v": zeros(p.shape)}

        return pm.tree_map(per_param, params)

    # --- update ---------------------------------------------------------------
    @torch.no_grad()
    def update(self, params, grads, state, step):
        """One step, written into ``params`` and ``state`` (returned).
        -> (params, state, {"grad_norm", "lr"})."""
        oc = self.oc
        grads, gnorm = clip_by_global_norm(grads, oc.grad_clip)
        lr = float(lr_schedule(oc, step))
        stepf = _f32(step) + 1.0
        mdt = pm.torch_dtype(oc.moment_dtype)

        def write(p, new_p, s, new_s):
            p.copy_(new_p.to(p.dtype))
            for k, v in new_s.items():
                s[k].copy_(v.to(mdt))

        if oc.kind == "adamw":
            bc1 = float(1 - _f32(oc.beta1) ** stepf)
            bc2 = float(1 - _f32(oc.beta2) ** stepf)

            def upd(p, g, s):
                g = g.float()
                m = s["m"].float() * oc.beta1 + (1 - oc.beta1) * g
                v = s["v"].float() * oc.beta2 + (1 - oc.beta2) * g * g
                mhat = m / bc1
                vhat = v / bc2
                u = mhat / (torch.sqrt(vhat) + oc.eps) \
                    + oc.weight_decay * p.float()
                write(p, p.float() - lr * u, s, {"m": m, "v": v})
        else:
            beta2t = float(1.0 - torch.pow(stepf, -oc.decay_rate))

            def upd(p, g, s):
                g = g.float()
                g2 = g * g + 1e-30
                if "vr" in s:
                    vr = s["vr"].float() * beta2t \
                        + (1 - beta2t) * torch.mean(g2, dim=-1)
                    vc = s["vc"].float() * beta2t \
                        + (1 - beta2t) * torch.mean(g2, dim=-2)
                    denom = (vr[..., None] * vc[..., None, :]
                             / (torch.mean(vr, dim=-1, keepdim=True)[..., None]
                                + 1e-30))
                    u = g / (torch.sqrt(denom) + 1e-30)
                    new_s = {"vr": vr, "vc": vc}
                else:
                    v = s["v"].float() * beta2t + (1 - beta2t) * g2
                    u = g / (torch.sqrt(v) + 1e-30)
                    new_s = {"v": v}
                # relative step clipping (RMS-1 style)
                rms = torch.sqrt(torch.mean(torch.square(u)) + 1e-30)
                u = u / torch.clamp(rms, min=1.0)
                u = u + oc.weight_decay * p.float()
                write(p, p.float() - lr * u, s, new_s)

        for p, g, s in _leaves(params, grads, state):
            upd(p, g, s)
        return params, state, {"grad_norm": gnorm, "lr": _f32(lr)}


def _leaves(params, grads, state):
    """(parameter, gradient, its moments) for every leaf of the tree."""
    if isinstance(params, dict):
        for k in sorted(params):
            yield from _leaves(params[k], grads[k], state[k])
    else:
        yield params, grads, state


def make_optimizer(cfg, **overrides) -> Optimizer:
    kind = getattr(cfg, "optimizer", "adamw")
    return Optimizer(OptConfig(kind=kind, **overrides))

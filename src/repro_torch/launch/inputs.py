"""Stand-ins for every model input of the dry run (the counterpart of the
reference's ``launch/inputs.py``).

A stand-in is a tensor on the ``meta`` device: it has a shape and a dtype
and holds no memory, as the reference's ``ShapeDtypeStruct``. The dry run
(``launch/dryrun.py``) counts each input's bytes per rank from these and
their specs, and runs the train, prefill and decode steps on them. The
modality frontends are stubs, as in the reference: the vlm family takes
precomputed patch embeddings, the audio family precomputed frame
embeddings, both at model width. A sharding is a ``sharding.plan.Spec``
over the plan's batch axes.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.configs.base import ModelConfig, ShapeSpec
from repro_torch.models.params import torch_dtype
from repro_torch.sharding.plan import Plan, Spec


def stand_in(shape, dtype) -> torch.Tensor:
    """A meta tensor: a shape and a dtype, no memory."""
    return torch.empty(shape, dtype=dtype, device="meta")


def _extras(cfg: ModelConfig, batch: int) -> Dict[str, Any]:
    dt = torch_dtype(cfg.dtype)
    out: Dict[str, Any] = {}
    if cfg.family == "vlm":
        out["image_embeds"] = stand_in(
            (batch, cfg.num_image_tokens, cfg.d_model), dt)
    if cfg.family == "audio":
        out["audio_frames"] = stand_in(
            (batch, cfg.encoder_frames, cfg.d_model), dt)
    return out


def _extras_specs(cfg: ModelConfig, plan: Plan) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    b = plan.batch_axes
    if cfg.family == "vlm":
        out["image_embeds"] = Spec(b, None, None)
    if cfg.family == "audio":
        out["audio_frames"] = Spec(b, None, None)
    return out


def train_input_specs(cfg: ModelConfig, shape: ShapeSpec):
    B, S = shape.global_batch, shape.seq_len
    return {"tokens": stand_in((B, S), torch.int32),
            "labels": stand_in((B, S), torch.int32), **_extras(cfg, B)}


def train_input_shardings(cfg: ModelConfig, plan: Plan):
    b = plan.batch_axes
    return {"tokens": Spec(b, None), "labels": Spec(b, None),
            **_extras_specs(cfg, plan)}


def prefill_input_specs(cfg: ModelConfig, shape: ShapeSpec):
    B, S = shape.global_batch, shape.seq_len
    return {"tokens": stand_in((B, S), torch.int32), **_extras(cfg, B)}


def prefill_input_shardings(cfg: ModelConfig, plan: Plan):
    return {"tokens": Spec(plan.batch_axes, None),
            **_extras_specs(cfg, plan)}


def decode_input_specs(cfg: ModelConfig, shape: ShapeSpec, model):
    """(cache, tokens, pos) stand-ins; the cache holds ``shape.seq_len``
    entries per slot."""
    B, S = shape.global_batch, shape.seq_len
    cache = model.cache(B, S, device="meta")
    return cache, stand_in((B, 1), torch.int32), stand_in((), torch.int32)


def decode_input_shardings(cfg: ModelConfig, plan: Plan, model,
                           seq_axis=None):
    return (model.cache_specs(seq_axis=seq_axis),
            Spec(plan.batch_axes, None), Spec())

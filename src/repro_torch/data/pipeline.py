"""Deterministic synthetic data pipeline: the port of the reference's
``data/pipeline.py``.

Tokens come from a seeded sparse-bigram generator in numpy, so models have
real structure to learn (loss decreases), every (seed, step, shard) triple
maps to exactly one batch, and the batches equal the reference's bit for
bit: after restoring step k the pipeline resumes at k + 1 with identical
data, for any data-parallel shard count that divides the global batch. The
vlm and audio families' stubbed frontend inputs are drawn from a
``torch.Generator`` seeded per step (the reference draws them from
``jax.random``, whose numbers differ; tests hand the reference's arrays to
both). Batches are int32 ``tokens`` and ``labels`` (B, S) on ``device``
(``None`` is the CUDA card).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Iterator, Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig


@dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    branch: int = 4  # bigram out-degree (lower = easier to learn)


class SyntheticLM:
    """Sparse-bigram token stream: token_{t+1} in successors[token_t]."""

    def __init__(self, dc: DataConfig, device=None):
        self.dc = dc
        self.device = resolve_device(device)
        rng = np.random.default_rng(dc.seed)
        V = dc.vocab_size
        self.successors = rng.integers(0, V, size=(V, dc.branch))

    def batch(self, step: int, shard: int = 0, n_shards: int = 1,
              extras: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
        dc = self.dc
        if dc.global_batch % n_shards:
            raise ValueError(f"{n_shards} shards do not divide a global "
                             f"batch of {dc.global_batch}")
        bs = dc.global_batch // n_shards
        rng = np.random.default_rng(
            (dc.seed * 1_000_003 + step) * 65_537 + shard)
        V = dc.vocab_size
        toks = np.empty((bs, dc.seq_len + 1), np.int32)
        toks[:, 0] = rng.integers(0, V, size=bs)
        choice = rng.integers(0, dc.branch, size=(bs, dc.seq_len))
        for t in range(dc.seq_len):
            toks[:, t + 1] = self.successors[toks[:, t], choice[:, t]]
        toks = torch.from_numpy(toks)
        out = {"tokens": toks[:, :-1].to(self.device),
               "labels": toks[:, 1:].to(self.device)}
        if extras:
            out.update(extras)
        return out


def _stub(seed: int, shape, device) -> torch.Tensor:
    """0.1 N(0, 1) float32 from a generator seeded with ``seed``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return 0.1 * torch.randn(shape, generator=gen, dtype=torch.float32,
                             device=device)


def make_iterator(cfg: ModelConfig, dc: DataConfig, start_step: int = 0,
                  shard: int = 0, n_shards: int = 1,
                  device=None) -> Iterator[Dict[str, Any]]:
    """Per-host sharded iterator with the modality stubs' extras."""
    src = SyntheticLM(dc, device)
    step = start_step
    bs = dc.global_batch // n_shards
    while True:
        extras: Dict[str, Any] = {}
        if cfg.family == "vlm":
            extras["image_embeds"] = _stub(
                dc.seed * 7 + step, (bs, cfg.num_image_tokens, cfg.d_model),
                src.device)
        if cfg.family == "audio":
            extras["audio_frames"] = _stub(
                dc.seed * 11 + step, (bs, cfg.encoder_frames, cfg.d_model),
                src.device)
        yield src.batch(step, shard, n_shards, extras)
        step += 1

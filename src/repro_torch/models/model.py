"""The model facade (the counterpart of the reference's ``models/model.py``):
one API over every family of the registry (dense, moe with GQA or MLA, ssm,
hybrid, vlm, audio).

    model = Model(cfg).init(seed)              # random weights, on the card
    model = Model(cfg, device="cpu").load_reference(ref_params)
    logits, aux = model.apply({"tokens": tokens})  # aux: moe_aux, moe_z
    logits, cache = model.prefill({"tokens": tokens}, max_len=...)
    logits, cache = model.decode(tokens, cache, pos, n_valid=...)
    logits, aux = model.loss_forward(masters, batch)  # differentiable
    model.set_weights(masters)  # after an optimizer step

``batch`` is a dict: ``tokens`` (B, S), and the stubbed frontends' inputs
at model width, ``image_embeds`` (B, num_image_tokens, d_model) for the vlm
family and ``audio_frames`` (B, encoder_frames, d_model) for audio
(``models/multimodal.py``).

``Model`` is an ``nn.Module`` that holds the stacked parameters under the
reference's tree paths (``blocks.stack.attn.wq``, ``blocks.groups.ssm.wB``,
...), stored in ``cfg.param_dtype``. The reference casts each weight to
``cfg.dtype`` at every use; the port keeps one cast copy, made when the
weights are set, which gives the same values (at full width a fresh cast
of llama3.2-1b's 1.24 B parameters on every tick would move ~7.4 GB).

``Model(cfg, plan=...)`` takes a sharding plan (``sharding.plan``), as the
reference's ``Model(cfg, plan)`` does: the plan's padded heads, KV heads and
vocabulary size the parameters and the caches (``make_plan(cfg, None)``
without one: the config's own heads, the vocabulary padded to 128), and
:meth:`Model.cache_specs` gives the caches' partition specs. The forward
reads its widths off the weights, so a padded model runs as any other.

Training (``repro_torch.train``) differentiates :meth:`Model.loss_forward`,
which casts a tree of float32 masters at use inside the graph, as the
reference casts, and runs each block under activation checkpointing when
``cfg.remat == "full"`` (``transformer.run_block``). After each optimizer
step :meth:`Model.set_weights` takes the updated masters, so ``apply``,
``prefill`` and serving read the trained weights.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Optional

import torch
from torch import nn

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models import multimodal as mm
from repro_torch.models import params as pm
from repro_torch.models import transformer as tf
from repro_torch.models.layers import cdt
from repro_torch.sharding.plan import Plan, make_plan

# leaves the reference casts to the compute dtype at use; the rest (norm
# scales and biases, qk-norm scales, the mamba blocks' A_log and norm) it
# reads in float32
CAST_KEYS = frozenset({"wq", "wk", "wv", "wo", "wg", "wu", "wd", "router",
                       "embedding", "unembed", "gate", "wz", "wx", "wB",
                       "wC", "wdt", "conv_w", "conv_b", "D", "dt_bias",
                       "q_down", "q_up", "kv_down", "k_up", "v_up"})


class _Tree(nn.Module):
    """A nested dict of parameters as nested modules, so that
    ``named_parameters()`` gives the reference's tree paths."""

    def __init__(self, tree: Dict[str, Any]):
        super().__init__()
        for k, v in tree.items():
            if isinstance(v, dict):
                self.add_module(k, _Tree(v))
            else:
                self.register_parameter(
                    k, nn.Parameter(v, requires_grad=False))

    def tree(self) -> Dict[str, Any]:
        out = {k: p for k, p in self._parameters.items()}
        out.update({k: m.tree() for k, m in self._modules.items()})
        return out


def _cast(tree, dtype, key=None, detach: bool = True):
    """The tree with its ``CAST_KEYS`` leaves in ``dtype``; without
    ``detach`` the casts are recorded by autograd, so gradients flow back to
    the tree's leaves."""
    if isinstance(tree, dict):
        return {k: _cast(v, dtype, k, detach) for k, v in tree.items()}
    t = tree.detach() if detach else tree
    return t.to(dtype) if key in CAST_KEYS else t


def _tokens(x, device) -> torch.Tensor:
    return torch.as_tensor(x, device=device).long()


class _Family(NamedTuple):
    """A family's functions, and the batch key of its frontend's
    embeddings, which its apply and prefill take after the tokens (None:
    tokens only)."""
    params: Callable
    apply: Callable
    prefill: Callable
    decode: Callable
    cache: Callable
    cache_specs: Callable
    frontend: Optional[str]


_LM = _Family(tf.lm_params, tf.lm_apply, tf.lm_prefill, tf.lm_decode,
              tf.lm_cache, tf.lm_cache_specs, None)
_MULTIMODAL = {
    "vlm": _Family(mm.vlm_params, mm.vlm_apply, mm.vlm_prefill,
                   mm.vlm_decode, mm.vlm_cache, mm.vlm_cache_specs,
                   "image_embeds"),
    "audio": _Family(mm.whisper_params, mm.whisper_apply, mm.whisper_prefill,
                     mm.whisper_decode, mm.whisper_cache,
                     mm.whisper_cache_specs, "audio_frames"),
}


class Model(nn.Module):
    def __init__(self, cfg: ModelConfig, *, plan: Optional[Plan] = None,
                 device=None):
        super().__init__()
        tf.check_supported(cfg)
        self.cfg = cfg
        self.plan = make_plan(cfg, None) if plan is None else plan
        self.device = resolve_device(device)
        self._compute: Optional[Dict[str, Any]] = None

    @property
    def _family(self) -> _Family:
        return _MULTIMODAL.get(self.cfg.family, _LM)

    def _inputs(self, batch: Dict[str, Any]) -> tuple:
        """The batch as the family's apply and prefill take it: the tokens,
        then the frontend's embeddings where the family reads them."""
        toks = _tokens(batch["tokens"], self.device)
        key = self._family.frontend
        if key is None:
            return (toks,)
        return toks, torch.as_tensor(batch[key], device=self.device)

    # --- params -----------------------------------------------------------
    def param_meta(self):
        return self._family.params(self.cfg, self.plan)

    def n_params(self) -> int:
        return pm.n_params(self.param_meta())

    def init(self, seed: int) -> "Model":
        """Random weights with the reference's init rules, drawn from a
        ``torch.Generator`` seeded with ``seed`` on the model's device."""
        gen = torch.Generator(device=self.device)
        gen.manual_seed(int(seed))
        return self.set_weights(pm.materialize(self.param_meta(), gen,
                                        self.cfg.param_dtype, self.device))

    def load_reference(self, tree) -> "Model":
        """The reference's parameter tree (numpy arrays under the same keys)
        as the model's weights, in ``cfg.param_dtype``."""
        dt = pm.torch_dtype(self.cfg.param_dtype)
        tree = pm.tree_map(lambda t: t.to(dt), pm.from_reference(
            tree, self.device))
        return self.set_weights(tree)

    def set_weights(self, tree) -> "Model":
        """Take ``tree`` (the reference's nesting and shapes, in
        ``cfg.param_dtype``) as the stored weights, without a copy, and
        make the compute copy: after an optimizer step the model serves
        the updated weights."""
        want = pm.tree_map(lambda m: tuple(m.shape), self.param_meta())
        got = pm.tree_map(lambda t: tuple(t.shape), tree)
        if want != got:
            raise ValueError("the parameter tree does not match the "
                             "config's shapes")
        for k, v in tree.items():  # embed, final_ln, blocks
            self.add_module(k, _Tree(v))
        self._compute = _cast(self.weights(), cdt(self.cfg))
        return self

    def weights(self) -> Dict[str, Any]:
        """The stored parameters as a nested dict (the reference's tree)."""
        return {k: m.tree() for k, m in self._modules.items()}

    @property
    def params(self) -> Dict[str, Any]:
        """The weights in the compute dtype (norm scales in float32)."""
        if self._compute is None:
            raise RuntimeError("the model has no weights: call init(seed) or "
                               "load_reference(tree) first")
        return self._compute

    # --- forward ------------------------------------------------------------
    @torch.no_grad()
    def apply(self, batch: Dict[str, Any]):
        return self._family.apply(self.params, *self._inputs(batch),
                                  self.cfg)

    def loss_forward(self, masters, batch: Dict[str, Any]):
        """The forward that training differentiates: ``masters`` (a weight
        tree such as :meth:`weights`, float32) cast to ``cfg.dtype`` inside
        the graph for the ``CAST_KEYS`` leaves, so that gradients reach the
        masters, and each block under activation checkpointing when
        ``cfg.remat == "full"``. The casts are made once per call, where
        the reference casts at every use: the same values, but a leaf read
        twice (tied embeddings, zamba2's shared block) sums its two
        gradients in ``cfg.dtype`` before the cast back. -> (logits, aux)."""
        return self._family.apply(_cast(masters, cdt(self.cfg), detach=False),
                                  *self._inputs(batch), self.cfg)

    # --- serving ------------------------------------------------------------
    @torch.no_grad()
    def prefill(self, batch: Dict[str, Any], max_len: Optional[int] = None,
                lengths=None):
        return self._family.prefill(self.params, *self._inputs(batch),
                                    self.cfg, self.plan, max_len,
                                    lengths=lengths)

    @torch.no_grad()
    def decode(self, tokens, cache, pos, n_valid=None, block_table=None,
               scratch_table=None, null_page=None, idle_slots=None):
        """Ragged decode: ``pos`` scalar or (B,) per-slot; tokens (B,S),
        S >= 1 for attention stacks and S = 1 for the recurrent families;
        ``n_valid`` (B,) marks real tokens per row. The cache (or, with
        ``block_table``, the page pool; ``scratch_table``: each slot's
        scratch pages for a wrapping ring; ``null_page``: the pool's page
        that unallocated table entries name; ``idle_slots``: the slots
        with no real token, host ints, None for any) is updated in place.
        The vlm and audio families take the contiguous cache only, as the
        reference's do."""
        toks = _tokens(tokens, self.device)
        if self._family.frontend is not None:
            if block_table is not None:
                raise ValueError(f"the {self.cfg.family} family decodes on "
                                 f"the contiguous cache only")
            return self._family.decode(self.params, toks, cache, pos,
                                       self.cfg, n_valid=n_valid)
        return tf.lm_decode(self.params, toks, cache, pos, self.cfg,
                            n_valid=n_valid, block_table=block_table,
                            scratch_table=scratch_table, null_page=null_page,
                            idle_slots=idle_slots)

    def cache(self, batch_size: int, max_len: int, device=None):
        """The zero decode cache, on the model's device unless ``device``
        is given (``"meta"`` gives its layout without allocating)."""
        return self._family.cache(self.cfg, self.plan, batch_size, max_len,
                                  cdt(self.cfg), device or self.device)

    def cache_specs(self, seq_axis=None):
        """The partition specs of :meth:`cache`'s tree under the plan."""
        return self._family.cache_specs(self.cfg, self.plan, seq_axis)

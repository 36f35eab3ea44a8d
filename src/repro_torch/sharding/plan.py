"""Sharding plan: logical axes -> mesh axes, dimension padding, ZeRO specs
(the counterpart of the reference's ``sharding/plan.py``, with its
arithmetic unchanged).

Mesh axis conventions (see ``launch/mesh.py``):
  - ``pod``   outer data axis across pods (also the pipeline axis when PP>1)
  - ``data``  within-pod data-parallel axis
  - ``model`` tensor/expert-parallel axis

Logical parameter axes used by the model definitions:
  vocab, heads, kv_heads, ffn, experts, expert_ffn, dinner, ssm_heads,
  embed (d_model — replicated), layers (stack dim — replicated).

A mesh is either a ``torch.distributed.device_mesh.DeviceMesh`` with named
dimensions, or a shape-only mesh (``launch.mesh.MeshShape``, or anything
with a ``shape`` dict of axis sizes and ``axis_names``) for plans of meshes
larger than any process here can hold. A spec is a :class:`Spec`, a tuple
with one entry per tensor dimension (None, a mesh axis name, or a tuple of
names), standing in for the reference's ``PartitionSpec``;
:meth:`Plan.param_shardings` turns it into ``torch.distributed.tensor``
placements on a ``DeviceMesh``.

The plan sizes the model's heads, KV heads and vocabulary
(``models.model.Model(cfg, plan=...)``). PyTorch places tensors explicitly
and has no sharding hint, so :meth:`Plan.act` returns its input. The
train step across ranks (``sharding/spmd.py``, ``train/step.py``) places
its tensors itself: masters at :meth:`Plan.param_shardings`, gathered per
microbatch (or once per step with ``hoist_gather``) to
:meth:`Plan.tp_shardings`, each data rank's rows of a microbatch, which
form the MoE layer's dispatch groups by data shard as the reference's do
under a mesh, and with ``sequence_parallel`` (the ``"seq"`` rule on the
model axis) the residual stream's sequence split over the model axis
between the tensor-parallel blocks.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Any, Dict, NamedTuple, Optional, Tuple

import numpy as np

from repro_torch.configs.base import ModelConfig, pad_to_multiple
from repro_torch.models import params as pm


def _lcm(a: int, b: int) -> int:
    return a * b // math.gcd(a, b)


class Spec(tuple):
    """A partition spec: per tensor dimension, None (replicated), a mesh
    axis name, or a tuple of names (sharded over their product); a tuple
    of one name is that name, as ``PartitionSpec`` canonicalises it."""

    def __new__(cls, *entries):
        return super().__new__(cls, (
            e[0] if isinstance(e, tuple) and len(e) == 1 else e
            for e in entries))

    def __repr__(self) -> str:
        return f"Spec{tuple(self)!r}"


class Sharding(NamedTuple):
    """Where a tensor lives: a ``DeviceMesh`` and one ``Shard`` or
    ``Replicate`` placement per mesh dimension (what
    ``torch.distributed.tensor.distribute_tensor`` takes)."""
    mesh: Any
    placements: Tuple[Any, ...]


def mesh_axes(mesh) -> Dict[str, int]:
    """{axis name: size} of a ``DeviceMesh`` (``mesh_dim_names`` with a
    tuple ``shape``) or of a shape-only mesh (``axis_names`` with a
    ``shape`` dict); {} for None."""
    if mesh is None:
        return {}
    names = getattr(mesh, "mesh_dim_names", None)
    if names is None:
        names = mesh.axis_names
    shape = mesh.shape
    if isinstance(shape, dict):
        return {a: int(shape[a]) for a in names}
    return dict(zip(names, (int(n) for n in shape)))


@dataclass(frozen=True)
class Plan:
    """Resolved parallelism plan for (cfg, mesh)."""

    mesh: Optional[Any]
    tp: int
    dp_axes: Tuple[str, ...]  # ('pod','data') | ('data',) | ()
    tp_axis: Optional[str]
    expert_mode: str  # 'ep' | 'tp' | 'none'
    # effective (padded) model dims
    num_heads: int
    num_kv_heads: int
    kv_repeat: int  # how many times each original kv head is replicated
    vocab: int
    sequence_parallel: bool = False
    zero_opt: bool = True  # ZeRO-1 optimizer-state sharding over dp
    fsdp: bool = True  # fully-shard params over dp axes too (FSDP/ZeRO-3)
    replicate_batch: bool = False  # batch too small for dp (long_500k B=1)
    rules: Dict[str, Optional[str]] = field(default_factory=dict)

    # -- parameter specs ----------------------------------------------------
    def spec(self, logical: Tuple[Optional[str], ...]) -> Spec:
        return Spec(*(self.rules.get(ax) if ax else None for ax in logical))

    def param_spec(self, meta: pm.ParamMeta) -> Spec:
        """Param spec; with FSDP the largest replicated dim also shards
        over dp."""
        if self.fsdp:
            return zero_spec(meta, self)
        return self.spec(meta.logical)

    def param_specs(self, meta_tree):
        return pm.tree_map(self.param_spec, meta_tree)

    def param_shardings(self, meta_tree):
        """Per leaf, a :class:`Sharding` on the plan's ``DeviceMesh``:
        ``Shard(dim)`` on each mesh dimension that the leaf's spec names
        for tensor dimension ``dim``, ``Replicate()`` on the others. An
        optimizer state's meta tree (``Optimizer.state_meta``) takes it as
        the parameters' does."""
        return self.shardings(self.param_specs(meta_tree))

    def tp_shardings(self, meta_tree):
        """Per leaf, the :class:`Sharding` of its tensor-parallel spec
        alone (``spec(meta.logical)``: replicated over the data axes),
        where ``hoist_gather`` and each microbatch gather the masters
        to."""
        return self.shardings(pm.tree_map(lambda m: self.spec(m.logical),
                                           meta_tree))

    def shardings(self, spec_tree):
        """A tree of :class:`Spec` s as :class:`Sharding` s on the plan's
        ``DeviceMesh``."""
        from torch.distributed.tensor import Replicate, Shard
        if self.mesh is None or not hasattr(self.mesh, "mesh_dim_names"):
            raise ValueError("shardings need the plan's mesh to be a "
                             "DeviceMesh with named dimensions")
        names = self.mesh.mesh_dim_names

        def place(spec):
            dims = {}
            for dim, entry in enumerate(spec):
                for ax in (entry if isinstance(entry, tuple)
                           else (entry,) if entry else ()):
                    dims[ax] = dim
            return Sharding(self.mesh, tuple(
                Shard(dims[ax]) if ax in dims else Replicate()
                for ax in names))

        return pm.tree_map(place, spec_tree)

    # -- activation specs ---------------------------------------------------
    @property
    def batch_axes(self):
        if self.replicate_batch or not self.dp_axes:
            return None
        return self.dp_axes

    def act(self, x, *logical):
        """The identity: PyTorch places tensors explicitly and has no
        sharding hint for the reference's ``with_sharding_constraint``."""
        return x


def make_plan(
    cfg: ModelConfig,
    mesh=None,
    *,
    sequence_parallel: bool = False,
    seq_shard_decode: bool = False,
    zero_opt: bool = True,
    fsdp: bool = True,
    replicate_batch: bool = False,
) -> Plan:
    """Resolve a parallelism plan for ``cfg`` on ``mesh``.

    ``sequence_parallel``: the train step across ranks splits the residual
    stream along the sequence over the model axis (``sharding/spmd.py``);
    serving reads nothing of it.

    ``seq_shard_decode``: shard decode KV caches / sequences over the data
    axis (used by ``long_500k`` where global_batch=1 cannot feed the data
    axis).
    """
    sizes = mesh_axes(mesh)
    if mesh is None:
        tp, dp_axes, tp_axis = 1, (), None
    else:
        tp = sizes["model"] if "model" in sizes else 1
        tp_axis = "model" if "model" in sizes else None
        dp_axes = tuple(a for a in ("pod", "data") if a in sizes)

    # --- head padding / kv replication so TP divides everything -----------
    num_heads = pad_to_multiple(cfg.num_heads, tp) if cfg.num_heads else 0
    if cfg.num_kv_heads:
        kvh = cfg.num_kv_heads
        if kvh % tp and cfg.num_heads % tp == 0:
            # replicate kv heads up to a per-group multiple of tp
            target = _lcm(kvh, tp)
            kv_repeat = target // kvh
            kvh = target
        elif kvh % tp:
            # heads themselves padded (whisper 12H -> 16H): pad kv too
            kvh, kv_repeat = num_heads, 1
        else:
            kv_repeat = 1
    else:
        kvh, kv_repeat = 0, 1

    vocab = pad_to_multiple(cfg.vocab_size, max(128, tp))

    # --- expert sharding mode ---------------------------------------------
    if cfg.num_experts == 0:
        expert_mode = "none"
    elif cfg.num_experts % tp == 0:
        expert_mode = "ep"  # experts across the model axis
    else:
        expert_mode = "tp"  # TP inside each expert (mixtral: 8 < 16)

    rules: Dict[str, Optional[str]] = {
        "vocab": tp_axis,
        "heads": tp_axis,
        "kv_heads": tp_axis,
        "ffn": tp_axis,
        "dinner": tp_axis,
        "ssm_heads": tp_axis,
        "experts": tp_axis if expert_mode == "ep" else None,
        "expert_ffn": tp_axis if expert_mode == "tp" else None,
        "layers": None,
        "embed": None,
        "seq": ("data" if seq_shard_decode
                else (tp_axis if sequence_parallel else None)),
        "image_tokens": None,
    }

    return Plan(
        mesh=mesh, tp=tp, dp_axes=dp_axes, tp_axis=tp_axis,
        expert_mode=expert_mode, num_heads=num_heads, num_kv_heads=kvh,
        kv_repeat=kv_repeat, vocab=vocab,
        sequence_parallel=sequence_parallel, zero_opt=zero_opt, fsdp=fsdp,
        replicate_batch=replicate_batch, rules=rules,
    )


# --- ZeRO: shard the largest replicated dim over the data axes ---------------

def zero_spec(meta: pm.ParamMeta, plan: Plan) -> Spec:
    """Fully-sharded spec: base spec + largest replicated dim over dp
    axes."""
    base = list(plan.spec(meta.logical))
    while len(base) < len(meta.shape):
        base.append(None)
    if not plan.dp_axes or plan.mesh is None:
        return Spec(*base)
    sizes = mesh_axes(plan.mesh)
    dp_size = int(np.prod([sizes[a] for a in plan.dp_axes]))
    # choose the largest dim that is unsharded and divisible by dp
    cand = [
        (meta.shape[i], i)
        for i in range(len(meta.shape))
        if (base[i] is None and meta.shape[i] % dp_size == 0
            and meta.shape[i] >= dp_size)
    ]
    if not cand:
        return Spec(*base)
    _, i = max(cand)
    base[i] = plan.dp_axes if len(plan.dp_axes) > 1 else plan.dp_axes[0]
    return Spec(*base)


def zero_specs(meta_tree, plan: Plan):
    return pm.tree_map(lambda m: zero_spec(m, plan), meta_tree)

"""The train step across ranks: tensor parallelism inside the model's
forward and FSDP over the data axes, on a ``DeviceMesh`` of
``("data", "model")`` or ``("pod", "data", "model")``.

Parameters and optimizer state are ``DTensor`` s placed by the plan's
``param_shardings`` (the FSDP placement: the plan's tensor-parallel spec
plus the largest replicated dimension over the data axes). For a
microbatch each rank all-gathers its masters over the data axes to their
tensor-parallel placement (:func:`gather`, whose backward reduce-scatters
the gradient back to the FSDP placement) and runs the model on its local
tensors: its share of the heads, the MLP's columns and the vocabulary.
Inside a :func:`region` the model's layers call Megatron's two operators
(:func:`enter`: identity forward, all-reduce of the gradient; :func:`leave`:
all-reduce forward, identity backward) at the edges of each tensor-parallel
block, look tokens up in a vocabulary-sharded embedding (:func:`embed`) and
take the loss over vocabulary-sharded logits (``train.loss``). Where every
rank reads a sum whole that each holds a part of, the third operator,
:func:`all_sum`, all-reduces both ways. Where each sits:

- ``enter``: the input of the attention, MLP and Mamba2 blocks (the SSM's
  ``x``), the MoE experts' tokens and combine weights (not the router's
  input: the router, its top-k and its losses run whole on every rank),
  MLA's latents (``q_down`` / ``kv_down`` after their norms, ``k_rope``),
  and whole weights that each rank's heads read alone (qk-norm's scales,
  the SSM's ``wB`` and ``wC``): each one's gradient sums over the model
  axis.
- ``leave``: after each row-parallel output projection (attention's and
  MLA's ``wo``, the MLP's down product, the SSM's ``wo``), after the
  experts' combine (a rank's experts, ``ep``, or every expert's columns,
  ``tp``), the embedding lookup and the loss's log-sum-exp and gold logit.
- ``all_sum`` over the model axis: the Mamba2 gated norm's sum of squares
  over ``d_inner`` split across the ranks; over the data axes: the MoE
  router's mean probabilities and its z-loss over the dispatch groups of
  every data rank (the reference's ``router_topk`` over ``(n_dp, gs, E)``
  logits), with the aux terms counted once in the summed loss.

Under sequence parallelism (``make_plan(..., sequence_parallel=True)``,
the reference's ``"seq"`` rule on the model axis) the residual stream
between the tensor-parallel blocks is split along the sequence over the
model axis: each rank holds ``(B, S / tp, D)`` of it. Megatron's two
sequence operators take the place of ``enter`` and ``leave`` at a block's
edges (:func:`enter_seq`, :func:`leave_seq`): :func:`seq_gather`
(all-gather along dim 1 forward, reduce-scatter backward) and
:func:`seq_scatter` (reduce-scatter along dim 1 forward, all-gather
backward). Where each sits:

- ``seq_scatter``: after the embedding's lookup and every block's output
  projection (attention's, the MLP's, the SSM's, the MoE combine).
- ``seq_gather``: the input of the attention, MLP and Mamba2 blocks and of
  the unembedding (the loss keeps the whole sequence).
- :func:`seq_gather_whole` (all-gather forward, this rank's chunk of the
  gradient backward): the input of the MoE layer and of MLA, which read
  it whole on every rank (the router; the down projections) and enter
  what their heads read themselves, so the gradient that comes back is
  whole already. The MoE layer's dispatch groups stay those of the step
  without the flag.
- :func:`seq_param` (``enter`` under the flag): the replicated weights
  read on a sequence shard, the norms' scales and biases and the cross
  blocks' gates, whose gradients are partial sums.

Weights and inputs that are not split along the sequence keep ``enter``
(the image embeddings, the encoder output, the MoE combine weights), and
whisper's encoder runs whole over the model axis
(:func:`no_sequence_split`), as the reference puts no ``"seq"`` on it.

Outside a region every one of them is the identity, and serving is
untouched. A region's "data" group spans every data axis of the mesh
(:func:`dp_group`: ``pod`` and ``data`` together on a 3-D mesh), so the
loss's token count and the router's sums cover every data rank.

The collectives are ``torch.distributed`` 's own on the mesh's process
groups: all-reduce, all-gather and reduce-scatter into tensors. Gloo runs
each of them on CUDA tensors, which is how several ranks share one card
(NCCL refuses two ranks on one GPU). ``DTensor.redistribute`` from
``Shard`` to ``Replicate`` crashed a gloo rank on CUDA tensors on the H100
(PyTorch 2.11), so no all-gather here goes through DTensor:
:func:`full_tensor` is the gather the tests and the card's checks use.
"""
from __future__ import annotations

import contextlib
import math
from typing import NamedTuple, Optional

import torch
import torch.distributed as dist


class MetaGroup(NamedTuple):
    """A process group in shape only, for a run on meta tensors (the dry
    run): its size and this rank's index in it. Its collectives give
    their outputs' shapes and move nothing: an all-reduce copies, a
    gather multiplies the gathered dimension by ``size``, a scatter
    divides it."""
    size: int
    rank: int = 0


def group_size(group) -> int:
    """The ranks of ``group`` (a process group or a :class:`MetaGroup`)."""
    if isinstance(group, MetaGroup):
        return group.size
    return dist.get_world_size(group)


def group_rank(group) -> int:
    """This rank's index in ``group`` (a process group or a
    :class:`MetaGroup`)."""
    if isinstance(group, MetaGroup):
        return group.rank
    return dist.get_rank(group)


class Region(NamedTuple):
    """The process groups of a forward across ranks: ``tp`` over the
    model axis (and this rank's index in it), ``dp`` over the data axes
    (the loss's token count sums over it; None: one rank); ``seq``: the
    residual stream split along the sequence over ``tp`` (sequence
    parallelism)."""
    tp: Optional[object]
    tp_rank: int
    dp: Optional[object]
    seq: bool = False

    def group(self, axis: str):
        """The group of ``axis``, "model" or "data" (every data axis;
        None: one rank)."""
        if axis not in ("model", "data"):
            raise ValueError(f"a region's axes are model and data, not "
                             f"{axis!r}")
        return self.tp if axis == "model" else self.dp


#: the region the model's layers read (None: one rank, every operator of
#: this module the identity); set by :func:`region`
REGION: Optional[Region] = None


@contextlib.contextmanager
def region(tp_group=None, dp_group=None, seq: bool = False):
    """Within the block the model's forward runs tensor-parallel over
    ``tp_group`` (and with ``seq`` sequence-parallel over it too); the
    groups may be :class:`MetaGroup` s. The previous region is restored
    on exit."""
    global REGION
    prev = REGION
    REGION = Region(tp_group,
                    group_rank(tp_group) if tp_group is not None else 0,
                    dp_group, bool(seq and tp_group is not None))
    try:
        yield REGION
    finally:
        REGION = prev


@contextlib.contextmanager
def no_sequence_split():
    """Within the block the current region's activations are whole along
    the sequence (whisper's encoder): the sequence operators act as
    ``enter`` and ``leave``. A block run under activation checkpointing
    opens it inside the checkpointed function, so that its recomputed
    forward takes the same operators."""
    global REGION
    prev = REGION
    if REGION is not None:
        REGION = REGION._replace(seq=False)
    try:
        yield
    finally:
        REGION = prev


def all_reduce(x: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """A reduced copy of ``x`` over ``group`` (x itself untouched)."""
    y = x.clone()
    if group is not None and not isinstance(group, MetaGroup):
        dist.all_reduce(y, op=op, group=group)
    return y


class _Enter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.group), None


class _Leave(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def enter(x: torch.Tensor) -> torch.Tensor:
    """The input of a tensor-parallel block (replicated over the model
    axis): the identity, whose gradient sums the ranks' partial ones."""
    if REGION is None or REGION.tp is None:
        return x
    return _Enter.apply(x, REGION.tp)


def leave(x: torch.Tensor) -> torch.Tensor:
    """A block's partial output summed over the model axis; each rank's
    gradient flows back unchanged."""
    if REGION is None or REGION.tp is None:
        return x
    return _Leave.apply(x, REGION.tp)


class _AllSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.group), None


def size(axis: str = "model") -> int:
    """The ranks of the current region's ``axis`` (1 outside a region)."""
    group = None if REGION is None else REGION.group(axis)
    return 1 if group is None else group_size(group)


def all_sum(x: torch.Tensor, axis: str = "model") -> torch.Tensor:
    """The sum of the ranks' ``x`` over the region's ``axis`` ("model" or
    "data"), whose gradient is the sum of the ranks' gradients too: for a
    value that every rank reads whole, built from parts each rank holds
    (neither :func:`enter` nor :func:`leave` alone: the first sums only
    the gradient, the second only the value)."""
    group = None if REGION is None else REGION.group(axis)
    if group is None:
        return x
    return _AllSum.apply(x, group)


def embed(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """Rows of a vocabulary-sharded table (this rank's ``V / tp`` rows
    from ``tp_rank * V / tp``): each rank looks up the tokens in its rows,
    zeros for the others, and the sum over the model axis is the lookup
    (under sequence parallelism this rank's chunk of the sequence of it:
    :func:`leave_seq`)."""
    r = REGION
    n = table.shape[0]
    local = tokens.long() - r.tp_rank * n
    mine = (local >= 0) & (local < n)
    rows = table[local.clamp(0, n - 1)] * mine[..., None].to(table.dtype)
    return leave_seq(rows)


# --- sequence parallelism: the residual stream split along the sequence --------

def _check_seq(S: int, n: int) -> None:
    if S % n:
        raise ValueError(f"sequence parallelism: a sequence of S = {S} does "
                         f"not split evenly over tp = {n} ranks")


class _SeqGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _gather_dim(x, 1, group)

    @staticmethod
    def backward(ctx, g):
        return _scatter_dim(g, 1, ctx.group), None


class _SeqScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        _check_seq(x.shape[1], group_size(group))
        return _scatter_dim(x, 1, group)

    @staticmethod
    def backward(ctx, g):
        return _gather_dim(g, 1, ctx.group), None


class _SeqGatherWhole(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.n, ctx.rank = group_size(group), group_rank(group)
        return _gather_dim(x, 1, group)

    @staticmethod
    def backward(ctx, g):
        return g.chunk(ctx.n, dim=1)[ctx.rank].contiguous(), None


def seq_gather(x: torch.Tensor, group) -> torch.Tensor:
    """The ranks' sequence shards ``x`` (B, S / n, ...) of ``group``
    joined along dim 1 in rank order, (B, S, ...); the backward
    reduce-scatters the gradient along dim 1 (its readers' partial
    gradients summed, this rank's chunk kept)."""
    return _SeqGather.apply(x, group)


def seq_scatter(x: torch.Tensor, group) -> torch.Tensor:
    """This rank's chunk along dim 1 of the sum of the ranks' ``x`` (B, S,
    ...) over ``group``, (B, S / n, ...); the backward all-gathers the
    gradient along dim 1. Raises ``ValueError`` where S does not split
    evenly over the group."""
    return _SeqScatter.apply(x, group)


def seq_gather_whole(x: torch.Tensor, group) -> torch.Tensor:
    """:func:`seq_gather` forward, for readers whose gradient comes back
    whole on every rank (their own ``enter`` s summed it): the backward
    keeps this rank's chunk of it and moves nothing."""
    return _SeqGatherWhole.apply(x, group)


def seq_on() -> bool:
    """Whether the current region splits the residual stream along the
    sequence."""
    return REGION is not None and REGION.seq


def enter_seq(x: torch.Tensor) -> torch.Tensor:
    """The input of a tensor-parallel block: under sequence parallelism
    the sequence gathered (:func:`seq_gather`), else :func:`enter`."""
    if seq_on():
        return seq_gather(x, REGION.tp)
    return enter(x)


def leave_seq(x: torch.Tensor) -> torch.Tensor:
    """A block's partial output: under sequence parallelism this rank's
    sequence chunk of its sum (:func:`seq_scatter`), else :func:`leave`."""
    if seq_on():
        return seq_scatter(x, REGION.tp)
    return leave(x)


def whole_seq(x: torch.Tensor) -> torch.Tensor:
    """The input of a layer that reads it whole on every rank and enters
    what its heads read itself (the MoE layer, MLA): under sequence
    parallelism the sequence gathered (:func:`seq_gather_whole`), else x."""
    if seq_on():
        return seq_gather_whole(x, REGION.tp)
    return x


def seq_param(w: torch.Tensor) -> torch.Tensor:
    """A replicated weight read on the residual stream: under sequence
    parallelism it reads a sequence shard, so its gradient is a partial
    sum over the model axis (:func:`enter`); else w."""
    return enter(w) if seq_on() else w


def seq_chunk(x: torch.Tensor) -> torch.Tensor:
    """This rank's chunk along dim 1 of ``x``, whole on every rank, under
    sequence parallelism (a position table of the residual stream's
    rows); else x."""
    if not seq_on():
        return x
    n = group_size(REGION.tp)
    _check_seq(x.shape[1], n)
    return x.chunk(n, dim=1)[REGION.tp_rank]


# --- the data axes: their group, FSDP's gather and scatter -------------------

#: the groups :func:`dp_group` built, by (id of the mesh, axes): (the mesh,
#: the group), so that each is built once
_DP_GROUPS: dict = {}


def dp_group(mesh, axes):
    """The process group over the mesh dimensions ``axes`` together (the
    data axes, ``plan.dp_axes``) that holds this rank: the mesh's own group
    for one axis, None for none. For two, every rank builds one group for
    each coordinate of the other dimensions, in the same order (as
    ``torch.distributed.new_group`` asks), and keeps its own."""
    axes = tuple(axes)
    if not axes:
        return None
    if len(axes) == 1:
        return mesh.get_group(axes[0])
    key = (id(mesh), axes)
    if key not in _DP_GROUPS:
        names = mesh.mesh_dim_names
        dims = [names.index(a) for a in axes]
        rest = [i for i in range(mesh.ndim) if i not in dims]
        ranks = mesh.mesh.permute(*rest, *dims).reshape(
            -1, math.prod(mesh.size(i) for i in dims))
        me, mine = dist.get_rank(), None
        for row in ranks.tolist():
            group = dist.new_group(row)
            if me in row:
                mine = group
        _DP_GROUPS[key] = (mesh, mine)
    return _DP_GROUPS[key][1]


def _gather_dim(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The ranks' ``x`` of ``group`` joined along ``dim``, in rank order
    (a :class:`MetaGroup`: an empty tensor of that shape)."""
    n = group_size(group)
    if isinstance(group, MetaGroup):
        shape = list(x.shape)
        shape[dim] *= n
        return x.new_empty(shape)
    x = x.contiguous()
    out = torch.empty((n * x.shape[0],) + tuple(x.shape[1:]), dtype=x.dtype,
                      device=x.device)
    dist.all_gather_into_tensor(out, x, group=group)
    return out if dim == 0 else torch.cat(out.chunk(n), dim=dim)


def _scatter_dim(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """This rank's chunk along ``dim`` of the sum of ``x`` over ``group``
    (a :class:`MetaGroup`: an empty tensor of its shape)."""
    n = group_size(group)
    parts = x.chunk(n, dim=dim)
    out = torch.empty_like(parts[0], memory_format=torch.contiguous_format)
    if not isinstance(group, MetaGroup):
        dist.reduce_scatter_tensor(out, torch.cat(parts).contiguous(),
                                   group=group)
    return out


def _moves(mesh, src, dst):
    """(tensor dim, mesh dim's group) of each mesh dimension where ``src``
    shards a tensor dimension that ``dst`` replicates, in mesh order."""
    from torch.distributed.tensor import Replicate, Shard
    out = []
    for i, (a, b) in enumerate(zip(src, dst)):
        if a == b:
            continue
        if not (isinstance(a, Shard) and isinstance(b, Replicate)):
            raise ValueError(f"only Shard -> Replicate moves, got {a} -> "
                             f"{b}")
        out.append((a.dim, mesh.get_group(i)))
    return out


def gather_local(local: torch.Tensor, mesh, src, dst) -> torch.Tensor:
    """This rank's tensor at placements ``dst`` from its shard at ``src``
    (all-gathers where ``src`` shards a dimension ``dst`` replicates), no
    gradient."""
    for dim, group in reversed(_moves(mesh, src, dst)):
        local = _gather_dim(local, dim, group)
    return local


def scatter_local(g: torch.Tensor, mesh, src, partial) -> torch.Tensor:
    """A gradient, partial over the mesh dimensions ``partial`` (the data
    axes: each rank's from its own rows), summed over them and cut to this
    rank's shard at placements ``src``: a reduce-scatter where ``src``
    shards a tensor dimension over the mesh dimension, an all-reduce
    where it replicates."""
    from torch.distributed.tensor import Shard
    for i in partial:
        group = mesh.get_group(i)
        if isinstance(src[i], Shard):
            g = _scatter_dim(g, src[i].dim, group)
        else:
            g = all_reduce(g, group)
    return g


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, local, mesh, src, dst, partial):
        ctx.args = (mesh, src, partial)
        return gather_local(local, mesh, src, dst)

    @staticmethod
    def backward(ctx, g):
        return scatter_local(g, *ctx.args), None, None, None, None


def gather(local: torch.Tensor, mesh, src, dst, partial) -> torch.Tensor:
    """:func:`gather_local` with a gradient: the backward sums the ranks'
    gradients over the mesh dimensions ``partial`` back to this rank's
    shard (:func:`scatter_local`), FSDP's pair of collectives."""
    return _Gather.apply(local, mesh, src, dst, partial)


class _Hoisted(torch.autograd.Function):
    @staticmethod
    def forward(ctx, local, full, mesh, src, partial):
        ctx.args = (mesh, src, partial)
        return full

    @staticmethod
    def backward(ctx, g):
        return scatter_local(g.float(), *ctx.args), None, None, None, None


def hoisted(local: torch.Tensor, full: torch.Tensor, mesh, src,
            partial) -> torch.Tensor:
    """``full``, a gather of ``local`` made before the graph
    (``hoist_gather``), read in the graph as ``local`` 's: the backward
    reduce-scatters its gradient in float32 to ``local`` 's shard
    (:func:`scatter_local`, the reference's ``scatter_grad``), leaf by leaf
    as the backward produces them, so no more than one leaf's gathered
    gradient is held at once."""
    return _Hoisted.apply(local, full, mesh, src, partial)


def check_even(shape, mesh, placements, name: str = "tensor") -> None:
    """Raise where a placement would cut a dimension into unequal shards
    (the collectives here move equal ones)."""
    from torch.distributed.tensor import Shard
    for i, p in enumerate(placements):
        if isinstance(p, Shard) and shape[p.dim] % mesh.size(i):
            raise ValueError(
                f"{name}: dimension {p.dim} of {tuple(shape)} does not "
                f"split evenly over mesh dimension {i} of size "
                f"{mesh.size(i)}")


# --- DTensors from and to full tensors ---------------------------------------

def place(full: torch.Tensor, sharding):
    """``full`` (the same on every rank) as a ``DTensor`` at
    ``sharding`` 's mesh and placements: this rank cuts its own shard
    (chunks in mesh order, as ``DTensor`` lays shards out) and keeps a
    copy of it alone; no collective runs."""
    from torch.distributed.tensor import DTensor, Shard
    coord = sharding.mesh.get_coordinate()
    local = full
    for i, p in enumerate(sharding.placements):
        if isinstance(p, Shard):
            local = local.chunk(sharding.mesh.size(i), dim=p.dim)[coord[i]]
    return DTensor.from_local(local.clone(memory_format=torch.contiguous_format),
                              sharding.mesh, sharding.placements,
                              run_check=False, shape=full.shape,
                              stride=full.stride())


def zeros(shape, dtype, sharding, device):
    """A zero ``DTensor`` of global ``shape`` at ``sharding``, each rank
    allocating its shard alone (even splits, :func:`check_even`)."""
    from torch.distributed.tensor import DTensor, Shard
    check_even(shape, sharding.mesh, sharding.placements)
    local = list(shape)
    for i, p in enumerate(sharding.placements):
        if isinstance(p, Shard):
            local[p.dim] //= sharding.mesh.size(i)
    full_stride = torch.empty(shape, device="meta").stride()
    return DTensor.from_local(
        torch.zeros(local, dtype=dtype, device=device), sharding.mesh,
        sharding.placements, run_check=False, shape=torch.Size(shape),
        stride=full_stride)


def full_tensor(x) -> torch.Tensor:
    """The whole tensor of a ``DTensor`` on every rank, gathered with
    all-gathers into tensors (a plain tensor is returned as it is)."""
    from torch.distributed.tensor import DTensor, Replicate
    if not isinstance(x, DTensor):
        return x
    mesh = x.device_mesh
    return gather_local(x.to_local(), mesh, x.placements,
                        [Replicate()] * mesh.ndim)

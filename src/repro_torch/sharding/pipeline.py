"""Pipeline parallelism: GPipe-style microbatch streaming over a process
group (the counterpart of the reference's ``sharding/pipeline.py``).

``pipeline_apply`` maps P stages onto the P ranks of a process group, each
rank holding one stage's parameters. The reference's schedule runs M + P - 1
ticks for M microbatches (bubble fraction (P-1)/(M+P-1), the GPipe bound):
at tick t stage 0 takes microbatch t, stage i the microbatch that stage
i - 1 finished at tick t - 1, and the last stage emits microbatch
t - (P-1). Activations go to the next rank by point-to-point ``send`` /
``recv`` (the reference's ``ppermute`` ring, whose wrap from the last stage
to the first it ignores), a send overlapping the next microbatch's
compute; at the end the last stage's outputs are broadcast to every rank,
as the reference's ``all_gather`` replicates them. A stage only computes
the ticks where it holds a real microbatch (the reference computes every
tick and discards the idle ones), so the outputs are those of the stages
composed one microbatch at a time, bit for bit.

Gloo's point-to-point ops take CPU tensors only, and NCCL refuses two ranks
on one GPU. So on one card the ranks run a gloo group: each computes its
stage on the card and moves its activations through pinned host memory
(one device-to-host copy before a send, one host-to-device copy after a
recv). On the CPU the same code runs with no copies.
"""
from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist


def _host_buffer(like: torch.Tensor) -> torch.Tensor:
    """A host tensor shaped as ``like`` (pinned when ``like`` is on the
    card, so the copies can run asynchronously)."""
    if like.device.type == "cpu":
        return torch.empty_like(like)
    return torch.empty(like.shape, dtype=like.dtype, pin_memory=True)


def pipeline_apply(stage_fn: Callable, stage_params, x: torch.Tensor,
                   group, n_microbatches: int) -> torch.Tensor:
    """Run ``stage_fn(params_i, x) -> x`` through the P stages of ``group``
    (this rank's stage: ``stage_params``; its index: its rank in the
    group). ``x``: (B, ...), the global batch, given on every rank (stage 0
    reads it), B % n_microbatches == 0. Returns, on every rank,
    stage_{P-1}(...stage_0(x)) for every microbatch, reassembled, on
    ``x``'s device."""
    n_stages = dist.get_world_size(group)
    idx = dist.get_rank(group)
    M = n_microbatches
    B = x.shape[0]
    if B % M:
        raise ValueError(f"{M} microbatches do not divide the batch of {B}")
    xs = x.reshape((M, B // M) + tuple(x.shape[1:]))
    prev = dist.get_global_rank(group, idx - 1) if idx > 0 else None
    nxt = (dist.get_global_rank(group, idx + 1)
           if idx < n_stages - 1 else None)
    last = n_stages - 1
    outs = None
    inbox = outbox = pending = None
    for t in range(M + n_stages - 1):
        m = t - idx  # the microbatch this stage holds at tick t
        if not 0 <= m < M:
            continue
        if prev is None:
            buf = xs[m]
        else:
            if inbox is None:
                inbox = _host_buffer(xs[0])
            dist.recv(inbox, src=prev, group=group)
            # a blocking copy: the next recv reuses the host buffer
            buf = inbox.to(x.device)
        buf = stage_fn(stage_params, buf)
        if nxt is None:
            if outs is None:
                outs = torch.empty((M,) + tuple(buf.shape), dtype=buf.dtype,
                                   device=buf.device)
            outs[m] = buf
            continue
        if pending is not None:
            pending.wait()  # the previous send has left the host buffer
        if outbox is None:
            outbox = _host_buffer(buf)
        outbox.copy_(buf)  # waits for the card: the send reads the host
        pending = dist.isend(outbox, dst=nxt, group=group)
    if pending is not None:
        pending.wait()
    # replicate the last stage's outputs to every rank
    root = dist.get_global_rank(group, last)
    spec = [(tuple(outs.shape), outs.dtype) if idx == last else None]
    dist.broadcast_object_list(spec, src=root, group=group)
    shape, dtype = spec[0]
    host = outs.cpu() if idx == last else torch.empty(shape, dtype=dtype)
    dist.broadcast(host, src=root, group=group)
    out = outs if idx == last else host.to(x.device)
    return out.reshape((B,) + shape[2:])

"""Cross-entropy LM loss with z-loss and masking (labels < 0 are padding):
the port of the reference's ``train/loss.py``.

Inside an ``sharding.spmd.region`` (the train step across ranks) the
logits are this rank's share of the vocabulary and its rows of the batch:
the log-sum-exp, the gold logit and the argmax combine over the model axis,
and the means divide by the real tokens of every data rank's rows, so
that the ranks' losses sum to the loss of the whole batch."""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.sharding import spmd


def lm_loss(logits, labels, z_coef: float = 1e-4):
    """logits (B, S, V) -- a padded vocabulary is fine: labels index real
    rows only -- and labels (B, S) -> (loss, metrics). The logits are taken
    in float32; ``nll`` and the z-loss are means over the real tokens,
    ``tokens`` is their count (at least 1)."""
    if spmd.REGION is not None:
        return _sharded_lm_loss(logits, labels, z_coef, spmd.REGION)
    logits = logits.float()
    labels = labels.long()
    mask = (labels >= 0).float()
    labels_safe = labels.clamp(min=0)
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels_safe[..., None])[..., 0]
    nll = (lse - gold) * mask
    z = lse.square() * mask
    denom = mask.sum().clamp(min=1.0)
    loss = nll.sum() / denom
    zloss = z_coef * z.sum() / denom
    acc = ((logits.argmax(-1) == labels_safe) * mask).sum() / denom
    return loss + zloss, {"nll": loss, "z_loss": zloss, "accuracy": acc,
                          "tokens": denom}


def _sharded_lm_loss(logits, labels, z_coef, r: spmd.Region):
    """:func:`lm_loss` over logits (B, S, V / tp) holding vocabulary rows
    ``[tp_rank * V / tp, (tp_rank + 1) * V / tp)``: the log-sum-exp from
    the ranks' maxima and sums of exponentials, the gold logit from the
    rank that holds it, the argmax the first index of the largest logit.
    The sums over the real tokens are this rank's rows' and ``tokens`` is
    the count over every data rank: the loss and metrics are this rank's
    shares of the batch's (they sum over the data axis to them)."""
    logits = logits.float()
    labels = labels.long()
    n = logits.shape[-1]
    lo = r.tp_rank * n
    mask = (labels >= 0).float()
    labels_safe = labels.clamp(min=0)
    m = spmd.all_reduce(logits.detach().amax(-1), r.tp, dist.ReduceOp.MAX)
    lse = torch.log(spmd.leave(torch.exp(logits - m[..., None]).sum(-1))) + m
    local = labels_safe - lo
    mine = (local >= 0) & (local < n)
    gold = torch.gather(logits, -1, local.clamp(0, n - 1)[..., None])[..., 0]
    gold = spmd.leave(gold * mine)
    nll = (lse - gold) * mask
    z = lse.square() * mask
    denom = spmd.all_reduce(mask.sum(), r.dp).clamp(min=1.0)
    loss = nll.sum() / denom
    zloss = z_coef * z.sum() / denom
    # the argmax: the largest logit over the ranks, then its first index
    best, idx = logits.detach().max(-1)
    top = spmd.all_reduce(best, r.tp, dist.ReduceOp.MAX)
    first = torch.where(best == top, idx + lo,
                        torch.full_like(idx, torch.iinfo(idx.dtype).max))
    arg = spmd.all_reduce(first, r.tp, dist.ReduceOp.MIN)
    acc = ((arg == labels_safe) * mask).sum() / denom
    return loss + zloss, {"nll": loss, "z_loss": zloss, "accuracy": acc,
                          "tokens": denom}

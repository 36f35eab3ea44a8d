"""Cross-entropy LM loss with z-loss and masking (labels < 0 are padding):
the port of the reference's ``train/loss.py``."""
from __future__ import annotations

import torch


def lm_loss(logits, labels, z_coef: float = 1e-4):
    """logits (B, S, V) -- a padded vocabulary is fine: labels index real
    rows only -- and labels (B, S) -> (loss, metrics). The logits are taken
    in float32; ``nll`` and the z-loss are means over the real tokens,
    ``tokens`` is their count (at least 1)."""
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

"""Gradients and the port's kernels.

A kernel writes its output through a pointer (``ctypes``), so on the card
that output has no ``grad_fn``: a gradient would stop at the kernel without
an error. Two kernels sit on a path that training differentiates, the flash
attention and the Mamba2 scan; their wrappers hand a call that needs a
gradient to an ``autograd.Function`` (``flash_attention.FlashAttention``,
``mamba_scan.MambaScan``) whose forward is the kernel (its plain version on
the CPU) and whose backward is plain PyTorch, as the reference's backward
is plain XLA (no Pallas kernel of the reference has a ``custom_vjp``). The
other wrappers (paged attention, the int8 products, the stencil, the fused
multigrid solve) refuse such a call (:func:`refuse_grad`).
"""
from __future__ import annotations

import torch


def wants_grad(*tensors) -> bool:
    """Whether autograd records and one of ``tensors`` requires a gradient
    (``None`` entries are skipped)."""
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors)


def refuse_grad(name: str, *tensors) -> None:
    """Raise where a call of the kernel ``name`` would need a gradient: its
    output would carry none."""
    if wants_grad(*tensors):
        raise RuntimeError(
            f"{name} has no backward: call it under torch.no_grad() or on "
            f"inputs that do not require a gradient")

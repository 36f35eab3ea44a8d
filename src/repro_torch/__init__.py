"""repro_torch — the PyTorch/CUDA port of the thermal-margin voltage-scaling
flow (Algorithm 1 and Algorithm 2 on the FPGA substrate).

The package mirrors ``repro``'s module tree (``core/``, ``policy/``,
``kernels/``) and computes the same functions on tensors. Every public entry
point takes ``device=None``, which means the CUDA card: without a card the
call raises instead of running on the CPU. Pass ``device="cpu"`` to run on
the CPU, where the kernels' plain PyTorch versions stand in for them.
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``cuda`` (or raise without a card); anything else as given."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "port on the CPU")
    return dev

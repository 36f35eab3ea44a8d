"""repro_torch — the PyTorch/CUDA port of the thermal-margin voltage-scaling
flow (Algorithm 1 and Algorithm 2 on the FPGA substrate).

The package mirrors ``repro``'s module tree (``core/``, ``policy/``,
``kernels/``) and computes the same functions on tensors. Every public entry
point takes ``device=None``, which means the CUDA card: without a card the
call raises instead of running on the CPU. Pass ``device="cpu"`` to run on
the CPU, where the kernels' plain PyTorch versions stand in for them.
"""
from __future__ import annotations

import numpy as np
import torch


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``cuda`` (or raise without a card); anything else as given."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "port on the CPU")
    return dev


def to_device(x, device, dtype=torch.float32) -> torch.Tensor:
    """A host array (or scalar) as a ``dtype`` tensor on ``device``. On the
    card the copy goes through pinned memory and does not wait for the
    device: a blocking copy from pageable memory would synchronise the
    host with the stream (one host sync per upload)."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=dtype)
    t = torch.as_tensor(np.asarray(x), dtype=dtype)
    if torch.device(device).type != "cuda":
        return t
    return t.pin_memory().to(device, non_blocking=True)

"""Public wrappers around the port's kernels (the counterpart of
``repro.kernels.ops``). Each dispatches on its tensors' device: the plain
PyTorch version on the CPU, the Hopper kernel on CUDA."""
from __future__ import annotations

from repro_torch.kernels.thermal_stencil import thermal_stencil as _stencil


def thermal_sweep(T, P, diag, *, g_lat, g_v_tamb, iters=64, phase=None):
    return _stencil(T, P, diag, g_lat=g_lat, g_v_tamb=g_v_tamb, iters=iters,
                    phase=phase)

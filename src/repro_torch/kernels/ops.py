"""Public wrappers around the port's kernels (the counterpart of
``repro.kernels.ops``). Each dispatches on its tensors' device: the plain
PyTorch version on the CPU, the Hopper kernel on CUDA."""
from __future__ import annotations

from repro_torch.kernels.abft_matmul import abft_matmul as _abft
from repro_torch.kernels.overscale_matmul import overscale_matmul as _omm
from repro_torch.kernels.thermal_stencil import thermal_stencil as _stencil


def thermal_sweep(T, P, diag, *, g_lat, g_v_tamb, iters=64, phase=None):
    return _stencil(T, P, diag, g_lat=g_lat, g_v_tamb=g_v_tamb, iters=iters,
                    phase=phase)


def overscale_mm(a, b, u_gate, u_bit, cdf):
    return _omm(a, b, u_gate, u_bit, cdf)


def abft_mm(a, b, u_gate, u_bit, cdf):
    """Error-injected int8 matmul with fused row/column checksums:
    -> (c, rowsum, colsum)."""
    return _abft(a, b, u_gate, u_bit, cdf)

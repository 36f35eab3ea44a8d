"""Fused multi-sweep thermal stencil: the Hopper kernel and its plain version.

Replaces the TPU kernel ``repro/kernels/thermal_stencil.py::thermal_stencil``
(and its oracle ``repro/kernels/ref.py::thermal_stencil_ref``). K sweeps of

    T <- ((P + g_v_tamb) + g_lat * (((up + dn) + lf) + rt)) / diag

on B float32 grids with zero-padded borders; ``phase=None`` runs Jacobi
sweeps, ``phase=0|1`` red-black Gauss-Seidel sweeps starting on the colour
``(row + col) % 2 == phase``.

The kernel (``csrc/thermal_stencil.cu``) is bound by bytes: a call must read
T, P and diag once and write T once, 16 B per cell when every input is per
grid (about 0.04 us for one 92x92 grid at 3.35 TB/s; a diag shared across
the batch is read once), so launch latency dominates the smoother's calls.
Grids whose T fits one block's shared memory run resident, one CTA per grid
with all K sweeps fused in one launch; larger grids run one launch per
colour half-sweep (or per Jacobi sweep). See the source for the design.

``thermal_stencil`` dispatches on the tensor's device: a CPU tensor goes to
``thermal_stencil_ref``, a CUDA tensor to the kernel (or an error is
raised). ``thermal_stencil.launches`` counts its kernel launches.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels.grad import refuse_grad

_KERNEL = "thermal_stencil"


def nbr_sum(T: torch.Tensor) -> torch.Tensor:
    """((up + dn) + lf) + rt over the last two axes, zero-padded borders."""
    up = F.pad(T[..., 1:, :], (0, 0, 0, 1))
    dn = F.pad(T[..., :-1, :], (0, 0, 1, 0))
    lf = F.pad(T[..., :, 1:], (0, 1))
    rt = F.pad(T[..., :, :-1], (1, 0))
    return up + dn + lf + rt


@functools.lru_cache(maxsize=64)
def _parity(m: int, n: int, device: torch.device) -> torch.Tensor:
    row = torch.arange(m, device=device)[:, None]
    col = torch.arange(n, device=device)[None, :]
    return (row + col) % 2


def thermal_stencil_ref(T, P, diag, g_lat: float, g_v_tamb: float,
                        iters: int, phase: Optional[int] = None):
    """The plain PyTorch version. T, P, diag: (..., m, n), broadcasting."""
    if phase is None:
        for _ in range(iters):
            T = (P + g_v_tamb + g_lat * nbr_sum(T)) / diag
        return T
    par = _parity(T.shape[-2], T.shape[-1], T.device)
    for _ in range(iters):
        for p in (phase, 1 - phase):
            T = torch.where(par == p,
                            (P + g_v_tamb + g_lat * nbr_sum(T)) / diag, T)
    return T


@functools.lru_cache(maxsize=1)
def _lib() -> ctypes.CDLL:
    from repro_torch.kernels import _build
    lib = _build.load(_KERNEL)
    lib.thermal_stencil_smem_optin.argtypes = []
    lib.thermal_stencil_smem_optin.restype = ctypes.c_int
    lib.thermal_stencil_launch.argtypes = (
        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_longlong] * 2
        + [ctypes.c_float] * 2 + [ctypes.c_int] * 3 + [ctypes.c_void_p])
    lib.thermal_stencil_launch.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def smem_optin(device_index: int) -> int:
    """Bytes of shared memory one block may use on that card."""
    with torch.cuda.device(device_index):
        got = _lib().thermal_stencil_smem_optin()
    if got < 0:
        raise RuntimeError(f"cudaDeviceGetAttribute failed with code {-got}")
    return got


def is_resident(m: int, n: int, phase: Optional[int],
                device: torch.device) -> bool:
    """Whether the grid's T (two buffers for Jacobi) fits shared memory."""
    need = 4 * m * n * (2 if phase is None else 1)
    return need <= smem_optin(device.index if device.index is not None
                              else torch.cuda.current_device())


def _batch_stride(x: torch.Tensor, B: int, m: int, n: int, name: str) -> int:
    if x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError(f"{name} must be a contiguous float32 tensor")
    if x.shape == (m, n) or x.shape == (1, m, n):
        return 0
    if x.shape == (B, m, n):
        return m * n
    raise ValueError(f"{name} has shape {tuple(x.shape)}; expected "
                     f"({m}, {n}) or ({B}, {m}, {n})")


def thermal_stencil(T: torch.Tensor, P: torch.Tensor, diag: torch.Tensor, *,
                    g_lat: float, g_v_tamb: float, iters: int = 64,
                    phase: Optional[int] = None) -> torch.Tensor:
    """``iters`` fused sweeps. T: (B, m, n) or (m, n) float32; P and diag
    of the same shape, or (m, n) to share one grid across the batch."""
    refuse_grad("thermal_stencil", T, P, diag)
    if T.device.type == "cpu":
        return thermal_stencil_ref(T, P, diag, g_lat, g_v_tamb, iters, phase)
    if T.device.type != "cuda":
        raise ValueError(f"thermal_stencil runs on CPU or CUDA tensors, "
                         f"not {T.device}")
    if phase not in (None, 0, 1):
        raise ValueError(f"phase must be None, 0 or 1, got {phase!r}")
    if T.dtype != torch.float32 or T.dim() not in (2, 3):
        raise ValueError("T must be a (B, m, n) or (m, n) float32 tensor")
    for x, name in ((P, "P"), (diag, "diag")):
        if x.device != T.device:
            raise ValueError(f"{name} is on {x.device}, T on {T.device}")
    B, m, n = (1, *T.shape) if T.dim() == 2 else T.shape
    p_stride = _batch_stride(P, B, m, n, "P")
    d_stride = _batch_stride(diag, B, m, n, "diag")
    out = T.contiguous().clone()
    if iters <= 0 or out.numel() == 0:
        return out
    resident = is_resident(m, n, phase, T.device)
    scratch = (torch.empty_like(out) if phase is None and not resident
               else None)
    with torch.cuda.device(T.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _lib().thermal_stencil_launch(
            out.data_ptr(), P.data_ptr(), diag.data_ptr(),
            None if scratch is None else scratch.data_ptr(),
            B, m, n, p_stride, d_stride, float(g_lat), float(g_v_tamb),
            int(iters), -1 if phase is None else int(phase), int(resident),
            stream)
    if err != 0:
        raise RuntimeError(f"thermal_stencil launch failed: CUDA error {err}")
    thermal_stencil.launches += kernel_launches(iters, phase, resident)
    return out


def kernel_launches(iters: int, phase: Optional[int], resident: bool) -> int:
    """Kernel launches of one call: the resident shape fuses every sweep in
    one; the global shape launches once per colour half-sweep (red-black)
    or per sweep (Jacobi)."""
    if resident:
        return 1
    return iters * (1 if phase is None else 2)


thermal_stencil.launches = 0

"""One launch per multigrid thermal solve: the Hopper kernel and its plain
version.

Replaces, on the card, what the reference runs as one jitted program per
solve (``repro/core/thermal.py::_solve_multigrid``, :201-266): V-cycles
whose smoother is the TPU stencil kernel (``repro/kernels/
thermal_stencil.py``, ``pallas_call`` at :82, called from
``repro/core/thermal.py:168-181``), the coarse direct solve, and the stop
test inside ``jax.lax.while_loop``. Per batch element, on the levels of a
``Plan`` (finest first, the last one the direct tier):

- the full-multigrid cold start when ``T0`` is None (the right-hand side
  restricted to every level, the direct solve, then prolongation and one
  V-cycle per level on the way up);
- V-cycles: ``n_smooth`` red-black sweeps (red first), the residual
  ``b - (diag * T - g_lat * nbr_sum(T))``, its 2x2 block sum
  ``((r00 + r01) + r10) + r11``, the next level (the direct tier's
  ``A_inv @ b`` as products summed by a halving tree over the row padded
  to ``coarse_width``), the bilinear prolongation rows first, then columns,
  each ``w0 * e0 + w1 * e1``, added to T, ``n_smooth`` post-sweeps;
- after each cycle the stop test on ``s = max |r| / diag``:
  ``(s > tol) & (s < 0.9 * s_prev) & (cycles < max_cycles)``.

The kernel (``thermal_mg_solve_launch`` in ``csrc/thermal_stencil.cu``)
runs one CTA per grid that loops until its own element stops, with every
level's T and the coarse levels' right-hand sides in shared memory; it
writes T and the cycle counts and the host reads nothing during the solve.
``plan_fits`` says, from the shapes alone, whether a plan fits one CTA's
shared memory (every grid of the FPGA paths does, up to mcml's 152x152;
256x256 does not).

``thermal_mg_solve_ref`` is the same algorithm in PyTorch, in the kernel's
order of operations (each operation rounded on its own, as the kernel's
``-fmad=false`` build rounds), batched in lockstep with an element whose
stop test is met frozen, so the kernel equals it bit for bit in T and in the
cycle counts. Its smoother is a parameter (the stencil's plain version by
default; the stencil kernel for a grid whose plan does not fit), and it
reads the stop test on the host once per cycle.

``thermal_mg_solve`` dispatches on the tensor's device: a CPU tensor goes
to ``thermal_mg_solve_ref``, a CUDA tensor to the kernel (or an error is
raised). ``thermal_mg_solve.launches`` counts its kernel launches.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.kernels import thermal_stencil as TS
from repro_torch.kernels.grad import refuse_grad
from repro_torch.kernels.thermal_stencil import nbr_sum, thermal_stencil_ref

MAX_LEVELS = 16  # kMaxLevels in the source
LANE_VALUES = 16  # kLaneValues: the coarse product's values per lane
WARP = 32
MAX_COARSE_WIDTH = WARP * LANE_VALUES


class Plan(NamedTuple):
    """A multigrid hierarchy on one device."""
    dims: Tuple[Tuple[int, int], ...]  # (m, n) per level, finest first
    g_lat: float
    diags: Tuple[torch.Tensor, ...]  # (m, n) float32 views of diag_flat
    # per level but the last: row index (m, 2) int64, row weight (m, 2),
    # column index (n, 2), column weight (n, 2) of the prolongation from
    # the next level
    prolong: Tuple[Tuple[torch.Tensor, ...], ...]
    a_inv: torch.Tensor  # (N, N) float32, the direct tier's inverse
    # the kernel's copies: every level's diagonal, then every level's index
    # pairs (int32) and weights, rows then columns, level by level
    diag_flat: torch.Tensor
    idx_flat: torch.Tensor
    w_flat: torch.Tensor
    meta: np.ndarray  # int32, the source's MgPlan


def coarse_width(cells: int) -> int:
    """The coarse product's row width: the direct tier's cells padded to a
    power of two, at least a warp."""
    return max(WARP, 1 << (cells - 1).bit_length())


def _smem_floats(dims) -> int:
    cells = [m * n for m, n in dims]
    return sum(cells) + sum(cells[1:]) + WARP  # T, coarse b, the max


def smem_bytes(dims) -> int:
    """Shared memory of one CTA: every level's T, the coarse levels'
    right-hand sides and one float per warp for the block's max."""
    return 4 * _smem_floats(dims)


def plan_fits(dims, smem_limit: int) -> bool:
    """Whether the kernel takes a hierarchy of these level shapes on a card
    that lets one block use ``smem_limit`` bytes of shared memory."""
    m, n = dims[-1]
    return (2 <= len(dims) <= MAX_LEVELS
            and coarse_width(m * n) <= MAX_COARSE_WIDTH
            and smem_bytes(dims) <= smem_limit)


def fits(plan: Plan, device: torch.device) -> bool:
    """``plan_fits`` on that card."""
    return plan_fits(plan.dims, TS.smem_optin(
        device.index if device.index is not None
        else torch.cuda.current_device()))


def make_plan(dims, diags, tables, a_inv, g_lat: float,
              device: torch.device) -> Plan:
    """Plan from numpy: ``diags`` (m, n) float32 per level, ``tables`` one
    ((row index, row weight), (column index, column weight)) per level but
    the last, ``a_inv`` (N, N) float32."""
    t = lambda a, dt=torch.float32: torch.as_tensor(a, dtype=dt,
                                                    device=device)
    pad = lambda v: list(v) + [0] * (MAX_LEVELS - len(v))
    starts = lambda sizes: [int(x) for x in np.cumsum([0] + sizes)[:-1]]
    cells = [m * n for m, n in dims]
    # every level's T (and diagonal) one after another, then the coarse
    # levels' right-hand sides
    level_off = starts(cells)
    b_off = [0] + [sum(cells) + o for o in starts(cells[1:])]
    idx, wts, row_off, col_off, at = [np.zeros(0)], [np.zeros(0)], [], [], 0
    for (ri, rw), (ci, cw) in tables:
        row_off.append(at)
        col_off.append(at + ri.size)
        at += ri.size + ci.size
        idx += [ri.reshape(-1), ci.reshape(-1)]
        wts += [rw.reshape(-1), cw.reshape(-1)]
    diag_flat = t(np.concatenate([d.reshape(-1) for d in diags]))
    meta = np.array(
        [len(dims), coarse_width(cells[-1]) // WARP, _smem_floats(dims)]
        + pad([m for m, _ in dims]) + pad([n for _, n in dims])
        + pad(level_off) + pad(row_off) + pad(col_off) + pad(level_off)
        + pad(b_off), np.int32)
    return Plan(
        dims=tuple(tuple(d) for d in dims), g_lat=float(g_lat),
        diags=tuple(diag_flat[o:o + m * n].view(m, n)
                    for o, (m, n) in zip(level_off, dims)),
        prolong=tuple((t(ri, torch.int64), t(rw), t(ci, torch.int64), t(cw))
                      for (ri, rw), (ci, cw) in tables),
        a_inv=t(a_inv), diag_flat=diag_flat,
        idx_flat=t(np.concatenate(idx), torch.int32),
        w_flat=t(np.concatenate(wts)), meta=meta)


# --- the plain version -------------------------------------------------------

def restrict(r: torch.Tensor, mc: int, nc: int) -> torch.Tensor:
    """2x2 block sums ((r00 + r01) + r10) + r11 of (B, m, n), zero-padded
    on odd trailing edges."""
    B, m, n = r.shape
    r = F.pad(r, (0, 2 * nc - n, 0, 2 * mc - m))
    return (((r[:, 0::2, 0::2] + r[:, 0::2, 1::2]) + r[:, 1::2, 0::2])
            + r[:, 1::2, 1::2])


def prolong(e: torch.Tensor, table) -> torch.Tensor:
    """Cell-centred bilinear prolongation of (B, mc, nc): rows first, then
    columns, each w0 * e0 + w1 * e1."""
    ri, rw, ci, cw = table
    t = rw[:, :1] * e[:, ri[:, 0], :] + rw[:, 1:] * e[:, ri[:, 1], :]
    return cw[:, 0] * t[:, :, ci[:, 0]] + cw[:, 1] * t[:, :, ci[:, 1]]


def coarse_solve(a_inv: torch.Tensor, bc: torch.Tensor) -> torch.Tensor:
    """``A_inv @ b`` per element of (B, mm, nn): each row's products summed
    by a halving tree (x[j] + x[j + w/2]) over the row padded with zeros to
    ``coarse_width``, so every element rounds the same whatever the batch."""
    B, mm, nn = bc.shape
    N = mm * nn
    w = coarse_width(N)
    x = F.pad(a_inv * bc.reshape(B, 1, N), (0, w - N))
    while w > 1:
        w //= 2
        x = x[..., :w] + x[..., w:]
    return x[..., 0].reshape(B, mm, nn)


def thermal_mg_solve_ref(b: torch.Tensor, T0: Optional[torch.Tensor],
                         plan: Plan, *, tol: float, max_cycles: int,
                         n_smooth: int, smooth=None, any_active=None):
    """The plain PyTorch version. b (B, m, n) float32; T0 None (the
    full-multigrid cold start) or (B, m, n). ``smooth(T, b_l, diag)`` runs
    ``n_smooth`` red-black sweeps (default: the stencil's plain version);
    ``any_active(mask)`` reads a stop test on the host (default
    ``bool(mask.any())``). -> (T (B, m, n), cycles (B,) int32)."""
    g_lat, diags, top = plan.g_lat, plan.diags, len(plan.dims) - 1
    if smooth is None:
        smooth = lambda T, b_l, diag: thermal_stencil_ref(
            T, b_l, diag, g_lat, 0.0, n_smooth, 0)
    if any_active is None:
        any_active = lambda mask: bool(mask.any())

    def residual(lvl, T, b_l):
        return b_l - (diags[lvl] * T - g_lat * nbr_sum(T))

    def vcycle(lvl, T, b_l):
        T = smooth(T, b_l, diags[lvl])
        bc = restrict(residual(lvl, T, b_l), *plan.dims[lvl + 1])
        e = (coarse_solve(plan.a_inv, bc) if lvl + 1 == top
             else vcycle(lvl + 1, torch.zeros_like(bc), bc))
        return smooth(T + prolong(e, plan.prolong[lvl]), b_l, diags[lvl])

    def scaled_residual(T):
        return (residual(0, T, b).abs() / diags[0]).amax(dim=(1, 2))

    if T0 is None:
        bs = [b]
        for lvl in range(1, top + 1):
            bs.append(restrict(bs[-1], *plan.dims[lvl]))
        T0 = coarse_solve(plan.a_inv, bs[top])
        for lvl in range(top - 1, -1, -1):
            T0 = vcycle(lvl, prolong(T0, plan.prolong[lvl]), bs[lvl])

    B = b.shape[0]
    T = T0
    s_prev = torch.full((B,), float("inf"), device=b.device)
    s = scaled_residual(T)  # 0 cycles for an already-converged warm start
    i = torch.zeros((B,), dtype=torch.int32, device=b.device)
    while True:
        # stop when converged under tol OR stalled at the f32 residual
        # floor; each element stops on its own test and stays frozen
        active = (s > tol) & (s < 0.9 * s_prev) & (i < max_cycles)
        if not any_active(active):
            return T, i
        T_new = vcycle(0, T, b)
        s_new = scaled_residual(T_new)
        T = torch.where(active[:, None, None], T_new, T)
        s_prev = torch.where(active, s, s_prev)
        s = torch.where(active, s_new, s)
        i = i + active.to(torch.int32)


# --- the kernel --------------------------------------------------------------

@functools.lru_cache(maxsize=1)
def _lib() -> ctypes.CDLL:
    lib = TS._lib()  # the same library as the stencil's sweeps
    lib.thermal_mg_solve_launch.argtypes = (
        [ctypes.c_void_p] * 9 + [ctypes.c_int] * 2 + [ctypes.c_float] * 2
        + [ctypes.c_int] * 2 + [ctypes.c_void_p])
    lib.thermal_mg_solve_launch.restype = ctypes.c_int
    return lib


def thermal_mg_solve(b: torch.Tensor, T0: Optional[torch.Tensor],
                     plan: Plan, *, tol: float, max_cycles: int,
                     n_smooth: int):
    """One multigrid solve per batch element in one launch. b: (B, m, n)
    contiguous float32; T0: None or the same. -> (T, cycles (B,) int32)."""
    refuse_grad("thermal_mg_solve", b, T0)
    kw = dict(tol=tol, max_cycles=max_cycles, n_smooth=n_smooth)
    if b.device.type == "cpu":
        return thermal_mg_solve_ref(b, T0, plan, **kw)
    if b.device.type != "cuda":
        raise ValueError(f"thermal_mg_solve runs on CPU or CUDA tensors, "
                         f"not {b.device}")
    if (b.dtype != torch.float32 or b.dim() != 3 or not b.is_contiguous()
            or tuple(b.shape[1:]) != plan.dims[0]):
        raise ValueError(f"b must be a contiguous (B, {plan.dims[0][0]}, "
                         f"{plan.dims[0][1]}) float32 tensor")
    if T0 is not None and (T0.dtype != torch.float32 or T0.shape != b.shape
                           or not T0.is_contiguous()
                           or T0.device != b.device):
        raise ValueError("T0 must be None or a contiguous float32 tensor "
                         "of b's shape on b's device")
    if plan.a_inv.device != b.device:
        raise ValueError(f"the plan is on {plan.a_inv.device}, b on "
                         f"{b.device}")
    if not fits(plan, b.device):
        raise ValueError(f"a {plan.dims[0]} hierarchy needs "
                         f"{smem_bytes(plan.dims)} B of shared memory (or "
                         "more levels or a wider coarse product than the "
                         "kernel takes)")
    out = torch.empty_like(b)
    cycles = torch.empty((b.shape[0],), dtype=torch.int32, device=b.device)
    if b.shape[0] == 0:
        return out, cycles
    with torch.cuda.device(b.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _lib().thermal_mg_solve_launch(
            out.data_ptr(), b.data_ptr(),
            None if T0 is None else T0.data_ptr(), plan.diag_flat.data_ptr(),
            plan.a_inv.data_ptr(), plan.idx_flat.data_ptr(),
            plan.w_flat.data_ptr(), cycles.data_ptr(), plan.meta.ctypes.data,
            plan.meta.size, b.shape[0], float(plan.g_lat), float(tol),
            int(max_cycles), int(n_smooth), stream)
    if err != 0:
        raise RuntimeError(f"thermal_mg_solve launch failed: CUDA error {err}")
    thermal_mg_solve.launches += 1
    return out, cycles


thermal_mg_solve.launches = 0

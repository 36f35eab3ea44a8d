"""Mamba2 SSD chunked scan: the Hopper kernel and its plain version.

Replaces the TPU kernel ``repro/kernels/mamba_scan.py::mamba_scan`` (and its
oracle ``repro/kernels/ref.py::mamba_scan_ref``, which is the model's
``ssd_chunked``), batched over b as the reference's ``ops.mamba_scan_b`` is.
Per head h, with ``dA = dt * A[h]`` and ``cum`` its running sum inside a
chunk of Q steps, the scan computes

    y_i = sum_{j <= i} (C_i . B_j) exp(cum_i - cum_j) dt_j x_j
          + exp(cum_i) C_i . state            (the state entering the chunk)
    state <- state exp(cum_{Q-1}) + sum_q exp(cum_{Q-1} - cum_q) dt_q x_q B_q

chunk after chunk, all in float32. xh (b, S, H, P), dt (b, S, H), A (H,)
float32, B and C (b, S, G, N): G groups of state projections, head h
reading group ``h // (H / G)`` inside the kernel, so the model hands over
its (b, S, G, N) projections without the reference's ``repeat`` over heads
(G = H takes per-head B and C, the reference's layout). The result is
``(y, state)``: y (b, S, H, P) in xh's dtype and the final state
(b, H, P, N) in float32, both written by the kernel; the TPU kernel kept the
state in scratch and dropped it, but a prefill seeds decode with it. As in
the TPU kernel, Q = min(chunk, S) and S must be a multiple of Q: any other
length raises (the reference's scan fails on it too).

The kernel (``csrc/mamba_scan.cu``) is bound by operations at the models'
shapes: per chunk and head Q(Q+1)/2 P multiply-adds for the weighted sum
and 2 Q P N for the read-out and the state update, and per chunk and B/C
group Q(Q+1)/2 N for the lower triangle of C B^T, against a few bytes per
element of x, B, C and y. A call enqueues two CUDA launches (``plan`` gives
their grids and shared memory): the first forms C B^T once per (b, group,
chunk) in 32 x 32 tiles into a float32 scratch kept per (device, stream);
the second, one block of 256 threads per (b, h, 32 columns of P), runs the
chunks in sequence with the carried (N, 32) state and the chunk's running
sums in shared memory, reads its group's C B^T for the weights (their
exponentials only where j <= i: the masked entries would overflow), and
sums 4 x 4 register blocks of outputs. Its math is on the CUDA cores in
float32 (tensor-core tiles are later work).

``mamba_scan`` dispatches on xh's device: the plain version for a CPU
tensor, the kernel for a CUDA tensor (or an error).
``mamba_scan.launches`` counts calls that launched the kernel (each call is
two CUDA launches).
"""
from __future__ import annotations

import contextlib
import ctypes
import functools
from typing import NamedTuple, Tuple

import torch

from repro_torch.kernels.grad import wants_grad

_KERNEL = "mamba_scan"
# csrc/mamba_scan.cu's tiles: columns of P per scan block, output rows and
# input rows (or state entries) per tile of the scan block, and the C B^T
# tile of i and of j
P_TILE, ROWS, IN_ROWS, GRAM_TILE = 32, 128, 64, 32
MAX_STATE = 128  # largest N the kernel takes
SMEM_LIMIT = 232448  # bytes of shared memory a block may use on Hopper
GRID_LIMIT = 65535  # blocks along the grid's y and z
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


class Plan(NamedTuple):
    """The two CUDA launches of one call (csrc/mamba_scan.cu's layout)."""
    gram_grid: Tuple[int, int, int]  # (lower-triangular tiles, chunks, b G)
    gram_smem: int  # bytes of shared memory per block
    scan_grid: Tuple[int, int, int]  # (P tiles, H, b)
    scan_smem: int
    scratch_bytes: int  # C B^T, float32 (b, G, chunks, Q, Q)


def chunk_len(S: int, chunk: int) -> int:
    """Q = min(chunk, S); raises unless S is a multiple of Q."""
    Q = min(int(chunk), int(S))
    if Q < 1 or S % Q:
        raise ValueError(
            f"the chunked scan takes a sequence of at most `chunk` steps or "
            f"a multiple of it (the model's ssm_chunk): S = {S}, chunk = "
            f"{chunk}; the reference's scan fails on this length too")
    return Q


def _check_groups(H: int, G: int) -> None:
    if G < 1 or H % G:
        raise ValueError(f"{H} heads do not group over {G} B/C groups")


def _heads(H: int, G: int, device) -> torch.Tensor:
    _check_groups(H, G)
    return torch.arange(H, device=device) // (H // G)


def mamba_scan_ref(xh, dt, A, B, C, *, chunk: int = 256):
    """The plain version: the kernel's arithmetic, one operation at a time,
    over every (b, h) at once; returns (y, state) as the kernel does.

    The chunk's running sum is taken step by step; each ``C_i . B_j`` and
    each read-out ``C_i . state_p`` sums over n in order; the weight of x_j
    in y_i is ``((C_i . B_j) * exp(cum_i - cum_j)) * dt_j`` for j <= i
    (exp of the clamped difference, 0 above the diagonal), and y_i sums
    its weighted x_j over j in order, then adds ``dot * exp(cum_i)``; the
    state update sums ``(coef_q x_q) B_q`` over q in order, with
    ``coef_q = exp(cum_{Q-1} - cum_q) dt_q``. Every step rounds as the
    kernel's does (it is built without fused multiply-adds), so on the
    card the two agree bit for bit. Up to float32 rounding this is the
    reference's ``ssd_chunked``."""
    b, S, H, P = xh.shape
    N = B.shape[-1]
    Q = chunk_len(S, chunk)
    heads = _heads(H, B.shape[2], xh.device)
    x = xh.float().transpose(1, 2)  # (b, H, S, P)
    d = dt.float().transpose(1, 2)  # (b, H, S)
    Bh = B.float()[:, :, heads].transpose(1, 2)  # (b, H, S, N)
    Ch = C.float()[:, :, heads].transpose(1, 2)
    a = A.float()[None, :, None]
    rows = torch.arange(Q, device=xh.device)
    vis = rows[:, None] >= rows[None, :]  # (i, j): j <= i
    zeros = lambda *shape: torch.zeros(shape, dtype=torch.float32,
                                       device=xh.device)
    state = zeros(b, H, P, N)
    ys = []
    for c0 in range(0, S, Q):
        xc, dc, Bc, Cc = (t[:, :, c0:c0 + Q] for t in (x, d, Bh, Ch))
        dA = dc * a
        cum = dA.clone()
        for q in range(1, Q):
            cum[..., q] = cum[..., q - 1] + dA[..., q]
        gm = zeros(b, H, Q, Q)
        for n in range(N):
            gm = gm + Cc[..., :, None, n] * Bc[..., None, :, n]
        diff = cum[..., :, None] - cum[..., None, :]
        L = torch.exp(torch.where(vis, diff, 0.0))
        m = torch.where(vis, (gm * L) * dc[..., None, :], 0.0)
        acc = zeros(b, H, Q, P)
        for j in range(Q):
            acc = acc + m[..., :, j, None] * xc[..., j, None, :]
        dot = zeros(b, H, Q, P)
        for n in range(N):
            dot = dot + Cc[..., :, None, n] * state[:, :, None, :, n]
        ys.append(acc + dot * torch.exp(cum)[..., None])
        last = cum[..., Q - 1:]
        u = (torch.exp(last - cum) * dc)[..., None] * xc  # (b, H, Q, P)
        su = zeros(b, H, P, N)
        for q in range(Q):
            su = su + u[..., q, :, None] * Bc[..., q, None, :]
        state = state * torch.exp(last)[..., None] + su
    y = torch.cat(ys, dim=2).transpose(1, 2).to(xh.dtype).contiguous()
    return y, state


@functools.lru_cache(maxsize=1)
def _lib() -> ctypes.CDLL:
    from repro_torch.kernels import _build
    lib = _build.load(_KERNEL)
    lib.mamba_scan_launch.argtypes = (
        [ctypes.c_void_p] * 8 + [ctypes.c_int] * 8 + [ctypes.c_void_p])
    lib.mamba_scan_launch.restype = ctypes.c_int
    return lib


_SCRATCH: dict = {}


def _scratch(device, stream: int, nbytes: int) -> torch.Tensor:
    """The C B^T scratch of one (device, stream): a float32 buffer of at
    least ``nbytes``, grown as needed and kept (one entry per stream that
    ever ran the scan). Each call's first launch writes the part its second
    reads, and calls on one stream run in order, so no two calls in flight
    share a buffer. Under a CUDA graph capture the buffer comes from the
    graph's own memory pool, fresh for each call: the graph keeps it for
    its replays, and no other graph or stream can hold it."""
    if torch.cuda.is_current_stream_capturing():
        return torch.empty(-(-nbytes // 4), dtype=torch.float32,
                           device=device)
    key = (device, stream)
    buf = _SCRATCH.get(key)
    if buf is None or 4 * buf.numel() < nbytes:
        buf = torch.empty(-(-nbytes // 4), dtype=torch.float32, device=device)
        _SCRATCH[key] = buf
    return buf


def plan(b: int, S: int, H: int, P: int, G: int, N: int, Q: int) -> Plan:
    """The grids, shared memory and scratch of one call; raises on a group
    count that does not divide the heads."""
    _check_groups(H, G)
    n_pad = -(-N // 8) * 8  # rows of B and C in shared memory
    t = -(-Q // GRAM_TILE)
    return Plan(
        gram_grid=(t * (t + 1) // 2, S // Q, b * G),
        gram_smem=4 * 2 * n_pad * GRAM_TILE,
        scan_grid=(-(-P // P_TILE), H, b),
        scan_smem=4 * (IN_ROWS * ROWS + IN_ROWS * P_TILE + n_pad * P_TILE
                       + 3 * Q),
        scratch_bytes=4 * b * G * (S // Q) * Q * Q)


def check_inputs(xh, dt, A, B, C, chunk):
    """Validate the kernel's inputs; return (b, S, H, P, G, N, Q)."""
    if xh.dim() != 4 or B.dim() != 4:
        raise ValueError("xh must be (b, S, H, P) and B, C (b, S, G, N)")
    b, S, H, P = xh.shape
    G, N = B.shape[2], B.shape[3]
    for t, name, shape, dtype in (
            (xh, "xh", (b, S, H, P), xh.dtype), (dt, "dt", (b, S, H), xh.dtype),
            (A, "A", (H,), torch.float32), (B, "B", (b, S, G, N), xh.dtype),
            (C, "C", (b, S, G, N), xh.dtype)):
        if t.device != xh.device:
            raise ValueError(f"{name} is on {t.device}, xh on {xh.device}")
        if t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {dtype} of shape {shape}, got "
                             f"{t.dtype} {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if xh.dtype not in _DTYPES:
        raise ValueError(f"xh must be float32 or bfloat16, got {xh.dtype}")
    if not 1 <= N <= MAX_STATE:
        raise ValueError(f"the kernel takes a state of 1..{MAX_STATE}, got "
                         f"{N}")
    Q = chunk_len(S, chunk)
    p = plan(b, S, H, P, G, N, Q)
    if max(p.gram_smem, p.scan_smem) > SMEM_LIMIT:
        raise ValueError(f"a chunk of {Q} steps does not fit the kernel's "
                         f"shared memory")
    if xh.numel() >= 2 ** 31 or B.numel() >= 2 ** 31:
        raise ValueError("each tensor must hold fewer than 2^31 elements")
    if max(*p.gram_grid[1:], *p.scan_grid[1:]) > GRID_LIMIT:
        raise ValueError(f"b * G, H, b and the chunks must each be at most "
                         f"{GRID_LIMIT}")
    return b, S, H, P, G, N, Q


def mamba_scan(xh, dt, A, B, C, *, chunk: int = 256):
    """xh (b, S, H, P), dt (b, S, H), B and C (b, S, G, N), all float32 or
    all bfloat16, A (H,) float32 -> (y (b, S, H, P) in xh's dtype, final
    state (b, H, P, N) float32). Where autograd records and an input
    requires a gradient the call goes through :class:`MambaScan`."""
    if wants_grad(xh, dt, A, B, C):
        return MambaScan.apply(xh, dt, A, B, C, chunk)
    if xh.device.type == "cpu":
        return mamba_scan_ref(xh, dt, A, B, C, chunk=chunk)
    if xh.device.type == "meta":  # a dry run: the outputs' layout, no work
        b, S, H, P, G, N, Q = check_inputs(xh, dt, A, B, C, chunk)
        return (torch.empty_like(xh),
                torch.empty((b, H, P, N), dtype=torch.float32,
                            device="meta"))
    if xh.device.type != "cuda":
        raise ValueError(f"mamba_scan runs on CPU, CUDA or meta tensors, "
                         f"not {xh.device}")
    b, S, H, P, G, N, Q = check_inputs(xh, dt, A, B, C, chunk)
    y = torch.empty_like(xh)
    state = torch.empty((b, H, P, N), dtype=torch.float32, device=xh.device)
    if y.numel() == 0:
        return y, state.zero_()
    dev = xh.device.index
    with (contextlib.nullcontext() if dev == torch.cuda.current_device()
          else torch.cuda.device(dev)):
        stream = torch._C._cuda_getCurrentRawStream(dev)
        gram = _scratch(xh.device, stream,
                        plan(b, S, H, P, G, N, Q).scratch_bytes)
        err = _lib().mamba_scan_launch(
            xh.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(),
            C.data_ptr(), y.data_ptr(), state.data_ptr(), gram.data_ptr(), b,
            S, H, P, G, N, Q, _DTYPES[xh.dtype], stream)
    if err != 0:
        raise RuntimeError(f"mamba_scan launch failed: CUDA error {err}")
    mamba_scan.launches += 1
    return y, state


mamba_scan.launches = 0


class MambaScan(torch.autograd.Function):
    """:func:`mamba_scan` with a gradient for y: the forward is the kernel
    on the card (its plain version on the CPU); the backward recomputes the
    plain version :func:`mamba_scan_ref` from the saved inputs under
    autograd and differentiates it (plain PyTorch, as the reference's
    backward is plain XLA). The final state is not differentiable: a
    prefill hands it to decode, which trains nothing. On meta tensors (the
    dry run) both give their outputs' layout alone."""

    @staticmethod
    def forward(ctx, xh, dt, A, B, C, chunk):
        y, state = mamba_scan(xh, dt, A, B, C, chunk=chunk)
        ctx.save_for_backward(xh, dt, A, B, C)
        ctx.chunk = chunk
        ctx.mark_non_differentiable(state)
        return y, state

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dy, _dstate):
        need = ctx.needs_input_grad[:5]
        if dy.device.type == "meta":  # a dry run: the gradients' layout
            return (*(torch.empty_like(t) if n else None
                      for t, n in zip(ctx.saved_tensors, need)), None)
        with torch.enable_grad():
            ins = [t.detach().requires_grad_(n)
                   for t, n in zip(ctx.saved_tensors, need)]
            y, _ = mamba_scan_ref(*ins, chunk=ctx.chunk)
            got = iter(torch.autograd.grad(
                y, [t for t in ins if t.requires_grad], dy))
        return (*(next(got) if n else None for n in need), None)

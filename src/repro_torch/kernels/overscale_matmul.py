"""Error-injected int8 matmul — the voltage over-scaling timing simulator.

Replaces the TPU kernel ``repro/kernels/overscale_matmul.py::overscale_matmul``
and its oracle ``repro/kernels/ref.py::overscale_matmul_ref`` (§III-D):
C = A @ B (int8 x int8 -> int32, wrapping mod 2^32), then per output element
one bit flipped with probability ``p_total = cdf[-1]``, the bit drawn from
the per-bit distribution ``cdf``. Randomness enters as two 32-bit planes
(``u_gate``, ``u_bit``) drawn outside, so the kernel is deterministic and
can be held against its plain version.

The planes are uint32 values stored in ``torch.int32`` tensors (the same
bits; PyTorch has few uint32 operations), and both versions read them as
unsigned and round them to float32 to nearest, as XLA does.

``overscale_matmul`` dispatches on the device: a CPU tensor goes to the plain
version ``overscale_matmul_ref``, a CUDA tensor to the hand-written kernel
(``csrc/int8_error_matmul.cu``), or an error is raised.
``overscale_matmul.launches`` counts kernel launches.
"""
from __future__ import annotations

import contextlib
import ctypes
import functools
from dataclasses import dataclass
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.kernels.grad import refuse_grad

_KERNEL = "int8_error_matmul"
TWO_POW_M32 = 1.0 / 4294967296.0
# the reference's requantisation clip: this quantile of |clean product|
CLIP_QUANTILE = 0.9995


# --- plain versions ------------------------------------------------------------

def wrap_int32(x: torch.Tensor) -> torch.Tensor:
    """An int64 tensor reduced mod 2^32 into int32 (two's complement)."""
    return ((x + 2 ** 31) % 2 ** 32 - 2 ** 31).to(torch.int32)


def u32_to_f32(u: torch.Tensor) -> torch.Tensor:
    """int32 storage of uint32 values -> float32, rounded to nearest."""
    return (u.to(torch.int64) & 0xFFFFFFFF).to(torch.float32)


def int_matmul_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """int8 (M, K) x int8 (K, N) -> int32, wrapping mod 2^32. The float64
    product is exact while K * 2^14 < 2^53 (PyTorch has no int32 product
    on CUDA)."""
    acc = torch.matmul(a.to(torch.float64), b.to(torch.float64))
    return wrap_int32(acc.to(torch.int64))


def flip_ref(acc, u_gate, u_bit, cdf):
    """XOR one bit into each element whose gate fires (the kernel's
    epilogue, in the reference's order of rounding)."""
    p_total = cdf[-1]
    u = u32_to_f32(u_gate) * TWO_POW_M32
    flip = u < p_total
    u2 = u32_to_f32(u_bit) * TWO_POW_M32 * p_total
    bit = torch.zeros(acc.shape, dtype=torch.int64, device=acc.device)
    for k in range(1, 33):
        bit += u2 >= cdf[k]
    mask = torch.where(flip, torch.bitwise_left_shift(
        torch.ones_like(bit), torch.clamp(bit, 0, 31)), 0)
    return torch.bitwise_xor(acc, wrap_int32(mask))


def overscale_matmul_ref(a, b, u_gate, u_bit, cdf, *,
                         return_clean: bool = False):
    """The plain PyTorch version: (M, N) int32 with injected errors (and the
    clean product, if asked)."""
    clean = int_matmul_ref(a, b)
    c = flip_ref(clean, u_gate, u_bit, cdf)
    return (c, clean) if return_clean else c


# --- the kernel ----------------------------------------------------------------

@functools.lru_cache(maxsize=1)
def _lib() -> ctypes.CDLL:
    from repro_torch.kernels import _build
    lib = _build.load(_KERNEL)
    tail = [ctypes.c_int] * 8 + [ctypes.c_void_p]  # M K N tile per aw bw vec
    lib.overscale_matmul_launch.argtypes = [ctypes.c_void_p] * 9 + tail
    lib.overscale_matmul_launch.restype = ctypes.c_int
    lib.abft_matmul_launch.argtypes = [ctypes.c_void_p] * 11 + tail
    lib.abft_matmul_launch.restype = ctypes.c_int
    return lib


# --- the kernel's plan (tiles, split-K, load widths) ---------------------------

#: the kernel's output tiles (BM, BN), in the order of its ``tile`` argument:
#: llama's products, M <= 64 (48 tokens), and LeNet's narrow N
TILES = {"wide": (128, 128), "short": (64, 128), "n16": (256, 16),
         "n8": (256, 8)}
_TILE_IDS = {name: i for i, name in enumerate(TILES)}
BK = 64  # values of K per tile
SMS = 132  # streaming multiprocessors of an H100 SXM


@dataclass(frozen=True)
class Plan:
    """How one call runs: the tile, K split ``splits`` ways of ``per``
    64-deep tiles each, A loaded ``a_width`` bytes at a time (16, 8 or 1)
    and B ``b_width`` (16, 8, 4 or 1)."""
    tile: str
    splits: int
    per: int
    a_width: int
    b_width: int


def _align(ptr: int, cap: int = 16) -> int:
    """The largest power of two up to ``cap`` that divides ``ptr``."""
    return cap if ptr % cap == 0 else ptr & -ptr


@functools.lru_cache(maxsize=256)
def plan(M: int, K: int, N: int, sms: int = SMS, a_align: int = 16,
         b_align: int = 16) -> Plan:
    """The tile for the output's shape, and K split across CTAs where the
    output tiles are fewer than ``sms``; loads as wide as the row pitch
    (K for A, N for B) and the operands' alignment allow."""
    if N <= 8:
        tile = "n8"
    elif N <= 16:
        tile = "n16"
    elif M <= 64:
        tile = "short"
    else:
        tile = "wide"
    BM, BN = TILES[tile]
    tiles = -(-M // BM) * -(-N // BN)
    kt = max(1, -(-K // BK))
    want = 1 if tiles >= sms else min(kt, sms // tiles)
    per = -(-kt // want)
    a_width = next(w for w in (16, 8, 1) if K % w == 0 and a_align % w == 0)
    b_width = next(w for w in (16, 8, 4, 1)
                   if w <= BN and N % w == 0 and b_align % w == 0)
    return Plan(tile, -(-kt // per), per, a_width, b_width)


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


_SCRATCH: dict = {}


def _scratch(device, stream: int, tickets: int, partials: int):
    """The split-K scratch of one (device, stream): a zeroed int32 buffer of
    at least ``tickets`` tickets and an int32 buffer of at least
    ``partials`` partial sums, each grown as needed and kept (one entry per
    stream that ever ran a split-K call): the kernel leaves every ticket it
    takes at zero, the partials live only within one launch, and calls on
    one stream run in order."""
    key = (device, stream)
    t, p = _SCRATCH.get(key, (None, None))
    if t is None or t.numel() < tickets:
        t = torch.zeros(tickets, dtype=torch.int32, device=device)
    if p is None or p.numel() < partials:
        p = torch.empty(partials, dtype=torch.int32, device=device)
    _SCRATCH[key] = t, p
    return t, p


def check_inputs(a, b, u_gate, u_bit, cdf) -> Tuple[int, int, int]:
    """Validate the kernel's inputs (device, type, shape, contiguity);
    return (M, K, N)."""
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"a {tuple(a.shape)} and b {tuple(b.shape)} do not "
                         f"form a matrix product")
    M, K = a.shape
    N = b.shape[1]
    dev = a.device
    if (b.dtype is torch.int8 and a.dtype is torch.int8
            and u_gate.dtype is torch.int32 and u_bit.dtype is torch.int32
            and cdf.dtype is torch.float32 and u_gate.shape == (M, N)
            and u_bit.shape == (M, N) and cdf.shape == (33,)
            and b.device == dev and u_gate.device == dev
            and u_bit.device == dev and cdf.device == dev
            and a.is_contiguous() and b.is_contiguous()
            and u_gate.is_contiguous() and u_bit.is_contiguous()
            and cdf.is_contiguous() and max(M, K, N) < 2 ** 31):
        return M, K, N  # the common case, checked in one pass
    for x, name, dtype, shape in ((a, "a", torch.int8, (M, K)),
                                  (b, "b", torch.int8, (K, N)),
                                  (u_gate, "u_gate", torch.int32, (M, N)),
                                  (u_bit, "u_bit", torch.int32, (M, N)),
                                  (cdf, "cdf", torch.float32, (33,))):
        if x.device != a.device:
            raise ValueError(f"{name} is on {x.device}, a on {a.device}")
        if x.dtype != dtype or x.shape != shape:
            raise ValueError(f"{name} must be {dtype} of shape {shape}, got "
                             f"{x.dtype} {tuple(x.shape)}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if max(M, K, N) >= 2 ** 31:
        raise ValueError("each dimension must stay below 2^31")
    return M, K, N


def launch(entry: str, a, b, u_gate, u_bit, cdf, outputs) -> None:
    """Launch one entry point of the kernel on the current stream with the
    shape's plan; raise if the launch is refused."""
    M, K = a.shape
    N = b.shape[1]
    dev = a.device.index
    pa, pb = a.data_ptr(), b.data_ptr()
    p = plan(M, K, N, _sms(dev), _align(pa), _align(pb))
    ptrs = [None if x is None else x.data_ptr() for x in outputs]
    planes = [u_gate.data_ptr(), u_bit.data_ptr(), *ptrs[:2]]
    vec = int(N % 4 == 0 and all(x % 16 == 0 for x in planes if x))
    with (contextlib.nullcontext() if dev == torch.cuda.current_device()
          else torch.cuda.device(dev)):
        stream = torch._C._cuda_getCurrentRawStream(dev)
        partial = tickets = None
        if p.splits > 1:
            BM, BN = TILES[p.tile]
            tickets, partial = _scratch(a.device, stream,
                                        -(-M // BM) * -(-N // BN),
                                        p.splits * M * N)
        err = getattr(_lib(), entry)(
            pa, pb, planes[0], planes[1], cdf.data_ptr(), *ptrs,
            None if partial is None else partial.data_ptr(),
            None if tickets is None else tickets.data_ptr(), M, K, N,
            _TILE_IDS[p.tile], p.per, p.a_width, p.b_width, vec, stream)
    if err != 0:
        raise RuntimeError(f"{entry} failed: CUDA error {err}")


def overscale_matmul(a, b, u_gate, u_bit, cdf, *, return_clean: bool = False):
    """a (M, K) int8, b (K, N) int8, u_gate/u_bit (M, N) int32 holding
    uint32 bits, cdf (33,) float32 -> (M, N) int32 with injected errors.
    ``return_clean`` also returns the product before the flips, from the
    same launch."""
    refuse_grad("overscale_matmul", a, b, cdf)
    if a.device.type == "cpu":
        return overscale_matmul_ref(a, b, u_gate, u_bit, cdf,
                                    return_clean=return_clean)
    if a.device.type != "cuda":
        raise ValueError(f"overscale_matmul runs on CPU or CUDA tensors, "
                         f"not {a.device}")
    M, K, N = check_inputs(a, b, u_gate, u_bit, cdf)
    c = torch.empty((M, N), dtype=torch.int32, device=a.device)
    clean = torch.empty_like(c) if return_clean else None
    if M and N:
        launch("overscale_matmul_launch", a, b, u_gate, u_bit, cdf,
               (c, clean))
        overscale_matmul.launches += 1
    return (c, clean) if return_clean else c


overscale_matmul.launches = 0


# --- helpers and the app-facing wrapper ----------------------------------------

def bit_probs_to_cdf(bit_probs, device=None) -> torch.Tensor:
    """(32,) per-bit flip probabilities -> (33,) float32 [0, cumsum...];
    cdf[-1] = p_total, on ``device`` (None: the card, as for every entry
    point; ``"cpu"`` for the CPU).

    The sum is rounded as the reference's float32 ``cumsum`` of 32 entries
    is on the CPU, where XLA runs it as two blocks of 16: a running sum
    within each block, then the first block's total added to every entry
    of the second. A plain running sum (or ``torch.cumsum``, which
    accumulates in float64 on the CPU) differs in the last bit, which can
    move a flip decision."""
    if isinstance(bit_probs, torch.Tensor):
        bit_probs = bit_probs.detach().cpu().numpy()
    p = np.asarray(bit_probs, np.float32)
    if p.shape != (32,):
        raise ValueError(f"bit_probs must have 32 entries, got {p.shape}")
    blocks = np.cumsum(p.reshape(2, 16), axis=1, dtype=np.float32)
    blocks[1] += blocks[0, -1]
    cdf = np.concatenate([np.zeros(1, np.float32), blocks.reshape(-1)])
    return torch.from_numpy(cdf).to(resolve_device(device))


def quantize(x: torch.Tensor, bits: int = 8):
    """Symmetric per-tensor quantisation -> (int8 tensor, float32 scale)."""
    scale = x.abs().max() / (2 ** (bits - 1) - 1) + 1e-9
    q = torch.clamp(torch.round(x / scale), -(2 ** (bits - 1)),
                    2 ** (bits - 1) - 1)
    return q.to(torch.int8), scale


def quantile_linear(x: torch.Tensor, q: float) -> torch.Tensor:
    """The "linear" quantile of all elements of a float32 tensor, rounded
    as ``jnp.quantile`` rounds it (index, weights and lerp in float32), as a
    0-dim tensor on x's device. The two order statistics come from ``topk``
    (``torch.quantile`` refuses more than 2^24 elements)."""
    flat = x.reshape(-1)
    n = flat.numel()
    f32 = np.float32
    pos = f32(q) * (f32(n) - f32(1))
    low, high = np.floor(pos), np.ceil(pos)
    w_high = pos - low
    w_low = f32(1) - w_high
    low = min(max(int(low), 0), n - 1)
    high = min(max(int(high), 0), n - 1)
    top = torch.topk(flat, n - low).values  # descending: top[-1] = x_(low)
    return top[-1] * float(w_low) + top[-1 - (high - low)] * float(w_high)


def random_planes(gen: torch.Generator, shape, device) -> Tuple[
        torch.Tensor, torch.Tensor]:
    """Two uniform 32-bit planes (u_gate, u_bit) as int32, drawn in order."""
    draw = lambda: torch.randint(-2 ** 31, 2 ** 31, tuple(shape),
                                 dtype=torch.int32, generator=gen,
                                 device=device)
    u_gate = draw()
    return u_gate, draw()


#: planes hook: (1-based call index, (M, N)) -> (u_gate, u_bit) int32
Planes = Callable[[int, Tuple[int, int]], Tuple[torch.Tensor, torch.Tensor]]


def plane_source(seed: int, planes: Optional[Planes], device) -> Planes:
    """The planes of a stream of calls: two draws per call from one
    ``torch.Generator`` on ``device`` seeded with ``seed``, or ``planes``
    (a test replays the reference's), moved to ``device``."""
    if planes is not None:
        return lambda n, shape: tuple(p.to(device) for p in planes(n, shape))
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    return lambda n, shape: random_planes(gen, shape, device)


def make_int8_error_matmul(bit_probs, seed: int, use_kernel: bool = True,
                           planes: Optional[Planes] = None, device=None):
    """Returns matmul(a_f32, b_f32) -> f32 that quantises both operands,
    runs the error-injected int8 product and dequantises with clipping at
    the calibrated range (the fixed-point requantisation step).

    The planes come from one ``torch.Generator`` on the device, seeded with
    ``seed``, two draws per call; ``planes`` replaces them (a test replays
    the reference's). ``use_kernel=False`` runs the plain version on any
    device (the counterpart of the reference's ``use_pallas``)."""
    dev = resolve_device(device)
    cdf = bit_probs_to_cdf(np.asarray(bit_probs, np.float32), dev)
    draw = plane_source(seed, planes, dev)
    counter = [0]
    product = overscale_matmul if use_kernel else overscale_matmul_ref

    def mm(a, b):
        counter[0] += 1
        qa, sa = quantize(a)
        qb, sb = quantize(b)
        u_gate, u_bit = draw(counter[0], (a.shape[0], b.shape[1]))
        acc, clean = product(qa, qb, u_gate, u_bit, cdf, return_clean=True)
        # requantise with clipping at the calibrated activation range: a
        # flipped carry/MSB bit saturates instead of exploding
        lim = quantile_linear(clean.to(torch.float32).abs(), CLIP_QUANTILE)
        return torch.clamp(acc.to(torch.float32), -lim, lim) * sa * sb

    return mm

"""Blockwise online-softmax attention (FlashAttention): the Hopper kernel and
its plain version.

Replaces the TPU kernel ``repro/kernels/flash_attention.py::flash_attention``
(and its oracle ``repro/kernels/ref.py::flash_attention_ref``), batched over
(B, H) as the reference's ``ops.flash_attention_bh`` is, with GQA inside:
query head ``h`` reads kv head ``h // (H / Hkv)``. q (B, S, H, D) and k, v
(B, T, Hkv, D); with ``causal`` query i sees keys j <= i (absolute offsets
from 0 on both sides). The TPU wrapper needed equal heads and S a multiple of
its 128-row blocks; the kernel masks the ragged edge itself, so any S and T
go.

The kernel (``csrc/flash_attention.cu``) is bound by operations at the
model's shapes: 2 * 2 * B * H * S * T * D of them (half when causal) against
the bytes of q, k, v and the output. One block per (b, h, tile of 64 query
rows) walks the key tiles up to the diagonal, with the running max,
denominator and accumulator of each row in float32 registers; it computes
on the CUDA cores (tensor-core tiles are later work), so it stays well
above that bound.

``flash_attention`` dispatches on q's device: the plain version for a CPU
tensor, the kernel for a CUDA tensor (or an error).
``flash_attention.launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch
import torch.nn.functional as F

_KERNEL = "flash_attention"
NEG_INF = -1e30
CHUNK = 16  # keys per online-softmax step of the kernel
HEAD_DIMS = (16, 32, 64, 128)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def flash_attention_ref(q, k, v, *, causal: bool = True):
    """The plain version: the kernel's arithmetic, one operation at a time,
    over every (b, h, query row) at once. q (B, S, H, D), k and v
    (B, T, Hkv, D) -> (B, S, H, D) in q's dtype.

    Each query row takes the keys 16 at a time with a running max ``m``,
    denominator ``l`` and accumulator in float32: a key's score is its dot
    product with the query summed over d in order, divided by sqrt(D); a
    hidden key (past T, or above the diagonal when causal) scores NEG_INF
    and weighs exactly 0; ``l = l * corr + (the 16 weights summed in
    order)`` with ``corr = exp(m - m_new)``, and the rescaled accumulator
    takes the keys' weighted rows of v one after another. The output is
    ``acc / max(l, 1e-30)``. Every step rounds as the kernel's does (it is
    built without fused multiply-adds), so on the card the two agree bit
    for bit. Up to float32 rounding this is the reference's oracle,
    softmax(q k^T / sqrt(D)) v under the causal mask, in float32."""
    B, S, H, D = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    heads = torch.arange(H, device=q.device) // (H // Hkv)
    pad = -T % CHUNK
    qf = q.float().transpose(1, 2)  # (B, H, S, D)
    kf = F.pad(k.float(), (0, 0, 0, 0, 0, pad))[:, :, heads].transpose(1, 2)
    vf = F.pad(v.float(), (0, 0, 0, 0, 0, pad))[:, :, heads].transpose(1, 2)
    # a tensor, not a Python number: PyTorch turns a division by a number
    # into a product with its reciprocal, which rounds differently
    sqrt_d = torch.tensor(math.sqrt(D), dtype=torch.float32, device=q.device)
    qpos = torch.arange(S, device=q.device)[:, None]
    m = torch.full((B, H, S), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((B, H, S), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, H, S, D), dtype=torch.float32, device=q.device)
    for c in range(0, T + pad, CHUNK):
        kpos = torch.arange(c, c + CHUNK, device=q.device)[None, :]
        vis = (kpos < T) & ((kpos <= qpos) if causal else True)  # (S, 16)
        dot = torch.zeros((B, H, S, CHUNK), dtype=torch.float32,
                          device=q.device)
        for d in range(D):
            dot = dot + qf[..., d, None] * kf[:, :, None, c:c + CHUNK, d]
        s = torch.where(vis, dot / sqrt_d, NEG_INF)
        m_new = torch.maximum(m, s.amax(-1))
        corr = torch.exp(m - m_new)
        p = torch.where(vis, torch.exp(s - m_new[..., None]), 0.0)
        psum = torch.zeros_like(l)
        for j in range(CHUNK):
            psum = psum + p[..., j]
        l = l * corr + psum
        acc = acc * corr[..., None]
        for j in range(CHUNK):
            acc = acc + p[..., j, None] * vf[:, :, None, c + j]
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.transpose(1, 2).to(q.dtype)


@functools.lru_cache(maxsize=1)
def _lib() -> ctypes.CDLL:
    from repro_torch.kernels import _build
    lib = _build.load(_KERNEL)
    lib.flash_attention_launch.argtypes = (
        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8 + [ctypes.c_void_p])
    lib.flash_attention_launch.restype = ctypes.c_int
    return lib


def check_inputs(q, k, v):
    """Validate the kernel's inputs; return (B, S, T, H, Hkv, D)."""
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError("q must be (B, S, H, D) and k, v (B, T, Hkv, D)")
    B, S, H, D = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    for x, name, shape in ((q, "q", (B, S, H, D)), (k, "k", (B, T, Hkv, D)),
                           (v, "v", (B, T, Hkv, D))):
        if x.device != q.device:
            raise ValueError(f"{name} is on {x.device}, q on {q.device}")
        if x.dtype != q.dtype or tuple(x.shape) != shape:
            raise ValueError(f"{name} must be {q.dtype} of shape {shape}, "
                             f"got {x.dtype} {tuple(x.shape)}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if q.dtype not in _DTYPES:
        raise ValueError(f"q must be float32 or bfloat16, got {q.dtype}")
    if Hkv == 0 or H % Hkv:
        raise ValueError(f"{H} query heads do not group over {Hkv} kv heads")
    if D not in HEAD_DIMS:
        raise ValueError(f"the kernel takes head_dim in {HEAD_DIMS}, got {D}")
    if max(q.numel(), k.numel()) >= 2 ** 31 or H > 65535 or B > 65535:
        raise ValueError("each tensor must hold fewer than 2^31 elements")
    return B, S, T, H, Hkv, D


def flash_attention(q, k, v, *, causal: bool = True) -> torch.Tensor:
    """q (B, S, H, D), k and v (B, T, Hkv, D), float32 or bfloat16 (all of
    one dtype) -> (B, S, H, D) in q's dtype."""
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on CPU or CUDA tensors, "
                         f"not {q.device}")
    B, S, T, H, Hkv, D = check_inputs(q, k, v)
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _lib().flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            B, S, T, H, Hkv, D, int(bool(causal)), _DTYPES[q.dtype], stream)
    if err != 0:
        raise RuntimeError(f"flash_attention launch failed: CUDA error {err}")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0

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
rows) walks the key tiles up to the diagonal with the running max,
denominator and accumulator of each row in float32. In bfloat16 it is
FlashAttention-2 on the tensor cores: mma.sync m16n8k16 tiles for Q K^T and
P V, a 3-stage cp.async ring of K/V tiles in shared memory, P kept in
registers as two bf16 halves (hi = bf16(p), lo = bf16(p - hi)); what keeps
it above the bound is mma.sync against wgmma with TMA, and the second P V
product. float32 stays on the CUDA cores, one thread per query row (TF32
would lose the float32 token gates). The plain version repeats either
instance bit for bit, the tensor cores' way of summing included
(:func:`tensor_core_mma`).

``flash_attention`` dispatches on q's device: the plain version for a CPU
tensor, the kernel for a CUDA tensor (or an error), and for a meta tensor
(the dry run, ``launch/dryrun.py``) an output of the kernel's shape and
dtype with no work, as the reference's lowered call has its ``out_shape``.
``flash_attention.launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch
import torch.nn.functional as F

from repro_torch.kernels.grad import wants_grad

_KERNEL = "flash_attention"
NEG_INF = -1e30
CHUNK = 16  # keys per online-softmax step of the float32 kernel
TILE = 64  # keys per tile of the bf16 kernel
MMA_BITS = 25  # bits the tensor cores keep below the largest exponent
HEAD_DIMS = (16, 32, 64, 128)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def scale_log2(D: int) -> float:
    """log2(e) / sqrt(D), the bf16 kernel's one factor on a score (it takes
    exp2 of the scaled scores); the wrapper hands the kernel this value."""
    return math.log2(math.e) / math.sqrt(D)


def quad_sum(p: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis (64 keys of a tile) in the bf16 kernel's
    order: lane t of a row's quad adds keys 8 j + 2 t and 8 j + 2 t + 1 for
    j = 0..7 in turn, then the quad adds lane t ^ 1, then lane t ^ 2."""
    lanes = p.reshape(*p.shape[:-1], 8, 4, 2)
    part = torch.zeros_like(lanes[..., 0, :, 0])
    for j in range(8):
        for e in range(2):
            part = part + lanes[..., j, :, e]
    part = part[..., 0::2] + part[..., 1::2]
    return part[..., 0] + part[..., 1]


def _exponent(x: torch.Tensor) -> torch.Tensor:
    """floor(log2 |x|) of each element as int32; very negative for 0."""
    _, e = torch.frexp(x)
    return torch.where(x == 0, -(1 << 20), e - 1)


def _pow2(e: torch.Tensor) -> torch.Tensor:
    """2.0 ** e in float64, exactly (e an integer tensor, clamped to the
    normal range)."""
    return ((e.clamp(-1022, 1023).to(torch.int64) + 1023) << 52).view(
        torch.float64)


def tensor_core_mma(a, b, c):
    """c + a @ b over k = 16 as one ``mma.sync.m16n8k16`` with bf16 inputs
    and a float32 accumulator computes it on the H100: a (..., M, 16) and
    b (..., 16, N) hold bf16 values (in float32), c (..., M, N) float32.

    The 16 products are exact; they and c are aligned to the largest of
    the products' operand-exponent sums e(a) + e(b) and c's exponent, each
    cut toward zero to a multiple of 2^(emax - MMA_BITS), summed exactly,
    and the sum cut toward zero to float32. (Fitted to, and equal on, all
    1,048,576 outputs of 8192 random mma.sync calls on the card, exponents
    spread over +-12 for the inputs and +-20 for c.)"""
    prod = (a.double()[..., :, None, :]
            * b.double().transpose(-1, -2)[..., None, :, :])
    ep = (_exponent(a)[..., :, None, :]
          + _exponent(b).transpose(-1, -2)[..., None, :, :])
    emax = torch.maximum(ep.amax(-1), _exponent(c))
    down = _pow2(MMA_BITS - emax)
    total = (torch.trunc(prod * down[..., None]).sum(-1)
             + torch.trunc(c.double() * down))
    s = total * _pow2(emax - MMA_BITS)  # exact: |total| < 2^32
    r = s.float()
    return torch.where(r.double().abs() > s.abs(),
                       torch.nextafter(r, torch.zeros_like(r)), r)


def tensor_core_matmul(a, b, c):
    """c + a @ b as the kernels chain m16n8k16 steps over k (16 at a time,
    in order, through the accumulator): a (..., M, K), or a tuple of such
    terms (the weights' bf16 halves) that each k-step takes in turn, b
    (..., K, N) with K a multiple of 16, c (..., M, N) float32. Rows go in
    chunks to bound the float64 temporaries."""
    parts = a if isinstance(a, tuple) else (a,)
    M, K, N = parts[0].shape[-2], parts[0].shape[-1], b.shape[-1]
    lead = math.prod(parts[0].shape[:-2])
    step = max(1, (1 << 25) // max(1, lead * N * 16))
    out = []
    for r0 in range(0, M, step):
        acc = c[..., r0:r0 + step, :]
        for k0 in range(0, K, 16):
            for x in parts:
                acc = tensor_core_mma(x[..., r0:r0 + step, k0:k0 + 16],
                                      b[..., k0:k0 + 16, :], acc)
        out.append(acc)
    return torch.cat(out, dim=-2) if len(out) > 1 else out[0]


def _exp2_or_0(x: torch.Tensor) -> torch.Tensor:
    """exp2(x), and 0 for x < -100: every bf16 half of a weight is then 0
    or a normal number."""
    return torch.where(x >= -100.0, torch.exp2(x), 0.0)


def split_weights(p: torch.Tensor):
    """(hi, lo): p as two bfloat16 halves, hi = bf16(p), lo = bf16(p - hi),
    widened back to float32 (p - hi is exact in float32)."""
    hi = p.to(torch.bfloat16).float()
    return hi, (p - hi).to(torch.bfloat16).float()


def mma_tile_step(qf, kt, vt, vis, scale, m, l, acc):
    """One 64-key tile of the bf16 kernels' online softmax (flash attention
    and the paged extend), for rows q (..., R, D) against keys kt, vt
    (..., 64, D) under vis (..., R, 64); returns (m, l, acc) as the kernel
    leaves them: S = Q K^T and P V as the tensor cores compute them
    (:func:`tensor_core_matmul`), s2 = S * scale (log2 units), a hidden
    key scores NEG_INF and weighs 0, p = exp2(s2 - m_new) (0 below
    2^-100), the sum in the kernel's quad order, the rescaled accumulator,
    and p V as hi V then lo V at each step of 16 keys."""
    zeros = torch.zeros((*qf.shape[:-1], kt.shape[-2]), dtype=torch.float32,
                        device=qf.device)
    s = torch.where(vis, tensor_core_matmul(qf, kt.transpose(-1, -2), zeros)
                    * scale, NEG_INF)
    m_new = torch.maximum(m, s.amax(-1))
    corr = _exp2_or_0(m - m_new)
    p = torch.where(vis, _exp2_or_0(s - m_new[..., None]), 0.0)
    l = l * corr + quad_sum(p)
    acc = tensor_core_matmul(split_weights(p), vt, acc * corr[..., None])
    return m_new, l, acc


def _flash_bf16_ref(q, k, v, causal):
    """The plain version of the bf16 kernel: keys in tiles of 64 from 0;
    when causal, a tile goes to the rows at or below its first key (for a
    row that sees nothing in it, a tile changes nothing: corr = 1, p = 0,
    and a step of zero products leaves the accumulator as it is)."""
    B, S, H, D = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    heads = torch.arange(H, device=q.device) // (H // Hkv)
    pad = -T % TILE
    qf = q.float().transpose(1, 2)  # (B, H, S, D)
    kf = F.pad(k.float(), (0, 0, 0, 0, 0, pad))[:, :, heads].transpose(1, 2)
    vf = F.pad(v.float(), (0, 0, 0, 0, 0, pad))[:, :, heads].transpose(1, 2)
    scale = torch.tensor(scale_log2(D), dtype=torch.float32, device=q.device)
    qpos = torch.arange(S, device=q.device)[:, None]
    m = torch.full((B, H, S), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((B, H, S), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, H, S, D), dtype=torch.float32, device=q.device)
    for c in range(0, T + pad, TILE):
        r0 = min(c, S) if causal else 0  # rows above see nothing here
        kpos = torch.arange(c, c + TILE, device=q.device)[None, :]
        vis = (kpos < T) & ((kpos <= qpos[r0:]) if causal else True)
        m[..., r0:], l[..., r0:], acc[..., r0:, :] = mma_tile_step(
            qf[..., r0:, :], kf[:, :, c:c + TILE], vf[:, :, c:c + TILE], vis,
            scale, m[..., r0:], l[..., r0:], acc[..., r0:, :])
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.transpose(1, 2).to(q.dtype)


def flash_attention_ref(q, k, v, *, causal: bool = True):
    """The plain version: the kernel's arithmetic, one operation at a time,
    over every (b, h, query row) at once. q (B, S, H, D), k and v
    (B, T, Hkv, D) -> (B, S, H, D) in q's dtype.

    float32: each query row takes the keys 16 at a time with a running max
    ``m``, denominator ``l`` and accumulator in float32: a key's score is
    its dot product with the query summed over d in order, divided by
    sqrt(D); a hidden key (past T, or above the diagonal when causal)
    scores NEG_INF and weighs exactly 0; ``l = l * corr + (the 16 weights
    summed in order)`` with ``corr = exp(m - m_new)``, and the rescaled
    accumulator takes the keys' weighted rows of v one after another. The
    output is ``acc / max(l, 1e-30)``. Every step rounds as the kernel's
    does (it is built without fused multiply-adds), so on the card the two
    agree bit for bit. Up to float32 rounding this is the reference's
    oracle, softmax(q k^T / sqrt(D)) v under the causal mask, in float32.

    bfloat16: the tensor-core kernel's tiles of 64 keys
    (:func:`mma_tile_step`), its products summed as the card's tensor cores
    sum them (:func:`tensor_core_mma`), so on the card the two agree bit
    for bit too."""
    if q.dtype == torch.bfloat16:
        return _flash_bf16_ref(q, k, v, causal)
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
        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8
        + [ctypes.c_float, ctypes.c_void_p])
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
        if not x.is_contiguous() or x.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte "
                             f"aligned")
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
    one dtype) -> (B, S, H, D) in q's dtype. Where autograd records and an
    input requires a gradient the call goes through :class:`FlashAttention`
    (the same forward, and a backward)."""
    if wants_grad(q, k, v):
        return FlashAttention.apply(q, k, v, causal)
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal)
    if q.device.type == "meta":  # a dry run: the output's layout, no work
        check_inputs(q, k, v)
        return torch.empty_like(q)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on CPU, CUDA or meta "
                         f"tensors, not {q.device}")
    B, S, T, H, Hkv, D = check_inputs(q, k, v)
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _lib().flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            B, S, T, H, Hkv, D, int(bool(causal)), _DTYPES[q.dtype],
            scale_log2(D), stream)
    if err != 0:
        raise RuntimeError(f"flash_attention launch failed: CUDA error {err}")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0


# scores of one block of query rows in the backward: at most this many
# float32 elements (B x H x rows x keys) per tensor
BWD_BLOCK = 1 << 26


def flash_attention_backward(q, k, v, o, do, *, causal: bool = True,
                             block: int = BWD_BLOCK):
    """The gradients of :func:`flash_attention` in plain PyTorch: q (B, S,
    H, D), k and v (B, T, Hkv, D), the forward's output o and its gradient
    do (B, S, H, D) -> (dq, dk, dv) in the inputs' dtype.

    Per block of query rows, all in float32: the scores ``s = q k^T /
    sqrt(D)`` recomputed from q and k (hidden keys, above the diagonal when
    causal, score -inf), ``P = exp(s - lse)`` with lse the row's
    log-sum-exp, then ``dV = P^T dO``, ``dP = dO V^T``, ``dS = P (dP -
    rowsum(dO o))``, ``dQ = dS K / sqrt(D)`` and ``dK = dS^T Q / sqrt(D)``;
    dK and dV sum over the query heads of each kv head. A block takes
    ``block // (B H T)`` rows, so the (B, H, rows, T) scores stay bounded
    (the whole matrix at B 4, S 4096, H 32 is 8.6 GB in float32); a causal
    block reads only the keys up to its last row (every causal row sees
    key 0)."""
    B, S, H, D = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    g = H // Hkv
    scale = 1.0 / math.sqrt(D)
    # (B, Hkv, g, S, D) for q, o and do; (B, Hkv, T, D) for k and v
    grouped = lambda x: x.float().reshape(B, S, Hkv, g, D).permute(
        0, 2, 3, 1, 4)
    qf, of, dof = grouped(q), grouped(o), grouped(do)
    kf = k.float().transpose(1, 2)
    vf = v.float().transpose(1, 2)
    delta = (dof * of).sum(-1)  # rowsum(dO o): (B, Hkv, g, S)
    dq = torch.empty_like(qf)
    dk = torch.zeros_like(kf)
    dv = torch.zeros_like(vf)
    rows = max(1, min(S, block // max(1, B * H * T)))
    for r0 in range(0, S, rows):
        r1 = min(S, r0 + rows)
        t1 = min(T, r1) if causal else T  # keys a row of the block can see
        qb, dob = qf[..., r0:r1, :], dof[..., r0:r1, :]
        kb, vb = kf[:, :, :t1], vf[:, :, :t1]
        s = torch.einsum("bhgnd,bhtd->bhgnt", qb, kb) * scale
        if causal:
            qpos = torch.arange(r0, r1, device=q.device)[:, None]
            vis = torch.arange(t1, device=q.device)[None, :] <= qpos
            s = s.masked_fill(~vis, float("-inf"))
        lse = torch.logsumexp(s, dim=-1, keepdim=True)
        p = torch.exp(s - lse)
        dv[:, :, :t1] += torch.einsum("bhgnt,bhgnd->bhtd", p, dob)
        dp = torch.einsum("bhgnd,bhtd->bhgnt", dob, vb)
        ds = p * (dp - delta[..., r0:r1, None])
        dq[..., r0:r1, :] = torch.einsum("bhgnt,bhtd->bhgnd", ds, kb) * scale
        dk[:, :, :t1] += torch.einsum("bhgnt,bhgnd->bhtd", ds, qb) * scale
    dq = dq.permute(0, 3, 1, 2, 4).reshape(B, S, H, D)
    return (dq.to(q.dtype), dk.transpose(1, 2).to(k.dtype),
            dv.transpose(1, 2).to(v.dtype))


class FlashAttention(torch.autograd.Function):
    """:func:`flash_attention` with a gradient: the forward is the kernel
    on the card (its plain version on the CPU), the backward
    :func:`flash_attention_backward` from the saved q, k, v and output. On
    meta tensors (the dry run) both give their outputs' layout alone."""

    @staticmethod
    def forward(ctx, q, k, v, causal):
        o = flash_attention(q, k, v, causal=causal)
        ctx.save_for_backward(q, k, v, o)
        ctx.causal = causal
        return o

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, do):
        q, k, v, o = ctx.saved_tensors
        if q.device.type == "meta":  # a dry run: the gradients' layout
            return (torch.empty_like(q), torch.empty_like(k),
                    torch.empty_like(v), None)
        return (*flash_attention_backward(q, k, v, o, do.contiguous(),
                                          causal=ctx.causal), None)

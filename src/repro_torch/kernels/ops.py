"""Public wrappers around the port's kernels (the counterpart of
``repro.kernels.ops``). Each dispatches on its tensors' device: the plain
PyTorch version on the CPU, the Hopper kernel on CUDA."""
from __future__ import annotations

from repro_torch.kernels.abft_matmul import abft_matmul as _abft
from repro_torch.kernels.flash_attention import flash_attention as _flash
from repro_torch.kernels.mamba_scan import mamba_scan as _mamba
from repro_torch.kernels.overscale_matmul import overscale_matmul as _omm
from repro_torch.kernels.paged_attention import paged_attention as _paged
from repro_torch.kernels.thermal_stencil import thermal_stencil as _stencil


def flash_attention_bh(q, k, v, *, causal=True):
    """Batched, multi-head attention: q (B, S, H, D), k/v (B, T, Hkv, D),
    GQA inside (query head h reads kv head h // (H / Hkv))."""
    return _flash(q, k, v, causal=causal)


def paged_attention_decode(q, k_pool, v_pool, ids_pool, block_table, pos, *,
                           window=0):
    """Paged attention: q (R, H, D) rows with block_table (R, n_pages) and
    pos (R,), or q (B, S, H, D) chunks with block_table (B, n_pages) and
    pos (B, S) (S rows per slot on the slot's table); pools (P, ps, Hkv, D)
    / (P, ps)."""
    return _paged(q, k_pool, v_pool, ids_pool, block_table, pos,
                  window=window)


def mamba_scan_b(xh, dt, A, B, C, *, chunk=256):
    """Batched SSD scan: xh (b, S, H, P), dt (b, S, H), A (H,), B and C
    (b, S, G, N) with G dividing H -> (y (b, S, H, P), final state
    (b, H, P, N) float32). The reference's wrapper returns y alone."""
    return _mamba(xh, dt, A, B, C, chunk=chunk)


def thermal_sweep(T, P, diag, *, g_lat, g_v_tamb, iters=64, phase=None):
    return _stencil(T, P, diag, g_lat=g_lat, g_v_tamb=g_v_tamb, iters=iters,
                    phase=phase)


def overscale_mm(a, b, u_gate, u_bit, cdf):
    return _omm(a, b, u_gate, u_bit, cdf)


def abft_mm(a, b, u_gate, u_bit, cdf):
    """Error-injected int8 matmul with fused row/column checksums:
    -> (c, rowsum, colsum)."""
    return _abft(a, b, u_gate, u_bit, cdf)

"""ABFT row/column-checksummed error-injected int8 matmul (§V).

Replaces the TPU kernel ``repro/kernels/abft_matmul.py::abft_matmul`` and
its oracle ``repro/kernels/ref.py::abft_matmul_ref``: the same
error-injected product as ``overscale_matmul``, plus the row and column
sums of the corrupted product (int32, wrapping mod 2^32). Detection
compares them with the protected references from the clean inputs,

    row_ref = A @ colsum(B)        col_ref = rowsum(A) @ B

(``checksum_refs``), so a flipped bit b shows up as a +-2^b syndrome.

The kernel is the second entry point of ``csrc/int8_error_matmul.cu``: the
product, the flips and the sums in one launch (the sums by atomics into
zeroed outputs; integer sums mod 2^32 are exact in any order). A CPU tensor
goes to ``abft_matmul_ref``, a CUDA tensor to the kernel.
``abft_matmul.launches`` counts kernel launches.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.grad import refuse_grad
from repro_torch.kernels.overscale_matmul import (check_inputs, launch,
                                                  overscale_matmul_ref,
                                                  wrap_int32)


def checksums_ref(c: torch.Tensor):
    """(rowsum, colsum) of an int32 matrix, wrapping mod 2^32."""
    c64 = c.to(torch.int64)
    return wrap_int32(c64.sum(1)), wrap_int32(c64.sum(0))


def abft_matmul_ref(a, b, u_gate, u_bit, cdf, *, return_clean: bool = False):
    """The plain PyTorch version: (c, rowsum, colsum) (and the clean
    product, if asked)."""
    c, clean = overscale_matmul_ref(a, b, u_gate, u_bit, cdf,
                                    return_clean=True)
    out = (c, *checksums_ref(c))
    return (*out, clean) if return_clean else out


def abft_matmul(a, b, u_gate, u_bit, cdf, *, return_clean: bool = False):
    """a (M, K) int8, b (K, N) int8, u_gate/u_bit (M, N) int32 holding
    uint32 bits, cdf (33,) float32 -> (c (M, N), rowsum (M,), colsum (N,))
    int32, the checksums of the corrupted product; ``return_clean`` adds
    the product before the flips, from the same launch."""
    refuse_grad("abft_matmul", a, b, cdf)
    if a.device.type == "cpu":
        return abft_matmul_ref(a, b, u_gate, u_bit, cdf,
                               return_clean=return_clean)
    if a.device.type != "cuda":
        raise ValueError(f"abft_matmul runs on CPU or CUDA tensors, not "
                         f"{a.device}")
    M, K, N = check_inputs(a, b, u_gate, u_bit, cdf)
    c = torch.empty((M, N), dtype=torch.int32, device=a.device)
    clean = torch.empty_like(c) if return_clean else None
    sums = torch.zeros(M + N, dtype=torch.int32, device=a.device)
    rowsum, colsum = sums[:M], sums[M:]  # zeroed by one launch
    if M and N:
        launch("abft_matmul_launch", a, b, u_gate, u_bit, cdf,
               (c, clean, rowsum, colsum))
        abft_matmul.launches += 1
    out = (c, rowsum, colsum)
    return (*out, clean) if return_clean else out


abft_matmul.launches = 0


def checksum_refs(a: torch.Tensor, b: torch.Tensor):
    """Protected checksum references from the clean int8 inputs:
    ``row_ref = A @ colsum(B)``, ``col_ref = rowsum(A) @ B``, int32 wrapping
    mod 2^32 like the accumulators they guard (an int64 product-and-sum,
    exact, then wrapped: PyTorch has no integer product on CUDA)."""
    a64, b64 = a.to(torch.int64), b.to(torch.int64)
    row_ref = (a64 * b64.sum(1)[None, :]).sum(1)
    col_ref = (a64.sum(0)[:, None] * b64).sum(0)
    return wrap_int32(row_ref), wrap_int32(col_ref)

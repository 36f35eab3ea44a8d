"""ABFT detect/correct over the checksummed over-scaled matmul (§V).

The port of ``repro.tolerance.abft``. The kernel (``kernels/abft_matmul``)
produces the corrupted product C' and its row/column sums; this module
compares them with the protected references (``row_ref = A @ colsum(B)``,
``col_ref = rowsum(A) @ B``) and repairs what the syndromes localize:

- an XOR flip of bit b in element (i, j) shifts ``rowsum[i]`` and
  ``colsum[j]`` by the same delta (mod 2^32) — a matching nonzero pair
  ``dr[i] == dc[j]`` pinpoints the cell, and subtracting the delta restores
  it exactly;
- multiple flips sharing a row/column alias: their syndromes are detected
  but not uniquely localizable — those remain as escapes.

``detect_and_correct`` has the reference's semantics, including its fault:
a unique ``dr[i] == dc[j]`` pairing can come from two flips of equal delta
in different rows and columns, and the "repair" then breaks a healthy cell.

:class:`AbftMatmul` is the app-facing drop-in (mirrors
``kernels.overscale_matmul.make_int8_error_matmul``): quantise -> inject ->
detect/correct -> requantise, accumulating detect/correct/escape counters.
:func:`routed_matmuls` installs it on the model layers' matmul hook
(``models.layers.MATMUL``), so that a full model (e.g.
``configs/llama3_2_1b``) runs its MLP products (``wg``, ``wu``, ``wd``)
through the checksummed kernel: the accuracy-vs-rail study of
``examples/overscaling_study.py``. Everything runs on the device of its
operands.
"""
from __future__ import annotations

from contextlib import contextmanager
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.kernels.abft_matmul import (abft_matmul, abft_matmul_ref,
                                             checksum_refs)
from repro_torch.kernels.overscale_matmul import (CLIP_QUANTILE, Planes,
                                                  bit_probs_to_cdf,
                                                  plane_source,
                                                  quantile_linear, quantize,
                                                  wrap_int32)


@dataclass
class AbftCounters:
    """Cumulative SDC ledger of one :class:`AbftMatmul` stream."""
    checked: int = 0    # output elements covered by the checksums
    injected: int = 0   # ground-truth corrupted elements (simulation-only)
    detected: int = 0   # elements the syndromes flagged
    corrected: int = 0  # elements repaired exactly
    escaped: int = 0    # still-wrong elements after repair

    @property
    def detect_rate(self) -> float:
        return self.detected / self.injected if self.injected else 0.0

    @property
    def escape_rate(self) -> float:
        return self.escaped / self.checked if self.checked else 0.0


def _sub32(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """x - y for int32 tensors, wrapping mod 2^32."""
    return wrap_int32(x.to(torch.int64) - y.to(torch.int64))


def detect_and_correct(c, rowsum, colsum, row_ref, col_ref
                       ) -> Tuple[torch.Tensor, int, int]:
    """Repair uniquely-localized single flips; return (c_fixed, detected,
    corrected). All int32, arithmetic wrapping mod 2^32 on both sides of
    every syndrome."""
    dr = _sub32(rowsum, row_ref)
    dc = _sub32(colsum, col_ref)
    # corrupted cells announce themselves on both axes; aliasing (several
    # flips sharing a row or column) can hide some — count the larger axis
    detected = int(max(int(torch.count_nonzero(dr)),
                       int(torch.count_nonzero(dc))))
    if detected == 0:
        return c.clone(), 0, 0
    match = (dr[:, None] == dc[None, :]) & (dr != 0)[:, None]
    # unique row-col pairing only: an ambiguous syndrome must not "repair"
    # a healthy cell
    fix = (match & (match.sum(1) == 1)[:, None]
           & (match.sum(0) == 1)[None, :])
    fixed = _sub32(c, torch.where(fix, dr[:, None], 0))
    return fixed, detected, int(fix.sum())


class AbftMatmul:
    """Drop-in float32 matmul through the ABFT-checksummed over-scaled
    kernel.

    Mirrors ``make_int8_error_matmul`` (quantise -> inject -> requantise
    with calibrated clipping) with the detect/correct pass in between and a
    :class:`AbftCounters` ledger on the side. The planes come from one
    ``torch.Generator`` on the device, seeded with ``seed``, two draws per
    call (``planes`` replaces them). ``use_kernel=False`` runs the plain
    version on any device (the counterpart of the reference's
    ``use_pallas``); the clean product for the clip limit and the ledger
    comes from the same launch as the corrupted one.
    """

    def __init__(self, bit_probs, seed: int, use_kernel: bool = True,
                 planes: Optional[Planes] = None, device=None):
        self.device = resolve_device(device)
        self.cdf = bit_probs_to_cdf(np.asarray(bit_probs, np.float32),
                                    self.device)
        self.planes = plane_source(seed, planes, self.device)
        self.product = abft_matmul if use_kernel else abft_matmul_ref
        self.counters = AbftCounters()
        self._n = 0

    def __call__(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        self._n += 1
        qa, sa = quantize(a)
        qb, sb = quantize(b)
        u_gate, u_bit = self.planes(self._n, (a.shape[0], b.shape[1]))
        c, rs, cs, clean = self.product(qa, qb, u_gate, u_bit, self.cdf,
                                        return_clean=True)
        row_ref, col_ref = checksum_refs(qa, qb)
        fixed, detected, corrected = detect_and_correct(
            c, rs, cs, row_ref, col_ref)
        # simulation ground truth: the clean product exposes injections
        # and escapes
        self.counters.checked += int(fixed.numel())
        self.counters.injected += int(torch.count_nonzero(c != clean))
        self.counters.detected += detected
        self.counters.corrected += corrected
        self.counters.escaped += int(torch.count_nonzero(fixed != clean))
        lim = quantile_linear(clean.to(torch.float32).abs(), CLIP_QUANTILE)
        return torch.clamp(fixed.to(torch.float32), -lim, lim) * sa * sb


@contextmanager
def routed_matmuls(mm):
    """Route the model layers' dense MLP products (``models.layers.matmul``)
    through ``mm`` (a ``(x_2d_f32, w_2d_f32) -> y_2d_f32`` callable, e.g.
    an :class:`AbftMatmul`) for the duration of the block; the previous
    hook is restored on exit, an exception included."""
    from repro_torch.models import layers
    prev = layers.MATMUL
    layers.MATMUL = mm
    try:
        yield mm
    finally:
        layers.MATMUL = prev


def topk_agreement(logits, ref_logits, k: int = 1) -> float:
    """Accuracy proxy for the rail curves: fraction of positions whose
    top-k next-token sets agree with the clean-rail reference."""
    a = torch.as_tensor(logits, dtype=torch.float32)
    b = torch.as_tensor(ref_logits, dtype=torch.float32)
    ta = torch.topk(a.reshape(-1, a.shape[-1]), k, dim=-1).indices
    tb = torch.topk(b.reshape(-1, b.shape[-1]), k, dim=-1).indices
    hits = (ta[:, :, None] == tb[:, None, :]).any(-1).sum(-1)
    return float((hits.to(torch.float64) / k).mean())

"""repro_torch.tolerance — the §V error-tolerant over-scaling tier.

The port of ``repro.tolerance``: for workloads that tolerate a bounded
amount of error, rails below the guard band convert the remaining thermal
margin into power, provided the timing-violation bit errors are detected,
repaired and counted.

- :mod:`~repro_torch.tolerance.faults` — the timing-error model at the
  live (v_core, v_sram, T) state, calibrated so guard-band rails inject
  nothing, and a seeded SDC sampler.
- :mod:`~repro_torch.tolerance.abft` — the ABFT row/column-checksummed int8
  matmul (the CUDA kernel in ``kernels/abft_matmul`` beside its plain
  version): detects SDCs, corrects single flips and keeps
  detect/correct/escape counters.

``SdcTelemetry`` (the control-plane adapter) and ``routed_matmuls`` (the
model layers' matmul hook) come with the control-plane and model slices.
"""
from repro_torch.tolerance.abft import (AbftCounters, AbftMatmul,
                                        checksum_refs, detect_and_correct,
                                        topk_agreement)
from repro_torch.tolerance.faults import (FaultInjector, SdcCounts,
                                          TimingFaultModel)

__all__ = [
    "TimingFaultModel", "FaultInjector", "SdcCounts",
    "AbftCounters", "AbftMatmul", "checksum_refs", "detect_and_correct",
    "topk_agreement",
]

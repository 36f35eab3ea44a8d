"""repro_torch.tolerance — the §V error-tolerant over-scaling tier.

The port of ``repro.tolerance``: for workloads that tolerate a bounded
amount of error, rails below the guard band convert the remaining thermal
margin into power, provided the timing-violation bit errors are detected,
repaired and counted.

- :mod:`~repro_torch.tolerance.faults` — the timing-error model at the
  live (v_core, v_sram, T) state, calibrated so guard-band rails inject
  nothing, a seeded SDC sampler, and ``SdcTelemetry``, which feeds the
  sampler's counters at the applied rails to the control plane's bus.
- :mod:`~repro_torch.tolerance.abft` — the ABFT row/column-checksummed int8
  matmul (the CUDA kernel in ``kernels/abft_matmul`` beside its plain
  version): detects SDCs, corrects single flips and keeps
  detect/correct/escape counters; ``routed_matmuls`` installs it on the
  model layers' matmul hook, so a full model runs its MLP products through
  the kernel.
"""
from repro_torch.tolerance.abft import (AbftCounters, AbftMatmul,
                                        checksum_refs, detect_and_correct,
                                        routed_matmuls, topk_agreement)
from repro_torch.tolerance.faults import (FaultInjector, SdcCounts,
                                          SdcTelemetry, TimingFaultModel)

__all__ = [
    "TimingFaultModel", "FaultInjector", "SdcCounts", "SdcTelemetry",
    "AbftCounters", "AbftMatmul", "checksum_refs", "detect_and_correct",
    "routed_matmuls", "topk_agreement",
]

"""Meshes and the pod topology (the counterpart of the reference's
``launch/mesh.py``).

``make_production_mesh`` gives the production meshes' shapes as a
:class:`MeshShape` (names and sizes only): 16x16 = 256 chips over
``("data", "model")``, or 2 pods = 512 chips with a leading ``"pod"`` axis.
One host does not start 256 or 512 ranks, and the sharding plan
(``sharding.plan.make_plan``) reads no more than the names and sizes.
``make_host_mesh`` builds a real ``torch.distributed.device_mesh.DeviceMesh``
over the ranks of the current process group. Both are functions, so
importing this module initialises nothing.

:class:`PodTopology` (pure Python, as the reference's) resolves a worker
name to a validated pod-local chip index (and 2-D pod coordinate), so
straggler telemetry lands on the chip the actuator can really touch, and
``partition`` lays a fleet out as contiguous pods (``control.fleet``'s
failure domains). Single pod: 16x16 = 256 chips; multi-pod: 2 pods = 512
chips, pod-major. ``PodTopology.from_mesh`` reads either kind of mesh.
"""
from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

_DIGITS = re.compile(r"\d+")
# host/worker composition only applies to names that really carry BOTH
# labels — a bare version digit ("tpu-v4-rank12") must not be mistaken
# for a host index
_HOST_WORKER = re.compile(r"host(\d+).*?worker(\d+)")


@dataclass(frozen=True)
class MeshShape:
    """A mesh of axis names and sizes only, without devices."""

    axis_names: Tuple[str, ...]
    sizes: Tuple[int, ...]

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        n = 1
        for s in self.sizes:
            n *= s
        return n


def make_production_mesh(*, multi_pod: bool = False) -> MeshShape:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return MeshShape(axes, shape)


def make_host_mesh(model: int = 1, device=None):
    """A ``DeviceMesh`` over the ranks of the current process group, axes
    ``("data", "model")``, of the device type of ``device`` (None: the CUDA
    card, raising without one; ``"cpu"`` for a gloo group of CPU ranks)."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    from repro_torch import resolve_device
    if not dist.is_initialized():
        raise RuntimeError("make_host_mesh needs an initialised process "
                           "group (torch.distributed.init_process_group)")
    n = dist.get_world_size()
    model = min(model, n)
    return DeviceMesh(resolve_device(device).type,
                      torch.arange(n).reshape(n // model, model),
                      mesh_dim_names=("data", "model"))


@dataclass(frozen=True)
class PodTopology:
    """Rank -> pod-coordinate mapping for one (or several) ``grid`` pods.

    Worker names carry their global rank as the trailing integer
    (``worker7``, ``tpu-v4-rank12``); with ``workers_per_host`` set, a
    ``host<h>-worker<w>`` pair composes the global rank ``h * wph + w``.
    Everything is *validated*: a name without digits, or a rank beyond the
    fleet, maps to chip ``-1`` — the telemetry layer's explicit "unmapped"
    sentinel (the controller surfaces it in ``stats.unmapped`` instead of
    acting on a phantom chip).
    """

    grid: Tuple[int, int] = (16, 16)
    n_pods: int = 1
    workers_per_host: Optional[int] = None
    # the pod THIS controller/actuator pair owns: ranks from other pods
    # are unmapped (-1), never silently folded onto this pod's chips.
    # None = a fleet-wide view (pod-local indices for every pod's ranks)
    pod_index: Optional[int] = 0

    # ------------------------------------------------------------------
    @property
    def chips_per_pod(self) -> int:
        return self.grid[0] * self.grid[1]

    @property
    def n_chips(self) -> int:
        return self.n_pods * self.chips_per_pod

    # ------------------------------------------------------------------
    def rank_of(self, worker: str) -> Optional[int]:
        """Global rank parsed from a worker name; None when unparseable.

        ``host<h>-worker<w>`` composes ``h * workers_per_host + w`` (only
        when both labels are present — stray digit groups like the "4" in
        ``tpu-v4-rank12`` never masquerade as a host index); otherwise the
        trailing digit group is the global rank."""
        if self.workers_per_host is not None:
            m = _HOST_WORKER.search(worker)
            if m:
                return (int(m.group(1)) * self.workers_per_host
                        + int(m.group(2)))
        groups = _DIGITS.findall(worker)
        return int(groups[-1]) if groups else None

    def pod_of(self, rank: int) -> int:
        return rank // self.chips_per_pod

    def coords(self, rank: int) -> Tuple[int, int]:
        """(row, col) of a rank inside its pod (row-major chip layout)."""
        local = rank % self.chips_per_pod
        return local // self.grid[1], local % self.grid[1]

    def chip_of_rank(self, rank: int) -> int:
        """Pod-local flat chip index; -1 when the rank is outside the
        fleet (a stale worker name, a coordinator process) or belongs to
        a pod this controller does not own (``pod_index``)."""
        if not 0 <= rank < self.n_chips:
            return -1
        if (self.pod_index is not None
                and self.pod_of(rank) != self.pod_index):
            return -1
        return rank % self.chips_per_pod

    def chip_of(self, worker: str) -> int:
        """Validated worker-name -> chip mapping (-1 = unmapped)."""
        rank = self.rank_of(worker)
        return -1 if rank is None else self.chip_of_rank(rank)

    # ------------------------------------------------------------------
    def chip_range(self, pod: int) -> Tuple[int, int]:
        """Fleet-wide ``[lo, hi)`` chip indices of one pod's slice (chips
        are laid out pod-major, row-major inside the pod)."""
        if not 0 <= pod < self.n_pods:
            raise ValueError(f"pod {pod} outside fleet of {self.n_pods}")
        return pod * self.chips_per_pod, (pod + 1) * self.chips_per_pod

    @staticmethod
    def partition(n_chips: int, n_pods: int) -> Tuple[Tuple[int, int], ...]:
        """Contiguous ``[lo, hi)`` chip slices dividing ``n_chips`` into
        ``n_pods`` failure domains (``control.fleet``'s default layout).
        Requires an even split: a pod is a physical unit, not a remainder."""
        if n_pods <= 0 or n_chips % n_pods:
            raise ValueError(
                f"{n_chips} chips do not split into {n_pods} equal pods")
        per = n_chips // n_pods
        return tuple((p * per, (p + 1) * per) for p in range(n_pods))

    # ------------------------------------------------------------------
    @classmethod
    def from_mesh(cls, mesh, workers_per_host: Optional[int] = None
                  ) -> "PodTopology":
        """Topology of a mesh (a ``DeviceMesh`` or a :class:`MeshShape`):
        the trailing two axes are the pod grid, any leading axes multiply
        into ``n_pods``."""
        from repro_torch.sharding.plan import mesh_axes
        shape = tuple(mesh_axes(mesh).values())
        if len(shape) == 1:
            shape = (1,) + shape
        grid = shape[-2:]
        n_pods = 1
        for d in shape[:-2]:
            n_pods *= int(d)
        return cls(grid=(int(grid[0]), int(grid[1])), n_pods=n_pods,
                   workers_per_host=workers_per_host)

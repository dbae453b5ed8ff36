"""Machine description: devices, topology and machine views (port of
``flexflow_tpu/parallel/machine.py``).

Reference: include/flexflow/machine_view.h:14-107 (MachineView = n-dim
grid of device ids with start + strides; MachineResource = search
resource envelope) and include/flexflow/config.h workersPerNode/numNodes.

The class and field names are the JAX package's, so a test hands both
packages the same machine: ``TPUChipSpec`` is the per-device peak record
the search's cost model reads, whatever the device. Its defaults are the
JAX package's reference preset (a TPU v5p), not figures of any GPU; the
card's own spec comes from ``search/calibration.py::chip_spec_for``
(``ici_*`` holds the card's NVLink there). A MachineView is the search's
placement primitive: a sub-grid of device ids.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple


@dataclasses.dataclass(frozen=True)
class TPUChipSpec:
    """Per-device peak numbers used by the analytic cost model.

    The defaults are the JAX package's reference preset (a TPU v5p), kept
    so a CPU search gives the JAX package's answer; they are not figures
    of the card (``search/calibration.py::chip_spec_for`` gives those).
    """

    name: str = "v5p"
    bf16_flops: float = 459e12  # peak MXU bf16 FLOP/s
    f32_flops: float = 115e12
    hbm_bandwidth: float = 2.76e12  # bytes/s
    hbm_capacity: float = 95e9  # bytes
    ici_bandwidth: float = 100e9  # bytes/s per link per direction
    ici_links: int = 6  # 3D torus: 6 links/chip
    ici_latency: float = 1e-6  # seconds
    dcn_bandwidth: float = 25e9  # bytes/s per host
    dcn_latency: float = 10e-6
    # fixed cost PER COLLECTIVE INVOCATION, independent of group size —
    # negligible on real ICI (0 by default) but dominant on the virtual
    # CPU mesh, where every collective is a cross-thread rendezvous: a
    # strategy with many sequential subgroup collectives (hybrid dp x tp)
    # pays this once per psum/allreduce where a per-hop-linear latency
    # model predicts almost nothing
    coll_overhead: float = 0.0
    # how strongly INDEPENDENT group instances of one collective (a
    # dp x tp mesh psums over n_dev/n groups at once) serialize through
    # the rendezvous: the per-invocation constant is multiplied by
    # groups**coll_groups_alpha. 0 = fully concurrent (real ICI and —
    # per the round-5 honest hybrid measurement — today's XLA host
    # platform), 1 = fully serialized (the old assumption, fitted to a
    # measurement that turned out to be running replicated)
    coll_groups_alpha: float = 0.0


@dataclasses.dataclass(frozen=True)
class MachineSpec:
    """The machine the search optimizes for (reference: MachineResource).

    num_nodes        -- hosts (DCN endpoints)
    devices_per_node -- devices per host
    topology         -- ICI torus dims of the full slice, e.g. (4, 4, 2)
    """

    num_nodes: int = 1
    devices_per_node: int = 4
    chip: TPUChipSpec = dataclasses.field(default_factory=TPUChipSpec)
    topology: Optional[Tuple[int, ...]] = None

    @property
    def num_devices(self) -> int:
        return self.num_nodes * self.devices_per_node

    def torus_dims(self) -> Tuple[int, ...]:
        if self.topology:
            return self.topology
        # default: factor into a near-square 2D torus
        n = self.num_devices
        a = int(math.isqrt(n))
        while n % a:
            a -= 1
        return (a, n // a)


@dataclasses.dataclass(frozen=True)
class MachineView:
    """An n-dim sub-grid of devices (reference: machine_view.h:14-49).

    device id of grid point p = start_device_id + sum(p[i] * stride[i]).
    """

    start_device_id: int
    dims: Tuple[int, ...]  # grid extent per view dim
    strides: Tuple[int, ...]

    @property
    def num_parts(self) -> int:
        return math.prod(self.dims) if self.dims else 1

    def device_ids(self) -> List[int]:
        ids = []
        def rec(i, base):
            if i == len(self.dims):
                ids.append(base)
                return
            for p in range(self.dims[i]):
                rec(i + 1, base + p * self.strides[i])
        rec(0, self.start_device_id)
        return ids

    def to_hash(self) -> int:
        return hash((self.start_device_id, self.dims, self.strides))

    @classmethod
    def all_devices(cls, num_devices: int) -> "MachineView":
        return cls(0, (num_devices,), (1,))


def enumerate_machine_views(machine: MachineSpec, max_dims: int = 2) -> List[MachineView]:
    """All 1-D and 2-D contiguous device grids (reference:
    FFModel::register_all_machine_views, model.h:671).

    On a TPU slice, useful views are contiguous runs along torus axes —
    XLA collectives are fastest over physically-adjacent chips — so we
    enumerate runs at every divisor size of the machine (the reference
    instantiates per-divisor degrees, substitution.cc:1726-1840; a
    6-device machine must offer size-3 and size-6 views, not just
    powers of two) at aligned offsets, plus 2-D tiles.
    """
    n = machine.num_devices
    views: List[MachineView] = []
    # 1-D views: every divisor size PLUS every power-of-two size (a
    # 6-device machine keeps its partial-machine dp=4 placement), every
    # aligned offset
    sizes = sorted(set(_divisors(n)) | {1 << k for k in range(n.bit_length()) if (1 << k) <= n})
    for size in sizes:
        for start in range(0, n - size + 1, size):
            views.append(MachineView(start, (size,), (1,)))
    if max_dims >= 2:
        for size in sizes:
            for d0 in _divisors(size):
                d1 = size // d0
                if d0 < 2 or d1 < 2:
                    continue
                for start in range(0, n - size + 1, size):
                    views.append(MachineView(start, (d0, d1), (d1, 1)))
    return views


def _divisors(n: int) -> List[int]:
    return [d for d in range(1, n + 1) if n % d == 0]

"""Hardware descriptions for BaPipe's explorer (the port's copy of
``repro/core/hardware.py``, with the port's own ``H100``).

BaPipe consumes per-accelerator *hardware constraints*: compute power,
memory bandwidth, memory capacity, and link (communication) bandwidth
(paper Fig. 3).  Clusters may be heterogeneous — every accelerator in the
daisy chain can be a different device.

Units: FLOP/s, bytes/s, bytes.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

GiB = 1024 ** 3
GB = 1e9
TFLOPS = 1e12
GBps = 1e9


@dataclasses.dataclass(frozen=True)
class DeviceSpec:
    """One accelerator."""

    name: str
    peak_flops: float          # dense matmul peak (training precision)
    hbm_bandwidth: float       # high-bandwidth (device) memory, bytes/s
    memory_capacity: float     # high-bandwidth memory capacity, bytes
    link_bandwidth: float      # p2p link to the pipeline neighbour, bytes/s
    # FPGA-ish knob: can this device compute FP and BP concurrently
    # (spatial dataflow) and stream outputs while computing?
    async_capable: bool = False
    # Fraction of peak actually achievable on DNN layers (efficiency).
    efficiency: float = 0.5
    # Second-tier memory for weight spill (FPGA DDR).  0 => hard limit.
    spill_bandwidth: float = 0.0
    # Per-mesh-axis link bandwidths, bytes/s (None = inherit the scalar
    # ``link_bandwidth``).  The three axes carry different traffic:
    # ``stage`` the pipeline boundary activations/errors, ``data`` the
    # gradient all-reduce buckets, ``tensor`` the per-layer collective
    # ops.  On real topologies they are different links (e.g. intra-host
    # ICI/NVLink for tensor, inter-host DCN for data), so the explorer's
    # AR and TP-collective costs must not read the stage link.  An
    # EXPLICIT zero is rejected at construction: the old ``0.0`` default
    # silently fell back to ``link_bandwidth``, which let 3D cost models
    # quietly price TP collectives at the inter-host rate.
    data_bandwidth: Optional[float] = None
    stage_bandwidth: Optional[float] = None
    tensor_bandwidth: Optional[float] = None

    def __post_init__(self):
        for axis in ("data", "stage", "tensor"):
            bw = getattr(self, f"{axis}_bandwidth")
            if bw is not None and bw <= 0.0:
                raise ValueError(
                    f"{self.name}: {axis}_bandwidth must be positive "
                    f"(got {bw!r}); pass None to inherit link_bandwidth")
        if self.link_bandwidth <= 0.0:
            raise ValueError(f"{self.name}: link_bandwidth must be "
                             f"positive (got {self.link_bandwidth!r})")

    @property
    def effective_flops(self) -> float:
        return self.peak_flops * self.efficiency

    def axis_bandwidth(self, axis: str) -> float:
        """Link bandwidth of one mesh axis (``data``/``stage``/
        ``tensor``).  The fallback to the scalar ``link_bandwidth`` is
        explicit: only an UNSET (None) per-axis entry inherits it; a
        zero entry is a construction error, never a silent fallback."""
        try:
            bw = getattr(self, f"{axis}_bandwidth")
        except AttributeError:
            raise ValueError(f"unknown mesh axis {axis!r}") from None
        return self.link_bandwidth if bw is None else bw


# ---------------------------------------------------------------------------
# Catalogue.  TPU_V5E, V100, VCU118 and VCU129 are the JAX package's
# entries, copied as planner inputs: the paper's clusters, and parity
# with the reference planner, need them.  They are not measurements of
# the port.  H100 is the port's target, from its own card.
# ---------------------------------------------------------------------------

TPU_V5E = DeviceSpec(
    name="tpu_v5e",
    peak_flops=197e12,
    hbm_bandwidth=819 * GBps,
    memory_capacity=16 * GiB,
    link_bandwidth=50 * GBps,
    async_capable=True,
    efficiency=0.55,
    data_bandwidth=25 * GBps,
    stage_bandwidth=50 * GBps,
    tensor_bandwidth=50 * GBps,
)

V100 = DeviceSpec(
    name="v100",
    peak_flops=125e12,
    hbm_bandwidth=900 * GBps,
    memory_capacity=16 * GiB,
    link_bandwidth=13 * GBps,
    async_capable=False,
    efficiency=0.35,
    data_bandwidth=12.5 * GBps,
    stage_bandwidth=13 * GBps,
    tensor_bandwidth=13 * GBps,
)


def _fpga(name: str, dsp: int, onchip_mb: float, ddr_gbps: float,
          transceiver_gbps: float) -> DeviceSpec:
    # the paper's Table 5 devices, modelled as the JAX package models them
    peak = dsp * 500e6 * 2 * 2
    onchip_bw = (onchip_mb * 1e6 / 8) / 36e3 * 500e6
    return DeviceSpec(
        name=name,
        peak_flops=peak,
        hbm_bandwidth=onchip_bw,
        memory_capacity=onchip_mb * 1e6 / 8,              # Mb -> bytes
        link_bandwidth=transceiver_gbps * GBps,
        async_capable=True,
        efficiency=0.8,
        spill_bandwidth=ddr_gbps * GBps,
    )


VCU118 = _fpga("vcu118", dsp=6840, onchip_mb=345.9, ddr_gbps=40,
               transceiver_gbps=25)
VCU129 = _fpga("vcu129", dsp=12288, onchip_mb=454.9, ddr_gbps=40,
               transceiver_gbps=25)

# NVLink 4 between H100 SXM cards: NVIDIA's published 900 GB/s per card,
# both directions together; 450 GB/s a direction.  Not measured: one card
# has no peer to measure it against (ROADMAP Queue 1 item 7).
_NVLINK_PUBLISHED = 450 * GBps

# The port's card, "NVIDIA H100 80GB HBM3, 700.00 W" (nvidia-smi
# name,power.limit), measured by ``chip_smoke.device_rates``.  The port
# trains in f32, so the peak is the f32 rate outside the tensor cores
# (NVIDIA's data sheet); ``efficiency`` is cuBLAS's f32 rate over one
# llama3.2-1b training layer's GEMMs (51.03-51.09 TFLOP/s) over that
# peak; ``hbm_bandwidth`` a device-to-device copy (3.038-3.046e12 B/s,
# bytes read + written); ``memory_capacity`` what
# ``torch.cuda.get_device_properties`` reports.  Compute and transfers
# run in turn, as the port's executor runs every tick on one stream.
H100 = DeviceSpec(
    name="h100",
    peak_flops=67e12,
    hbm_bandwidth=3.04e12,
    memory_capacity=85017493504,
    link_bandwidth=_NVLINK_PUBLISHED,
    async_capable=False,
    efficiency=0.762,
    data_bandwidth=_NVLINK_PUBLISHED,
    stage_bandwidth=_NVLINK_PUBLISHED,
    tensor_bandwidth=_NVLINK_PUBLISHED,
)

#: the devices ``--cluster`` names, by ``DeviceSpec.name``
CATALOGUE = {d.name: d for d in (TPU_V5E, V100, VCU118, VCU129, H100)}


@dataclasses.dataclass(frozen=True)
class ClusterSpec:
    """A 1-D daisy chain of (possibly heterogeneous) accelerators."""

    devices: tuple[DeviceSpec, ...]

    @property
    def n(self) -> int:
        return len(self.devices)

    @property
    def homogeneous(self) -> bool:
        return len({d.name for d in self.devices}) == 1

    def link_bandwidth(self, i: int) -> float:
        """Bandwidth of the link between stage i and stage i+1 (min of ends)."""
        return min(self.devices[i].link_bandwidth,
                   self.devices[i + 1].link_bandwidth)

    def axis_bandwidth(self, axis: str) -> float:
        """Cluster-wide bandwidth of one mesh axis: the slowest
        device's entry bounds the collective (ring all-reduce moves at
        the slowest link)."""
        return min(d.axis_bandwidth(axis) for d in self.devices)


def homogeneous_cluster(dev: DeviceSpec, n: int) -> ClusterSpec:
    return ClusterSpec(devices=(dev,) * n)


def heterogeneous_cluster(devs: Sequence[DeviceSpec]) -> ClusterSpec:
    return ClusterSpec(devices=tuple(devs))


# ---------------------------------------------------------------------------
# Device pools: the 3D explorer's hardware input.
# ---------------------------------------------------------------------------

def fused_device(base: DeviceSpec, width: int) -> DeviceSpec:
    """Model a ``width``-chip tensor-parallel stage group as one BaPipe
    accelerator: width x compute, HBM bandwidth and capacity, while the
    per-axis link bandwidths stay per-chip (collectives move at the
    link rate regardless of the group size)."""
    if width < 1:
        raise ValueError(f"width must be >= 1, got {width}")
    if width == 1:
        return base
    return dataclasses.replace(
        base,
        name=f"{base.name}x{width}",
        peak_flops=base.peak_flops * width,
        hbm_bandwidth=base.hbm_bandwidth * width,
        memory_capacity=base.memory_capacity * width)


@dataclasses.dataclass(frozen=True)
class FleetSpec:
    """An UNORDERED pool of accelerators plus per-axis fabric rates —
    what the 3D explorer plans against.  Unlike :class:`ClusterSpec`
    (an ordered daisy chain with one device per stage), a fleet is raw
    capacity: the planner decides how many chips each stage gets (its
    ``dp x tp`` shard) and only then derives the chain, so "fat stages
    buy width instead of depth" is expressible.

    Devices within one stage group must be identical (a TP group lock-
    steps its chips); the pool itself may mix device types — groups are
    carved from the pool in order."""

    devices: tuple[DeviceSpec, ...]

    def __post_init__(self):
        if not self.devices:
            raise ValueError("FleetSpec needs at least one device")

    @property
    def n_devices(self) -> int:
        return len(self.devices)

    @property
    def homogeneous(self) -> bool:
        return len({d.name for d in self.devices}) == 1

    @property
    def base(self) -> DeviceSpec:
        return self.devices[0]

    def chain(self, widths: Sequence[int]) -> ClusterSpec:
        """Carve the pool, in order, into ``len(widths)`` stage groups
        of ``widths[i]`` chips each and return the derived daisy chain
        of fused stage accelerators.  Rejects over-budget carvings and
        mixed-device groups."""
        widths = [int(w) for w in widths]
        if any(w < 1 for w in widths):
            raise ValueError(f"stage widths must be >= 1, got {widths}")
        if sum(widths) > self.n_devices:
            raise ValueError(
                f"stage widths {widths} need {sum(widths)} devices, "
                f"fleet has {self.n_devices}")
        stages, k = [], 0
        for w in widths:
            group = self.devices[k:k + w]
            k += w
            if len({d.name for d in group}) != 1:
                raise ValueError(
                    f"stage group {group} mixes device types; a TP "
                    f"group's chips must be identical")
            stages.append(fused_device(group[0], w))
        return ClusterSpec(devices=tuple(stages))


def homogeneous_fleet(dev: DeviceSpec, n: int) -> FleetSpec:
    return FleetSpec(devices=(dev,) * n)

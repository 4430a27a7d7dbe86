"""Device meshes for splitting the MPPI sample axis, or a seed batch, over
devices.

Port of ``m3p2i_aip_tpu/parallel/mesh.py``.  The K rollout samples are
embarrassingly parallel through the dynamics; only the weights need the
whole [K] cost vector.  The JAX package lays a 1-D ``jax.sharding.Mesh``
over the "samples" axis and lets ``shard_map`` run the fused rollout on each
device's K/n slice.  Here one controller process holds a list of devices
instead (no ``torch.distributed``): the planner cuts its [K, ...] tensors
into n contiguous slices, launches each slice's rollout on its device's
current stream with the slice's global sample offset ``k0``, and gathers
the costs back onto the first device in shard order, where the weights run
once.  A list may repeat a device: ``[torch.device("cpu")] * 8`` is the
counterpart of the JAX tests' 8-device virtual CPU mesh, and
``[torch.device("cuda:0")] * 8`` splits one card eight ways.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

import torch

SAMPLE_AXIS = "samples"


def _canonical(device) -> torch.device:
    """``device`` with its index filled in ("cuda" -> the current card), so
    that a mesh's devices compare equal to the devices of tensors on them."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


@dataclass(frozen=True)
class Mesh:
    """A 1-D mesh: ``devices`` in shard order (a device may repeat)."""

    devices: tuple
    axis_name: str = SAMPLE_AXIS

    @property
    def size(self) -> int:
        return len(self.devices)


def make_mesh(devices: Optional[Sequence] = None) -> Mesh:
    """1-D mesh over the sample axis: every visible CUDA device by default,
    else the given devices."""
    if devices is None:
        n = torch.cuda.device_count()
        if n == 0:
            raise RuntimeError("make_mesh: no CUDA device is visible; pass the devices, e.g. [torch.device('cpu')]")
        devices = [torch.device("cuda", i) for i in range(n)]
    devices = tuple(_canonical(d) for d in devices)
    if not devices:
        raise ValueError("make_mesh: a mesh needs at least one device")
    return Mesh(devices)


@dataclass(frozen=True)
class SampleSharding:
    """The split of a leading axis into ``mesh.size`` contiguous slices, slice
    i on ``mesh.devices[i]``, and the gather back onto ``mesh.devices[0]``."""

    mesh: Mesh

    def piece(self, x: torch.Tensor, i: int, dim: int = 0) -> torch.Tensor:
        """Slice ``i`` of ``x`` along ``dim``, on shard i's device."""
        n = x.shape[dim] // self.mesh.size
        return x.narrow(dim, i * n, n).to(self.mesh.devices[i])

    def split(self, x: torch.Tensor, dim: int = 0) -> list:
        return [self.piece(x, i, dim) for i in range(self.mesh.size)]

    def gather(self, parts: Sequence[torch.Tensor], dim: int = 0) -> torch.Tensor:
        home = self.mesh.devices[0]
        return torch.cat([p.to(home) for p in parts], dim=dim)


def sample_sharding(mesh: Mesh) -> SampleSharding:
    """Sharding for [K, ...] tensors: partitioned on the leading sample axis."""
    return SampleSharding(mesh)


def shard_planner(planner, mesh: Optional[Mesh] = None):
    """Attach a mesh to an MPPI/M3P2I planner (in place) and return it.

    The planner's rollouts then run as one launch per shard on each shard's
    K/n samples.  K must be divisible by the mesh size, and the mesh's first
    device, where the costs are gathered, must be the planner's.  Through
    ``set_mesh``, which drops the planner's compiled programs: on one card
    the next command (or tick) captures the shards as parallel branches of
    its graph; over distinct cards the planner runs eagerly.
    """
    mesh = mesh if mesh is not None else make_mesh()
    n = mesh.size
    if planner.K % n:
        raise ValueError(f"num_samples={planner.K} not divisible by mesh size {n}")
    if mesh.devices[0] != _canonical(planner.device):
        raise ValueError(f"the mesh starts on {mesh.devices[0]}, the planner runs on {planner.device}")
    planner.set_mesh(mesh)
    return planner

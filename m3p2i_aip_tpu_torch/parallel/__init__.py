"""Splitting the sample axis (and a seed batch) over a list of devices.

The JAX package shards its sample axis over a ``jax.sharding.Mesh``; the
port keeps one controller and a list of devices (``parallel/mesh.py``): one
rollout launch per shard with its global sample offset, the costs gathered
onto the first device for one weights launch.
"""
from m3p2i_aip_tpu_torch.parallel.mesh import (
    SAMPLE_AXIS,
    make_mesh,
    sample_sharding,
    shard_planner,
)

"""Device mesh construction for sharded survey processing.

The workload's parallel axes (SURVEY.md §2.6): ping_time is the long axis
(data/sequence parallelism analog) and channel is small (tensor-parallel
analog).  A (ping, channel) mesh shards the [C, P, R] blocks so range stays
contiguous per device — collectives only carry binned partial sums.  The
mesh is a plain reshape of the device list: it assumes no interconnect
topology.
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh

__all__ = ["make_mesh"]


def make_mesh(n_devices=None, channel_axis: int = 1, range_axis: int = 1, devices=None) -> Mesh:
    """Build a (ping, channel[, range]) mesh over available devices.

    channel_axis devices shard the channel dimension (tensor-parallel analog)
    and range_axis devices shard range_sample (sequence-parallel analog); the
    rest shard ping_time (data-parallel analog).  range_axis > 1 returns a
    3-axis mesh.
    """
    if devices is None:
        devices = jax.devices()
    if n_devices is not None:
        devices = devices[:n_devices]
    n = len(devices)
    if n % (channel_axis * range_axis) != 0:
        raise ValueError(
            f"n_devices={n} not divisible by channel_axis*range_axis="
            f"{channel_axis * range_axis}"
        )
    ping_axis = n // (channel_axis * range_axis)
    if range_axis > 1:
        arr = np.array(devices).reshape(ping_axis, channel_axis, range_axis)
        return Mesh(arr, axis_names=("ping", "channel", "range"))
    arr = np.array(devices).reshape(ping_axis, channel_axis)
    return Mesh(arr, axis_names=("ping", "channel"))

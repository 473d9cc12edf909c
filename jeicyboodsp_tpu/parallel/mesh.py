"""Device-mesh construction for the framework's sharding axes.

The reference is single-threaded (SURVEY §2: no parallelism anywhere); the
framework introduces two first-class axes:

- ``data``: independent audio streams / classes / files (pure batch
  parallelism, no communication);
- ``time``: the block/sequence axis of ONE stream.  DSP state dependencies
  along time are bounded halos (overlap-save history, STFT frames) plus
  associative prefix states (noise latch, MVDR covariance), so time-sharding
  communicates only halo ppermutes and small prefix all_gathers between
devices (NVLink on a multi-GPU host; every device reaches every other at
the same rate, so no mesh assumes a torus).
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh


def init_distributed(coordinator: str | None = None, num_processes: int | None = None, process_id: int | None = None):
    """Initialize multi-host JAX when running across several hosts.

    On a single host this is a no-op.  Call before any jax API on each host:
    afterwards ``jax.devices()`` spans every host and ``make_mesh`` builds
    meshes over all of them (data/time axes laid out so halo ppermutes stay
    within a host's devices and only the chunk boundaries cross hosts).
    """
    if coordinator is None:
        return  # single-host
    jax.distributed.initialize(
        coordinator_address=coordinator,
        num_processes=num_processes,
        process_id=process_id,
    )


def make_mesh(shape=None, axis_names=("data", "time"), devices=None):
    """Build a Mesh over the available devices.

    ``shape=None`` puts all devices on the last axis (time).
    """
    devices = devices if devices is not None else jax.devices()
    n = len(devices)
    if shape is None:
        shape = (1,) * (len(axis_names) - 1) + (n,)
    assert int(np.prod(shape)) == n, (shape, n)
    dev_array = np.asarray(devices).reshape(shape)
    return Mesh(dev_array, axis_names)

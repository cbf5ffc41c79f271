"""Device mesh construction and multi-host helpers."""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import jax
import numpy as np
from jax.sharding import Mesh


def device_count() -> int:
    return jax.device_count()


def make_mesh(axis_names: Tuple[str, ...] = ("tasks",),
              shape: Optional[Sequence[int]] = None,
              devices=None) -> Mesh:
    """Mesh over the available devices.

    Default: 1-D mesh over all devices. Multi-axis meshes (e.g. ("tasks",
    "paths")) split the device grid accordingly. The cards of one host are
    joined all to all (NVLink), so the axis order follows the algorithm.
    """
    devs = np.asarray(devices if devices is not None else jax.devices())
    if shape is None:
        shape = (len(devs),) if len(axis_names) == 1 else None
    if shape is None:
        raise ValueError("shape is required for multi-axis meshes")
    if int(np.prod(shape)) != len(devs):
        raise ValueError(f"mesh shape {shape} != #devices {len(devs)}")
    return Mesh(devs.reshape(shape), axis_names)


def init_multihost(coordinator_address: Optional[str] = None,
                   num_processes: Optional[int] = None,
                   process_id: Optional[int] = None) -> None:
    """Join the multi-host JAX runtime (single-controller-per-host).

    Pass the arguments explicitly unless the cluster environment supplies
    them. Call once, before any device use. After this, jax.devices() spans
    every process's devices and every mesh in parallel/ scales across hosts
    unchanged (collectives within a host over NVLink, across hosts over the
    network).
    """
    jax.distributed.initialize(coordinator_address=coordinator_address,
                               num_processes=num_processes,
                               process_id=process_id)


def is_multihost() -> bool:
    return jax.process_count() > 1


def process_info() -> Tuple[int, int]:
    """(process_index, process_count) for multi-host launches."""
    return jax.process_index(), jax.process_count()

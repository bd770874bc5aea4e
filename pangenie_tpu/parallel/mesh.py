"""Mesh construction helpers."""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import jax
import numpy as np
from jax.sharding import Mesh


def _factor_2d(n: int) -> Tuple[int, int]:
    """Factor n into (subset, batch) with subset as small as possible
    while > 1 when n allows. The shape follows the algorithm, not the
    wiring (the GPUs of a host reach each other all to all): the only
    cross-device traffic is the psum over 'subset', so fewer subset
    devices means smaller reductions."""
    if n <= 1:
        return (1, n)
    for s in (2, 3):
        if n % s == 0:
            return (s, n // s)
    return (1, n)


def make_mesh(
    n_devices: Optional[int] = None,
    axis_names: Sequence[str] = ("subset", "batch"),
    shape: Optional[Tuple[int, int]] = None,
) -> Mesh:
    """Create a (subset, batch) mesh over the first ``n_devices`` devices.

    ``shape`` overrides the default factorization. With a single device
    both axes have size 1 (the sharded code paths still compile).
    """
    devices = jax.devices()
    if n_devices is None:
        n_devices = len(devices)
    if n_devices > len(devices):
        raise RuntimeError(
            f"make_mesh: requested {n_devices} devices, have {len(devices)}."
        )
    if shape is None:
        shape = _factor_2d(n_devices)
    if shape[0] * shape[1] != n_devices:
        raise RuntimeError(f"make_mesh: shape {shape} != {n_devices} devices.")
    mesh_devices = np.array(devices[:n_devices]).reshape(shape)
    return Mesh(mesh_devices, axis_names)

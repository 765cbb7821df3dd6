"""Device mesh construction for spatial domain decomposition."""

from __future__ import annotations

import math

import jax
import numpy as np
from jax.sharding import Mesh, PartitionSpec

AXIS_NAMES = ("x", "y", "z")


def factor_mesh(n: int) -> tuple[int, int, int]:
    """Factor a device count into a near-cubic 3-D mesh shape.

    Greedy: repeatedly assign the largest prime factor to the currently
    smallest mesh axis.  8 -> (2, 2, 2), 4 -> (2, 2, 1), 6 -> (3, 2, 1).
    """
    factors = []
    m = n
    d = 2
    while d * d <= m:
        while m % d == 0:
            factors.append(d)
            m //= d
        d += 1
    if m > 1:
        factors.append(m)
    shape = [1, 1, 1]
    for f in sorted(factors, reverse=True):
        shape[int(np.argmin(shape))] *= f
    return tuple(sorted(shape, reverse=True))


def make_mesh(n_devices: int | None = None, devices=None) -> Mesh:
    """3-D mesh over the first `n_devices` devices with axes ('x','y','z')."""
    if devices is None:
        devices = jax.devices()
    if n_devices is None:
        n_devices = len(devices)
    shape = factor_mesh(n_devices)
    dev_array = np.asarray(devices[:n_devices]).reshape(shape)
    return Mesh(dev_array, AXIS_NAMES)


def constrain_grid(arr, mesh: Mesh | None, min_per_device: int = 8):
    """Pin a traced grid to its canonical mesh partitioning (no-op without a
    mesh).

    Used inside the jitted SETUP programs (hierarchy build, window
    expansion) when they run on a mesh: GSPMD generally propagates the
    input shardings through the elementwise/shift ops, but the constraint
    makes the memory behavior deterministic -- no intermediate of a large
    build may ever materialize replicated, or the build needs as much
    memory per device as the single-device one does.
    """
    if mesh is None:
        return arr
    return jax.lax.with_sharding_constraint(
        arr,
        jax.sharding.NamedSharding(
            mesh, grid_pspec(mesh, arr.shape, min_per_device)
        ),
    )


def grid_pspec(mesh: Mesh, shape=None, min_per_device: int = 8) -> PartitionSpec:
    """PartitionSpec for a cell grid: shard each spatial axis over its mesh
    axis, but replicate axes that would drop below `min_per_device` cells
    per device (coarse levels are cheaper to replicate than to communicate).
    """
    if shape is None:
        return PartitionSpec(*AXIS_NAMES)
    spec = []
    for a, name in enumerate(AXIS_NAMES):
        n_dev = mesh.shape[name]
        if (
            n_dev > 1
            and shape[a] % n_dev == 0
            and shape[a] // n_dev >= min_per_device
        ):
            spec.append(name)
        else:
            # Replicate axes that are indivisible (e.g. the +1 axis of MAC
            # face arrays) or too small to be worth communicating (coarse
            # multigrid levels).
            spec.append(None)
    return PartitionSpec(*spec)

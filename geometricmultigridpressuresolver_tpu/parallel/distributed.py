"""Multi-host (multi-process) distribution entry point.

The reference is a single-workstation Houdini plugin with no distributed
path at all; SURVEY.md section 2.11 and BASELINE.md row 5 make multi-host
a new axis of this build: devices inside one host communicate through the
collectives XLA inserts for the block-partitioned solve (collective-permute
halos, all-reduce dots), and THIS module adds the process dimension:

  * `initialize()` wraps `jax.distributed.initialize` -- after it returns,
    `jax.devices()` spans every process and `make_mesh()` builds a global
    mesh (XLA picks the transport per mesh edge; `make_mesh` preserves
    device order, which enumerates each process's devices contiguously).
  * `process_local_slices()` / `make_global_grid()` build the global
    sharded arrays from HOST-LOCAL data: each process materializes only
    its own blocks (a 1024^3 fp32 grid is 4 GiB -- no host should hold
    the whole thing) and `jax.make_array_from_process_local_data`
    assembles the global jax.Array.

Single-process multi-chip runs need none of this (make_mesh over local
devices); see tests/test_distributed.py for the two-process CPU dryrun
and README.md for the launch recipe.
"""

from __future__ import annotations

import math
from typing import Callable, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec

from geometricmultigridpressuresolver_tpu.parallel.mesh import (
    AXIS_NAMES,
    grid_pspec,
    make_mesh,
)


def initialize(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    local_device_ids: Sequence[int] | None = None,
) -> None:
    """Join (or start) the multi-process JAX runtime.

    Thin wrapper over `jax.distributed.initialize` with the same argument
    semantics (None values auto-detect only under supported cluster
    environments such as SLURM or Open MPI; elsewhere pass all three).
    Must be called before any other JAX API touches the backend.  After it returns:

      * `jax.devices()` lists the GLOBAL device set (all processes);
      * `jax.local_devices()` lists this process's chips;
      * `global_mesh()` builds the solver mesh over the global set.

    Run one process per host with the SAME coordinator address (host 0's
    `ip:port`), `num_processes` = host count, and `process_id` = this
    host's index.
    """
    kwargs = {}
    if coordinator_address is not None:
        kwargs["coordinator_address"] = coordinator_address
    if num_processes is not None:
        kwargs["num_processes"] = num_processes
    if process_id is not None:
        kwargs["process_id"] = process_id
    if local_device_ids is not None:
        kwargs["local_device_ids"] = list(local_device_ids)
    jax.distributed.initialize(**kwargs)


def global_mesh(n_devices: int | None = None) -> Mesh:
    """The solver's 3-D ('x','y','z') mesh over the GLOBAL device set.

    `jax.devices()` enumerates each process's devices contiguously, and
    `make_mesh` reshapes in order, so the mesh's trailing (fastest-varying)
    axes stay intra-host where possible -- only the leading-axis halo
    exchanges then cross hosts.
    """
    return make_mesh(n_devices, devices=jax.devices())


def process_local_slices(
    global_shape: Sequence[int], mesh: Mesh, spec: PartitionSpec | None = None
) -> list[tuple[tuple[slice, ...], jax.Device]]:
    """The (global-index slices, device) pairs THIS process must produce.

    One entry per addressable device; feed each slice of host-local data
    to `make_global_grid`.  `spec` defaults to the solver's grid spec
    (`grid_pspec`) for `global_shape`.
    """
    if spec is None:
        spec = grid_pspec(mesh, global_shape)
    sharding = NamedSharding(mesh, spec)
    out = []
    for device, idx in sharding.addressable_devices_indices_map(
        tuple(global_shape)
    ).items():
        out.append((idx, device))
    return out


def make_global_grid(
    global_shape: Sequence[int],
    local_block: Callable[[tuple[slice, ...]], np.ndarray] | np.ndarray,
    mesh: Mesh,
    spec: PartitionSpec | None = None,
    dtype=None,
) -> jax.Array:
    """Assemble a global sharded jax.Array from host-local data.

    `local_block` is either a callable mapping a global-index slice tuple
    to that block's values (each process materializes ONLY its own blocks
    -- the scalable path for grids that exceed one host's memory), or a
    full-size array (convenience for tests/small grids; only this
    process's slices of it are read).

    Every process must call this with the same `global_shape`/`mesh`/`spec`.
    """
    if spec is None:
        spec = grid_pspec(mesh, global_shape)
    sharding = NamedSharding(mesh, spec)
    shards = []
    devices = []
    for idx, device in process_local_slices(global_shape, mesh, spec):
        if callable(local_block):
            block = np.asarray(local_block(idx))
        else:
            block = np.asarray(local_block[idx])
        if dtype is not None:
            block = block.astype(dtype, copy=False)
        shards.append(jax.device_put(block, device))
        devices.append(device)
    return jax.make_array_from_single_device_arrays(
        tuple(global_shape), sharding, shards
    )


def distribute_grid(arr, mesh: Mesh, min_per_device: int = 8) -> jax.Array:
    """Multi-host-safe counterpart of parallel.sharding.shard_grid.

    `jax.device_put` onto a sharding that spans non-addressable devices is
    a single-process-only shortcut; this assembles the global array from
    each process's own shards instead.  3-D grids get the solver's grid
    spec; everything else replicates.
    """
    arr_np = np.asarray(arr)
    spec = (
        grid_pspec(mesh, arr_np.shape, min_per_device)
        if arr_np.ndim == 3
        else PartitionSpec()
    )
    return make_global_grid(arr_np.shape, arr_np, mesh, spec)


def distribute_problem(problem, mesh: Mesh, min_per_device: int = 8):
    """Multi-host-safe counterpart of parallel.sharding.shard_problem.

    Every process passes an identical host-side problem (the small-grid
    dryrun pattern: each host builds the same setup deterministically);
    each contributes only its own device shards.  For grids too large to
    build per-host, assemble the inputs with `make_global_grid(callable)`
    and run the device-side setup sharded instead.
    """
    from geometricmultigridpressuresolver_tpu.ops import stencil
    from geometricmultigridpressuresolver_tpu.solver import mg as mg_mod
    from geometricmultigridpressuresolver_tpu.solver import mgpcg

    def level(c):
        return stencil.LevelCoeffs(
            *(distribute_grid(a, mesh, min_per_device) for a in c)
        )

    hier = mg_mod.MGHierarchy(
        levels=tuple(level(c) for c in problem.hier.levels),
        coarse_dofs=distribute_grid(problem.hier.coarse_dofs, mesh),
        coarse_minv=distribute_grid(problem.hier.coarse_minv, mesh),
        coarse_chol=distribute_grid(problem.hier.coarse_chol, mesh),
    )
    return mgpcg.PoissonProblem(fine=level(problem.fine), hier=hier)


def host_local_dofs(solvable: jax.Array) -> int:
    """This process's share of the DOF count; summed across processes this
    gives the global count.  Replication-safe: when an axis is REPLICATED
    on the mesh (grid_pspec replicates indivisible or too-small axes),
    every distinct global region is counted exactly once globally -- the
    replica on the lowest device id "owns" it, whether the replicas live
    in one process or span several.  Cheap observability for multi-host
    runs without materializing the global mask anywhere."""
    # Owner election across ALL devices (addressable or not): for each
    # index region, the lowest device id counts it.
    owners = {}
    for device, idx in solvable.sharding.devices_indices_map(
        solvable.shape
    ).items():
        key = tuple((s.start, s.stop, s.step) for s in idx)
        if key not in owners or device.id < owners[key].id:
            owners[key] = device
    total = 0
    for shard in solvable.addressable_shards:
        key = tuple((s.start, s.stop, s.step) for s in shard.index)
        if owners[key] == shard.device:
            total += int(np.asarray(shard.data).sum())
    return total

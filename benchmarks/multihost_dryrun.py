"""Multi-process (multi-host) dryrun: the BASELINE.md row-5 configuration
in miniature, runnable on one machine with N spawned processes.

Each process simulates one host with 4 virtual CPU devices; the global
mesh spans num_processes * 4 devices, so collectives cross the process
boundary.  Every process builds the SAME small problem
deterministically, contributes its own device shards
(parallel.distributed.distribute_problem), and runs the sharded MGPCG
solve; process 0 prints one JSON line with the iteration count and
recomputed residual for the launcher to compare against a single-process
run.

Launch (2 hosts on localhost):
    python benchmarks/multihost_dryrun.py --num-processes 2 --process-id 0 &
    python benchmarks/multihost_dryrun.py --num-processes 2 --process-id 1 &
On a real cluster, drop the CPU env below and run one process per host
with `--coordinator HOST0_IP:PORT` (see README.md "Multi-host").  This
script is a CPU rehearsal; it never opens a GPU.
"""

import argparse
import json
import os
import sys


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--coordinator", default="127.0.0.1:12421")
    p.add_argument("--num-processes", type=int, required=True)
    p.add_argument("--process-id", type=int, required=True)
    p.add_argument("--devices-per-process", type=int, default=4)
    p.add_argument("--n", type=int, default=16)
    p.add_argument("--tolerance", type=float, default=1e-8)
    args = p.parse_args(argv)

    # CPU-simulation env: must be set before jax initializes its backend.
    os.environ["JAX_PLATFORMS"] = "cpu"
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + f" --xla_force_host_platform_device_count={args.devices_per_process}"
        ).strip()

    import jax

    jax.config.update("jax_cpu_collectives_implementation", "gloo")
    jax.config.update("jax_enable_x64", True)

    from geometricmultigridpressuresolver_tpu.utils import runtime

    runtime.enable_compile_cache()

    from geometricmultigridpressuresolver_tpu.parallel import distributed

    distributed.initialize(
        coordinator_address=args.coordinator,
        num_processes=args.num_processes,
        process_id=args.process_id,
    )
    n_global = args.num_processes * args.devices_per_process
    assert len(jax.devices()) == n_global, (len(jax.devices()), n_global)
    assert jax.process_count() == args.num_processes

    import jax.numpy as jnp
    import numpy as np

    from geometricmultigridpressuresolver_tpu import diagnostics
    from geometricmultigridpressuresolver_tpu.config import SolverConfig
    from geometricmultigridpressuresolver_tpu.solver import mgpcg

    # Identical deterministic problem on every process.
    base = diagnostics.build_simple_domain(args.n)
    labels, weights, offset, mg_levels = diagnostics.expand(base)
    config = SolverConfig(tolerance=args.tolerance)
    problem = mgpcg.build_problem(labels, weights, mg_levels, config)
    solvable = np.asarray(problem.fine.solvable)
    rhs_host = diagnostics.delta_spike_rhs(
        labels.shape, solvable=solvable, offset=offset, base_shape=base.shape
    )

    mesh = distributed.global_mesh()
    dist_problem = distributed.distribute_problem(problem, mesh)
    rhs = distributed.distribute_grid(jnp.asarray(rhs_host), mesh)
    local_dofs = distributed.host_local_dofs(dist_problem.fine.solvable)

    result = mgpcg.solve(dist_problem, rhs, config=config)
    out = {
        "process_id": args.process_id,
        "num_processes": args.num_processes,
        "global_devices": n_global,
        "local_dofs": local_dofs,
        "iterations": int(result.iterations),
        "relative_residual": float(result.relative_residual),
        "converged": bool(result.converged),
    }
    print(json.dumps(out), flush=True)
    # All processes must stay alive until the collectives drain.
    jax.effects_barrier()
    jax.distributed.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Weak-scaling harness: block-partitioned MGPCG across a device mesh.

Scales the grid with the device count (fixed cells per device) and reports
per-device throughput and weak-scaling efficiency vs the 1-device run --
the BASELINE.md 512^3-multi-host configuration in harness form.

On several GPUs this measures the halo-exchange and reduction overhead of
the GSPMD-partitioned solve.  --virtual N instead runs the identical
sharded program on N virtual CPU devices as a CPU rehearsal: it validates
the partitioning and collectives, and its times are CPU times, labelled
so in every output line.

Usage:
  python benchmarks/weak_scaling.py [--base 128] [--devices 1 2 4 8] [--virtual 8]
"""

import argparse
import json
import sys
import time


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--base", type=int, default=128, help="per-device grid edge")
    p.add_argument("--devices", type=int, nargs="*", default=None)
    p.add_argument("--virtual", type=int, default=0,
                   help="force N virtual CPU devices (testing without hardware)")
    p.add_argument("--reps", type=int, default=3)
    args = p.parse_args()

    if args.virtual:
        import os

        os.environ["XLA_FLAGS"] = (
            os.environ.get("XLA_FLAGS", "")
            + f" --xla_force_host_platform_device_count={args.virtual}"
        ).strip()
        os.environ["JAX_PLATFORMS"] = "cpu"

    import jax

    if args.virtual:
        jax.config.update("jax_platforms", "cpu")

    import jax.numpy as jnp
    import numpy as np

    from geometricmultigridpressuresolver_tpu.config import SolverConfig
    from geometricmultigridpressuresolver_tpu.models import free_surface, sdf
    from geometricmultigridpressuresolver_tpu.parallel import (
        factor_mesh,
        make_mesh,
        shard_setup,
        shard_velocity,
    )
    from geometricmultigridpressuresolver_tpu.solver import mgpcg
    from geometricmultigridpressuresolver_tpu.utils import runtime

    if not args.virtual:
        runtime.require_gpu("weak_scaling")
    runtime.enable_compile_cache()
    print(runtime.describe_device(), file=sys.stderr, flush=True)
    all_devices = jax.devices()
    counts = args.devices or sorted(
        {1, 2, len(all_devices)} - {0}
    )
    counts = [c for c in counts if c <= len(all_devices)]

    config = SolverConfig(
        solve_dtype=jnp.float32,
        mg_dtype=jnp.float32,
        tolerance=1e-5,
        max_iterations=200,
    )

    base_dof_s = None
    for nd in counts:
        mx, my, mz = factor_mesh(nd)
        shape = (args.base * mx, args.base * my, args.base * mz)
        phi, velocity = sdf.splash_scene(shape, xp=jnp)
        weights = sdf.open_box_weights(shape, xp=jnp)
        setup = free_surface.build_setup(phi, weights, config=config)
        ndof = int(np.asarray(setup.problem.fine.solvable).sum())

        if nd > 1:
            mesh = make_mesh(nd, all_devices)
            setup = shard_setup(setup, mesh)
            velocity = shard_velocity(
                tuple(jnp.asarray(v, dtype=jnp.float32) for v in velocity), mesh
            )
        else:
            velocity = tuple(jnp.asarray(v, dtype=jnp.float32) for v in velocity)

        rhs_base = free_surface.negative_divergence(
            setup.liquid_mask, velocity, setup.weights
        )
        rhs = free_surface._embed(rhs_base, setup)
        result = mgpcg.solve(setup.problem, rhs, config=config)
        jax.block_until_ready(result.x)
        times = []
        for _ in range(args.reps):
            t0 = time.time()
            result = mgpcg.solve(setup.problem, rhs, config=config)
            jax.block_until_ready(result.x)
            times.append(time.time() - t0)
        best = min(times)
        dof_s_per_dev = ndof / best / nd
        if base_dof_s is None:
            base_dof_s = dof_s_per_dev
        print(
            json.dumps(
                {
                    "platform": all_devices[0].platform,
                    "cpu_rehearsal": bool(args.virtual),
                    "devices": nd,
                    "mesh": [mx, my, mz],
                    "grid": list(shape),
                    "dofs": ndof,
                    "iterations": int(result.iterations),
                    "solve_s": round(best, 4),
                    "dof_per_s_per_device": round(dof_s_per_dev, 1),
                    "weak_scaling_efficiency": round(dof_s_per_dev / base_dof_s, 3),
                }
            ),
            flush=True,
        )


if __name__ == "__main__":
    main()

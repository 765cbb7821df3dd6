"""Resolution sweep of the headline free-surface MGPCG solve.

The BASELINE.md config ladder (64^3 ... 512^3) on the GPU.
Prints one JSON line per size: solve seconds, CG iterations, DOF/s.

Usage: python benchmarks/sweep.py [sizes...]   (default: 64 128 256)
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax


import jax.numpy as jnp
import numpy as np

from geometricmultigridpressuresolver_tpu.config import SolverConfig
from geometricmultigridpressuresolver_tpu.models import free_surface, sdf
from geometricmultigridpressuresolver_tpu.solver import mgpcg
from geometricmultigridpressuresolver_tpu.utils import runtime


def run(n: int, reps: int = 3, tol: float = 1e-5) -> dict:
    config = SolverConfig(
        solve_dtype=jnp.float32,
        mg_dtype=jnp.float32,
        mg_ew_dtype=jnp.bfloat16,
        tolerance=tol,
        max_iterations=500,
    )
    t0 = time.time()
    phi, velocity = sdf.splash_scene((n, n, n), xp=jnp)
    weights = sdf.open_box_weights((n, n, n), xp=jnp)
    setup = free_surface.build_setup(phi, weights, config=config)
    setup_s = time.time() - t0

    velocity = tuple(jnp.asarray(v, dtype=jnp.float32) for v in velocity)
    rhs_base = free_surface.negative_divergence(
        setup.liquid_mask, velocity, setup.weights
    )
    rhs = free_surface._embed(rhs_base, setup)
    ndof = int(np.asarray(setup.problem.fine.solvable).sum())

    result = mgpcg.solve(setup.problem, rhs, config=config)
    jax.block_until_ready(result.x)
    times = []
    for _ in range(reps):
        t0 = time.time()
        result = mgpcg.solve(setup.problem, rhs, config=config)
        jax.block_until_ready(result.x)
        times.append(time.time() - t0)
    best = min(times)
    out = {
        "n": n,
        "dofs": ndof,
        "expanded": list(setup.expanded_shape),
        "iterations": int(result.iterations),
        "relative_residual": float(result.relative_residual),
        "setup_s": round(setup_s, 2),
        "solve_s": round(best, 4),
        "dof_per_s": round(ndof / best, 1),
    }
    stats = jax.devices()[0].memory_stats()
    out["peak_gb"] = round(stats["peak_bytes_in_use"] / 2**30, 2)
    out["in_use_gb"] = round(stats["bytes_in_use"] / 2**30, 2)
    return out


def main():
    sizes = [int(a) for a in sys.argv[1:]] or [64, 128, 256]
    runtime.require_gpu("sweep")
    runtime.enable_compile_cache()
    print(runtime.describe_device(), file=sys.stderr, flush=True)
    for n in sizes:
        print(json.dumps(run(n)), flush=True)


if __name__ == "__main__":
    main()

"""Per-stage profile of the headline solve on the GPU.

Prints the CG sub-step breakdown (instrumented_solve) and the per-level
V-cycle stage breakdown (vcycle_stage_times) for an N^3 splash scene.
Usage: python benchmarks/profile_stages.py [N]
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax.numpy as jnp

from geometricmultigridpressuresolver_tpu.config import SolverConfig
from geometricmultigridpressuresolver_tpu.models import free_surface, sdf
from geometricmultigridpressuresolver_tpu.utils import (
    instrumented_solve,
    runtime,
    vcycle_stage_times,
)


def main():
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 256
    runtime.require_gpu("profile_stages")
    runtime.enable_compile_cache()
    config = SolverConfig(
        solve_dtype=jnp.float32,
        mg_dtype=jnp.float32,
        mg_ew_dtype=jnp.bfloat16,
        tolerance=1e-5,
        max_iterations=100,
    )
    print(f"profiling {n}^3; {runtime.describe_device()}", flush=True)
    t0 = time.time()
    phi, velocity = sdf.splash_scene((n, n, n), xp=jnp)
    weights = sdf.open_box_weights((n, n, n), xp=jnp)
    setup = free_surface.build_setup(phi, weights, config=config)
    print(f"setup {time.time() - t0:.1f}s, expanded {setup.expanded_shape}", flush=True)

    velocity = tuple(jnp.asarray(v, dtype=jnp.float32) for v in velocity)
    rhs_base = free_surface.negative_divergence(
        setup.liquid_mask, velocity, setup.weights
    )
    rhs = free_surface._embed(rhs_base, setup)

    # Warm pass (compiles every stage), then the timed pass.
    instrumented_solve(setup.problem, rhs, config=config, print_stats=False)
    x, times = instrumented_solve(setup.problem, rhs, config=config, print_stats=False)
    print("== CG sub-step breakdown ==")
    print(times.report(), flush=True)

    print("== V-cycle per-level breakdown ==")
    vt = vcycle_stage_times(setup.problem.hier, rhs, config, warmup=1, reps=3)
    print(vt.report(), flush=True)


if __name__ == "__main__":
    main()

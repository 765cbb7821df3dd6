"""Headline benchmark: 256^3 free-surface MGPCG pressure solve, DOF/s per GPU.

Matches BASELINE.md's north-star config: a free-surface splash scene at
256^3 (cropped to the liquid's multigrid window), solved by
V-cycle-preconditioned CG to the reference node's default tolerance 1e-5
(reference Source/HDK_GeometricFreeSurfacePressureSolver.cpp:65) in fp32.

Prints ONE JSON line:
  {"metric": "...", "value": DOF/s, "unit": "dof/s", "vs_baseline": ratio}

The reference publishes no numbers (BASELINE.md), so `vs_baseline` is
measured against a documented estimate of the reference's CPU throughput:
~7.4M liquid DOFs at 256^3 solved in ~7.5 s on a modern multicore CPU
=> 1.0e6 DOF/s.  That estimate is deliberately generous to the reference.

Environment knobs: BENCH_N (default 256), BENCH_TOL (default 1e-5),
BENCH_REPS (default 3), BENCH_SOLID_SPHERE (1 adds BASELINE.md row 2's
interior solid sphere).  Refuses to run without a GPU.
"""

from __future__ import annotations

import functools
import json
import os
import sys
import time


def log(*args):
    print(*args, file=sys.stderr, flush=True)


BASELINE_DOF_PER_S = 1.0e6  # documented estimate; reference publishes nothing


def main() -> None:
    import jax
    import jax.numpy as jnp

    from geometricmultigridpressuresolver_tpu.config import SolverConfig
    from geometricmultigridpressuresolver_tpu.models import free_surface, sdf
    from geometricmultigridpressuresolver_tpu.solver import mgpcg
    from geometricmultigridpressuresolver_tpu.utils import runtime

    runtime.require_gpu("bench")
    runtime.enable_compile_cache()
    print(runtime.describe_device(), flush=True)

    n = int(os.environ.get("BENCH_N", "256"))
    tol = float(os.environ.get("BENCH_TOL", "1e-5"))
    reps = int(os.environ.get("BENCH_REPS", "3"))

    log(f"bench: {n}^3 free-surface MGPCG, tol={tol}")

    config = SolverConfig(
        solve_dtype=jnp.float32,
        mg_dtype=jnp.float32,
        mg_ew_dtype=jnp.bfloat16,
        tolerance=tol,
        max_iterations=200,
    )

    # BASELINE.md row 2 scene variant: an interior solid sphere with
    # supersampled Neumann cut-cell faces (reference solid-sphere fixture,
    # Source/HDK_TestGeometricMultigrid.cpp:266-343), submerged in the pool
    # so the cut cells sit inside the liquid.  `BENCH_SOLID_SPHERE=1
    # BENCH_N=128 BENCH_TOL=1e-6` reproduces the declared row-2 config.
    solid_sphere = os.environ.get("BENCH_SOLID_SPHERE", "0") == "1"

    # Scene construction as ONE device program.
    t0 = time.time()

    @jax.jit
    def _scene():
        liquid_phi, velocity = sdf.splash_scene((n, n, n), xp=jnp)
        solid_phi = None
        if solid_sphere:
            # solid convention: phi >= 0 INSIDE the solid (models/sdf.py).
            def solid_fn(pts):
                return -sdf.sphere_sdf(pts, (0.5, 0.18, 0.5), 0.12, xp=jnp)

            weights = sdf.face_weights_from_solid(solid_fn, (n, n, n), xp=jnp)
            points, _ = sdf.cell_centers((n, n, n), xp=jnp)
            solid_phi = solid_fn(points)
        else:
            weights = sdf.open_box_weights((n, n, n), xp=jnp)
        velocity = tuple(jnp.asarray(v, dtype=jnp.float32) for v in velocity)
        return liquid_phi, velocity, weights, solid_phi

    liquid_phi, velocity, weights, solid_phi = jax.block_until_ready(_scene())
    t_scene, t0 = time.time() - t0, time.time()
    setup = free_surface.build_setup(liquid_phi, weights, config=config)
    jax.block_until_ready(setup.problem)
    log(
        f"setup in {time.time() - t0:.1f}s (+scene {t_scene:.1f}s); "
        f"expanded {setup.expanded_shape}"
    )

    ndof = int(jax.jit(lambda s: s.sum())(setup.problem.fine.solvable))
    log(f"liquid DOFs: {ndof:,}")

    @functools.partial(jax.jit, static_argnames=("base_pads", "expanded_shape"))
    def _rhs(liquid_mask, velocity, weights, window_start, base_pads, expanded_shape):
        rhs_base = free_surface.negative_divergence(liquid_mask, velocity, weights)
        return free_surface.embed_window(
            rhs_base, window_start, base_pads, expanded_shape
        )

    rhs = _rhs(
        setup.liquid_mask, velocity, setup.weights, setup.window_start,
        setup.base_pads, setup.expanded_shape,
    )
    jax.block_until_ready(rhs)

    # The solve loop needs only the problem + rhs; drop the base-grid
    # fields (phi, 3 MAC velocity grids, 3 face-weight grids, the setup's
    # retained mask/weights) so the large-N rungs get that memory back
    # before the solve allocates its working vectors.  A real
    # frame loop does the same via project(donate=True) + the in-program
    # derived-field recompute (see models/free_surface.py).
    problem = setup.problem
    del liquid_phi, velocity, weights, setup

    # Warmup/compile.
    t0 = time.time()
    result = mgpcg.solve(problem, rhs, config=config)
    jax.block_until_ready(result.x)
    log(
        f"warmup (compile+solve) {time.time() - t0:.1f}s; "
        f"iters={int(result.iterations)} rel={float(result.relative_residual):.2e} "
        f"converged={bool(result.converged)}"
    )

    times = []
    for _ in range(reps):
        t0 = time.time()
        result = mgpcg.solve(problem, rhs, config=config)
        jax.block_until_ready(result.x)
        times.append(time.time() - t0)
    best = min(times)
    log(f"solve times: {[f'{t:.3f}' for t in times]}")

    dof_per_s = ndof / best
    print(
        json.dumps(
            {
                "metric": f"{n}^3 free-surface MGPCG solve throughput (tol {tol:g}, "
                f"{int(result.iterations)} iters)",
                "value": round(dof_per_s, 1),
                "unit": "dof/s",
                "vs_baseline": round(dof_per_s / BASELINE_DOF_PER_S, 3),
            }
        )
    )


if __name__ == "__main__":
    main()

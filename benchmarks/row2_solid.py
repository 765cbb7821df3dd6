"""BASELINE.md row 2 as declared: 128^3 free-surface Dirichlet + interior
solid Neumann cut cells, MGPCG to 1e-6, through the full projection node
(so the post-projection divergence audit is printed, like the reference
node's output, Source/HDK_GeometricFreeSurfacePressureSolver.cpp:704-706).

Scene: the splash pool/drop liquid plus a solid sphere submerged in the
pool -- interior Neumann cut-cell faces inside the liquid (reference
solid-sphere fixture, Source/HDK_TestGeometricMultigrid.cpp:266-343).

Usage: python benchmarks/row2_solid.py [n] [tol]   (defaults 128, 1e-6;
needs a GPU)
"""

from __future__ import annotations

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def log(*args):
    print(*args, file=sys.stderr, flush=True)


def main() -> None:
    import jax
    import jax.numpy as jnp

    from geometricmultigridpressuresolver_tpu.config import SolverConfig
    from geometricmultigridpressuresolver_tpu.models import free_surface, sdf
    from geometricmultigridpressuresolver_tpu.utils import runtime

    runtime.require_gpu("row2_solid")
    runtime.enable_compile_cache()
    log(runtime.describe_device())

    n = int(sys.argv[1]) if len(sys.argv) > 1 else 128
    tol = float(sys.argv[2]) if len(sys.argv) > 2 else 1e-6

    config = SolverConfig(
        solve_dtype=jnp.float32,
        mg_dtype=jnp.float32,
        mg_ew_dtype=jnp.bfloat16,
        tolerance=tol,
        max_iterations=500,
    )

    t0 = time.time()

    @jax.jit
    def _scene():
        liquid_phi, velocity = sdf.splash_scene((n, n, n), xp=jnp)

        def solid_fn(pts):
            # >= 0 INSIDE the solid (models/sdf.py convention).
            return -sdf.sphere_sdf(pts, (0.5, 0.18, 0.5), 0.12, xp=jnp)

        weights = sdf.face_weights_from_solid(solid_fn, (n, n, n), xp=jnp)
        points, _ = sdf.cell_centers((n, n, n), xp=jnp)
        solid_phi = solid_fn(points)
        velocity = tuple(jnp.asarray(v, dtype=jnp.float32) for v in velocity)
        return liquid_phi, velocity, weights, solid_phi

    liquid_phi, velocity, weights, solid_phi = jax.block_until_ready(_scene())
    log(f"scene in {time.time() - t0:.1f}s")

    t0 = time.time()
    setup = free_surface.build_setup(
        liquid_phi, weights, solid_phi=solid_phi, config=config
    )
    jax.block_until_ready(setup.problem)
    ndof = int(jax.jit(lambda s: s.sum())(setup.problem.fine.solvable))
    log(
        f"setup in {time.time() - t0:.1f}s; expanded {setup.expanded_shape}; "
        f"DOFs {ndof:,}"
    )

    # Warmup (compile) + timed repeats of the FULL projection.
    result = free_surface.project(setup, velocity, config=config)
    jax.block_until_ready(result.pressure)
    times = []
    for _ in range(3):
        t0 = time.time()
        result = free_surface.project(setup, velocity, config=config)
        jax.block_until_ready(result.pressure)
        times.append(time.time() - t0)
    best = min(times)

    log(
        f"divergence audit: max {float(result.max_divergence):.3e} "
        f"accumulated {float(result.accumulated_divergence):.3e} "
        f"avg {float(result.avg_divergence):.3e}"
    )
    log(
        f"recomputed residual: rel-L2 {float(result.residual_rel_l2):.3e} "
        f"Linf {float(result.residual_linf):.3e}"
    )
    print(
        json.dumps(
            {
                "metric": f"{n}^3 solid-sphere free-surface projection "
                f"(tol {tol:g}, {int(result.cg.iterations)} iters)",
                "iters": int(result.cg.iterations),
                "converged": bool(result.cg.converged),
                "solve_s": round(best, 4),
                "dof_per_s": round(ndof / best, 1),
                "max_divergence": float(result.max_divergence),
                "residual_rel_l2": float(result.residual_rel_l2),
            }
        )
    )


if __name__ == "__main__":
    main()

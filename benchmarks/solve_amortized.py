"""Loop-amortized whole-solve timing (the 64^3 ladder question).

At 64^3 a single solve is short enough that per-call wall-clock includes
the host's dispatch and synchronization.  This jits a K-solve
`lax.fori_loop` into ONE program (data-dependent chaining so XLA cannot
elide iterations; the rhs fed to every solve is bitwise the original, so
each iteration runs the identical CG trajectory) and divides: device time
per solve.  Needs a GPU.

Usage: python benchmarks/solve_amortized.py [N [K]]   (defaults 64, 20)
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax


import jax.numpy as jnp

from geometricmultigridpressuresolver_tpu.config import SolverConfig
from geometricmultigridpressuresolver_tpu.models import free_surface, sdf
from geometricmultigridpressuresolver_tpu.solver import mgpcg
from geometricmultigridpressuresolver_tpu.utils import runtime


def main():
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 64
    k = int(sys.argv[2]) if len(sys.argv) > 2 else 20
    tol = float(os.environ.get("BENCH_TOL", "1e-5"))
    config = SolverConfig(
        solve_dtype=jnp.float32, mg_dtype=jnp.float32,
        mg_ew_dtype=jnp.bfloat16, tolerance=tol, max_iterations=200,
    )
    runtime.require_gpu("solve_amortized")
    runtime.enable_compile_cache()
    print(f"{runtime.describe_device()}; {n}^3 scene, K={k}", flush=True)

    @jax.jit
    def _scene():
        phi, velocity = sdf.splash_scene((n, n, n), xp=jnp)
        weights = sdf.open_box_weights((n, n, n), xp=jnp)
        return phi, tuple(jnp.asarray(v, jnp.float32) for v in velocity), weights

    phi, velocity, weights = jax.block_until_ready(_scene())
    setup = free_surface.build_setup(phi, weights, config=config)
    rhs_base = free_surface.negative_divergence(
        setup.liquid_mask, velocity, setup.weights
    )
    rhs = free_surface.embed_window(
        rhs_base, setup.window_start, setup.base_pads, setup.expanded_shape
    )
    problem = setup.problem
    ndof = int(jax.jit(lambda s: s.sum())(problem.fine.solvable))
    print(f"liquid DOFs: {ndof:,}", flush=True)

    # Big arrays enter as jit ARGUMENTS (closing over them would embed
    # them in the program as constants); only the small static config is
    # closed over.
    @jax.jit
    def run(problem, rhs):
        def body(_, carry):
            res = mgpcg.solve(problem, carry, config=config)
            # Data dependency without changing the solved system: XLA keeps
            # 0.0 * x for float NaN semantics, so iterations chain.
            return rhs + 0.0 * res.x

        return jax.lax.fori_loop(0, k, body, rhs)

    res = mgpcg.solve(problem, rhs, config=config)
    print(
        f"single solve: iters={int(res.iterations)} "
        f"rel={float(res.relative_residual):.2e}", flush=True,
    )

    jax.block_until_ready(run(problem, rhs))  # compile + warm
    t0 = time.perf_counter()
    jax.block_until_ready(run(problem, rhs))
    per_solve = (time.perf_counter() - t0) / k
    print(
        f"amortized solve: {per_solve * 1e3:.2f} ms"
        f"  ({ndof / per_solve / 1e6:.2f}M DOF/s)", flush=True,
    )


if __name__ == "__main__":
    main()

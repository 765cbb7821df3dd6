"""fp64-CG vs fp32-CG iteration/accuracy comparison (BASELINE.md row 4).

The reference solves all-double (SolveReal = double,
Source/HDK_GeometricMultigridPoissonSolver.h:14-15); the headline bench
runs fp32 CG.  This measures what that deviation costs in accuracy, on
whatever backend JAX picks (x64 on): the splash scene solved at the same
tolerance under

  fp64/fp64  -- the reference's configuration,
  fp64/fp32  -- mixed precision (fp64 CG, fp32 V-cycle; the mode the
                reference README names as future work, README.md:34-35),
  fp32/fp32  -- the headline bench configuration,

comparing CG iteration counts, recomputed relative residuals, and the
solution delta against the fp64/fp64 answer.

Usage: python benchmarks/precision_ab.py [N]
(default N=128, BASELINE row 4's comparison size; drop to 64 on a CPU)
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp

from geometricmultigridpressuresolver_tpu.config import SolverConfig
from geometricmultigridpressuresolver_tpu.models import free_surface, sdf
from geometricmultigridpressuresolver_tpu.ops import blas, stencil
from geometricmultigridpressuresolver_tpu.solver import mgpcg
from geometricmultigridpressuresolver_tpu.utils import runtime


def run_case(name, solve_dt, mg_dt, n, tol, ref_x=None):
    config = SolverConfig(
        solve_dtype=solve_dt, mg_dtype=mg_dt, tolerance=tol,
        max_iterations=200,
    )
    phi, velocity = sdf.splash_scene((n, n, n))
    weights = sdf.open_box_weights((n, n, n))
    setup = free_surface.build_setup(phi, weights, config=config)
    velocity = tuple(jnp.asarray(v, jnp.float32) for v in velocity)
    rhs_base = free_surface.negative_divergence(
        setup.liquid_mask, velocity, setup.weights
    )
    rhs = free_surface.embed_window(
        rhs_base, setup.window_start, setup.base_pads, setup.expanded_shape
    )
    res = mgpcg.solve(setup.problem, rhs, config=config)
    # Recomputed (not drifted) residual, in fp64 regardless of solve dtype.
    c = setup.problem.fine
    x64 = res.x.astype(jnp.float64)
    b64 = rhs.astype(jnp.float64)
    c64 = c._replace(
        diag=c.diag.astype(jnp.float64), ew0=c.ew0.astype(jnp.float64),
        ew1=c.ew1.astype(jnp.float64), ew2=c.ew2.astype(jnp.float64),
        inv_diag=c.inv_diag.astype(jnp.float64),
    )
    r64 = stencil.residual(x64, b64, c64)
    rel = float(
        jnp.sqrt(blas.squared_l2_norm(r64, c.solvable))
        / jnp.sqrt(blas.squared_l2_norm(b64, c.solvable))
    )
    delta = (
        float(jnp.max(jnp.abs(x64 - ref_x)) / (jnp.max(jnp.abs(ref_x)) + 1e-300))
        if ref_x is not None else 0.0
    )
    print(
        f"{name:<12} iters={int(res.iterations):3d}  recomputed rel={rel:.3e}"
        f"  max|x - x_ref|/max|x_ref|={delta:.3e}",
        flush=True,
    )
    return x64


def main():
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 128
    tol = 1e-5
    runtime.enable_compile_cache()
    print(f"{n}^3 splash scene, tol={tol:g}, x64 on, {runtime.describe_device()}",
          flush=True)
    ref = run_case("fp64/fp64", jnp.float64, jnp.float64, n, tol)
    run_case("fp64/fp32", jnp.float64, jnp.float32, n, tol, ref_x=ref)
    run_case("fp32/fp32", jnp.float32, jnp.float32, n, tol, ref_x=ref)


if __name__ == "__main__":
    main()

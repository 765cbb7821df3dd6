"""Every public entry point must work with every optional argument
defaulted (config=None etc.).

Regression guard: `v_cycle(hier, x, b)` once crashed because a helper
read a config field before its None guard, and no test called a public
API with a defaulted config.  This module is that test.
"""

import jax.numpy as jnp
import numpy as np

from geometricmultigridpressuresolver_tpu.models import free_surface, sdf
from geometricmultigridpressuresolver_tpu.solver import cg, mg, mgpcg

from tests import helpers


def test_hierarchy_vcycle_solve_all_defaults():
    labels, weights, mg_levels = helpers.expanded_domain(
        helpers.simple_domain, 16
    )
    hier = mg.build_hierarchy(labels, weights, mg_levels)

    b = jnp.asarray(helpers.random_solvable_field(labels, seed=3))
    x = jnp.zeros_like(b)
    z = mg.v_cycle(hier, x, b)
    assert z.shape == b.shape and bool(jnp.all(jnp.isfinite(z)))

    problem = mgpcg.build_problem(labels, weights, mg_levels)
    result = mgpcg.solve(problem, b)
    assert bool(result.converged)

    # The standalone CG driver with defaulted optionals.
    res2 = cg.solve_pcg(
        lambda v: mg.stencil.apply_poisson(v, problem.fine),
        lambda r: r,
        b.astype(problem.fine.diag.dtype),
        problem.fine.solvable,
    )
    assert res2.x.shape == b.shape


def test_free_surface_all_defaults():
    n = 16
    liquid_phi, velocity = sdf.splash_scene((n, n, n))
    weights = sdf.open_box_weights((n, n, n))

    setup = free_surface.build_setup(liquid_phi, weights)
    result = free_surface.project(setup, velocity)
    assert bool(result.cg.converged)
    assert result.pressure.shape == (n, n, n)
    # Field order of the public NamedTuple is stable (ADVICE r2: new fields
    # append at the END).
    assert result[3] is result.max_divergence
    assert result[4] is result.avg_divergence
    assert result[-1] is result.accumulated_divergence

    # Re-setup reusing the previous window, all other args defaulted.
    setup2 = free_surface.build_setup(liquid_phi, weights, reuse_from=setup)
    assert setup2.expanded_shape == setup.expanded_shape


def test_config_matrix_smoke():
    """A lattice of knob combinations must all solve the same tiny problem
    (each knob is exercised elsewhere in depth; this guards the
    COMBINATIONS -- e.g. record_residuals x diagonal preconditioner,
    donate x warm start, per-level setup x chebyshev)."""
    labels, weights, mg_levels = helpers.expanded_domain(
        helpers.simple_domain, 16
    )
    b = jnp.asarray(helpers.random_solvable_field(labels, seed=9))

    combos = [
        dict(use_mg_preconditioner=False, record_residuals=True),
        dict(use_gauss_seidel=False, record_residuals=True),
        dict(interior_smoother="chebyshev", setup_fusion="per-level"),
        dict(transfer_mode="mm", mg_dtype=jnp.float32),
        dict(project_null_space=False, max_mg_levels=2,
             setup_fusion="per-level"),
    ]
    for kw in combos:
        config = mgpcg.SolverConfig(tolerance=1e-6, max_iterations=400, **kw)
        problem = mgpcg.build_problem(labels, weights, mg_levels, config)
        result = mgpcg.solve(problem, b, config=config, donate=False)
        assert bool(result.converged), kw
        result2 = mgpcg.solve(
            problem, jnp.array(b, copy=True), x0=result.x, config=config,
            donate=True,
        )
        assert bool(result2.converged), kw


def test_diagnostics_defaults():
    from geometricmultigridpressuresolver_tpu import diagnostics

    report = diagnostics.run_conjugate_gradient_test(grid_size=16)
    assert np.isfinite(report["relative_l2"])
    assert report["max_relative_difference_vs_oracle"] < 1e-3

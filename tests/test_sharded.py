"""Multi-device (8 simulated CPU devices) sharded solve tests.

The reference has no distributed path at all (SURVEY.md section 2.11);
this validates the new spatial-domain-decomposition layer: a sharded
MGPCG/projection must produce the same answer as the single-device run.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from geometricmultigridpressuresolver_tpu.config import SolverConfig
from geometricmultigridpressuresolver_tpu.models import free_surface, sdf
from geometricmultigridpressuresolver_tpu.parallel import (
    factor_mesh,
    make_mesh,
    shard_grid,
    shard_setup,
    shard_velocity,
)
from geometricmultigridpressuresolver_tpu.solver import mgpcg
from tests import helpers


def test_factor_mesh():
    assert factor_mesh(8) == (2, 2, 2)
    assert factor_mesh(4) == (2, 2, 1)
    assert factor_mesh(6) == (3, 2, 1)
    assert factor_mesh(1) == (1, 1, 1)
    assert factor_mesh(16) == (4, 2, 2)


@pytest.fixture(scope="module")
def eight_device_mesh():
    assert len(jax.devices()) >= 8, "conftest must provide 8 virtual devices"
    return make_mesh(8)


def test_sharded_mgpcg_matches_single_device(eight_device_mesh):
    mesh = eight_device_mesh
    labels, weights, mg_levels = helpers.expanded_domain(helpers.simple_domain, 16)
    config = SolverConfig(tolerance=1e-8)
    problem = mgpcg.build_problem(labels, weights, mg_levels, config)
    rhs = jnp.asarray(helpers.random_solvable_field(labels, seed=21))

    base = mgpcg.solve(problem, rhs, config=config)

    sharded_problem = shard_problem_for_test(problem, mesh)
    rhs_sharded = shard_grid(rhs, mesh)
    dist = mgpcg.solve(sharded_problem, rhs_sharded, config=config)

    assert int(dist.iterations) == int(base.iterations)
    np.testing.assert_allclose(
        np.asarray(dist.x), np.asarray(base.x), rtol=0, atol=1e-11
    )


def shard_problem_for_test(problem, mesh):
    from geometricmultigridpressuresolver_tpu.parallel import shard_problem

    return shard_problem(problem, mesh)


def test_sharded_projection_matches_single_device(eight_device_mesh):
    mesh = eight_device_mesh
    n = 16
    liquid_phi, velocity = sdf.splash_scene((n, n, n))
    weights = sdf.open_box_weights((n, n, n))
    config = SolverConfig(tolerance=1e-7)
    setup = free_surface.build_setup(liquid_phi, weights, config=config)

    base = free_surface.project(setup, velocity, config=config)

    sharded = shard_setup(setup, mesh)
    v_sharded = shard_velocity(velocity, mesh)
    dist = free_surface.project(sharded, v_sharded, config=config)

    np.testing.assert_allclose(
        np.asarray(dist.pressure), np.asarray(base.pressure), rtol=0, atol=1e-11
    )
    for a in range(3):
        np.testing.assert_allclose(
            np.asarray(dist.velocity[a]), np.asarray(base.velocity[a]),
            rtol=0, atol=1e-11,
        )
    assert float(dist.max_divergence) < 1e-6


def test_sharded_solve_lowers_to_collectives(eight_device_mesh):
    """The block-partitioned solve must compile to a program containing
    halo exchanges (collective-permute) and cross-device reductions
    (all-reduce) -- the ppermute/psum structure SURVEY.md sections 2.10-2.11
    prescribe for the 7-point stencil and the CG dot products."""
    mesh = eight_device_mesh
    labels, weights, mg_levels = helpers.expanded_domain(helpers.simple_domain, 16)
    config = SolverConfig(tolerance=1e-8)
    problem = shard_problem_for_test(
        mgpcg.build_problem(labels, weights, mg_levels, config), mesh
    )
    rhs = shard_grid(jnp.asarray(helpers.random_solvable_field(labels, seed=3)), mesh)

    hlo = (
        jax.jit(lambda p, r: mgpcg.solve(p, r, config=config))
        .lower(problem, rhs)
        .compile()
        .as_text()
    )
    assert "collective-permute" in hlo or "all-to-all" in hlo, "no halo exchange"
    assert "all-reduce" in hlo, "no cross-device reduction"

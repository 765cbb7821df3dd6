"""Free-surface pressure projection pipeline tests.

End-to-end equivalents of the reference's flipSplash oracle: the projected
velocity field must be (near-)divergence-free in the liquid, the recomputed
residual must match the convergence claim, and warm starts must help
(SURVEY.md section 4 item 3).
"""

import jax.numpy as jnp
import numpy as np
import pytest

from geometricmultigridpressuresolver_tpu.config import SolverConfig
from geometricmultigridpressuresolver_tpu.models import free_surface, sdf
from geometricmultigridpressuresolver_tpu.grids import MaterialLabel

N = 24


@pytest.fixture(scope="module")
def splash_setup():
    liquid_phi, velocity = sdf.splash_scene((N, N, N))
    weights = sdf.open_box_weights((N, N, N))
    config = SolverConfig(tolerance=1e-7)
    setup = free_surface.build_setup(liquid_phi, weights, config=config, validate=True)
    return liquid_phi, velocity, weights, config, setup


def test_material_labels(splash_setup):
    liquid_phi, _, weights, _, setup = splash_setup
    material = np.asarray(setup.material)
    # Pool bottom region is liquid, top air; closed-box edge cells have at
    # least one open face so nothing except nothing-open cells is SOLID.
    assert (material == int(MaterialLabel.LIQUID)).sum() > 0
    assert (material == int(MaterialLabel.AIR)).sum() > 0
    inside = np.asarray(liquid_phi) <= 0
    assert (material[inside] == int(MaterialLabel.LIQUID)).all()


def test_projection_removes_divergence(splash_setup):
    _, velocity, weights, config, setup = splash_setup
    liquid_mask = setup.liquid_mask

    pre_max, _, pre_avg = free_surface.divergence_stats(
        liquid_mask, tuple(jnp.asarray(v) for v in velocity), setup.weights
    )
    result = free_surface.project(setup, velocity, config=config)
    assert bool(result.cg.converged)

    assert float(result.max_divergence) < 1e-6
    assert float(result.max_divergence) < 1e-4 * float(pre_max)
    # Pressure lives only in liquid cells.
    p = np.asarray(result.pressure)
    assert (p[~np.asarray(liquid_mask)] == 0).all()


def test_warm_start_reduces_iterations(splash_setup):
    _, velocity, weights, config, setup = splash_setup
    first = free_surface.project(setup, velocity, config=config)
    warm = free_surface.project(
        setup, velocity, old_pressure=first.pressure, config=config
    )
    assert int(warm.cg.iterations) < int(first.cg.iterations)


def test_solid_sphere_scene():
    """Interior solid (Neumann) obstacle with true cut-cell weights."""
    shape = (N, N, N)
    liquid_phi, velocity = sdf.splash_scene(shape, pool_height=0.6)

    def solid_fn(pts):
        # solid sphere: positive inside the solid
        return -sdf.sphere_sdf(pts, (0.5, 0.3, 0.5), 0.15)

    weights = sdf.face_weights_from_solid(solid_fn, shape)
    points, _ = sdf.cell_centers(shape)
    solid_phi = solid_fn(points)

    config = SolverConfig(tolerance=1e-7)
    setup = free_surface.build_setup(
        liquid_phi, weights, solid_phi=solid_phi, config=config, validate=True
    )
    result = free_surface.project(setup, velocity, config=config)
    assert bool(result.cg.converged)
    assert float(result.max_divergence) < 1e-6


def test_moving_solid_velocity():
    """Solid-velocity divergence terms: a closed box moving with the fluid
    produces compatible RHS contributions on cut faces."""
    shape = (N, N, N)
    liquid_phi, _ = sdf.splash_scene(shape, pool_height=0.5)

    def solid_fn(pts):
        return -sdf.sphere_sdf(pts, (0.5, 0.35, 0.5), 0.12)

    weights = sdf.face_weights_from_solid(solid_fn, shape)
    points, _ = sdf.cell_centers(shape)
    solid_phi = solid_fn(points)

    from geometricmultigridpressuresolver_tpu.grids import face_shape

    # Zero liquid velocity; the solid pushes up through cut faces.
    velocity = tuple(np.zeros(face_shape(shape, a)) for a in range(3))
    solid_velocity = [np.zeros(face_shape(shape, a)) for a in range(3)]
    solid_velocity[1][:] = 0.5  # solid moving +y

    config = SolverConfig(tolerance=1e-7)
    setup = free_surface.build_setup(
        liquid_phi, weights, solid_phi=solid_phi, config=config
    )
    result = free_surface.project(
        setup, velocity, solid_velocity=tuple(solid_velocity), config=config
    )
    assert bool(result.cg.converged)
    # The solve reacts to the moving solid: nonzero pressure.
    assert float(jnp.max(jnp.abs(result.pressure))) > 0


def test_compact_matches_classic():
    """Compact bbox expansion is the identical linear system: same pressure."""
    shape = (20, 20, 20)
    liquid_phi, velocity = sdf.splash_scene(shape)
    weights = sdf.open_box_weights(shape)

    cfg_compact = SolverConfig(tolerance=1e-9, compact_domain=True)
    cfg_classic = SolverConfig(tolerance=1e-9, compact_domain=False)
    s_compact = free_surface.build_setup(liquid_phi, weights, config=cfg_compact, validate=True)
    s_classic = free_surface.build_setup(liquid_phi, weights, config=cfg_classic, validate=True)

    # Compact domain is strictly smaller for a pool scene.
    assert np.prod(s_compact.expanded_shape) < np.prod(s_classic.expanded_shape)

    r_compact = free_surface.project(s_compact, velocity, config=cfg_compact)
    r_classic = free_surface.project(s_classic, velocity, config=cfg_classic)
    assert bool(r_compact.cg.converged) and bool(r_classic.cg.converged)
    np.testing.assert_allclose(
        np.asarray(r_compact.pressure), np.asarray(r_classic.pressure),
        rtol=0, atol=1e-7,
    )


def test_density_validation():
    """Constant density accepted; variable density rejected (reference
    Source/HDK_GeometricFreeSurfacePressureSolver.cpp:245-250)."""
    from geometricmultigridpressuresolver_tpu.models.free_surface import validate_density

    assert validate_density(None) is None
    assert validate_density(1000.0) == 1000.0
    assert validate_density(np.full((4, 4, 4), 2.5)) == 2.5
    with pytest.raises(ValueError, match="Variable density"):
        validate_density(np.arange(8.0).reshape(2, 2, 2))


def test_all_neumann_null_space_projection():
    """Closed-box, no air: the all-Neumann (smoke) system is singular; CG
    with null-space projection must still converge to a mean-free solution
    (reference doProjectNullSpace, Source/HDK_Utilities.h:197-297)."""
    from geometricmultigridpressuresolver_tpu.grids import CellLabel
    from geometricmultigridpressuresolver_tpu.ops import blas, stencil
    from geometricmultigridpressuresolver_tpu.ops import domain
    from geometricmultigridpressuresolver_tpu.solver import mgpcg
    from tests import helpers

    n = 16
    labels = np.full((n, n, n), int(CellLabel.INTERIOR), dtype=np.int8)
    expanded, _, mg_levels = domain.expand_domain(labels)
    weights = helpers.unit_weights(expanded)
    expanded = domain.set_boundary_labels(expanded, weights)

    config = SolverConfig(
        tolerance=1e-8,
        max_iterations=400,
        project_null_space=True,
        use_mg_preconditioner=False,  # singular coarse system has no inverse
        max_mg_levels=1,
    )
    problem = mgpcg.build_problem(expanded, weights, 1, config)
    solvable = problem.fine.solvable

    rng = np.random.default_rng(2)
    rhs = jnp.where(solvable, jnp.asarray(rng.standard_normal(expanded.shape)), 0.0)
    rhs = blas.project_null_space(rhs, solvable)  # compatible RHS

    result = mgpcg.solve(problem, rhs, config=config)
    assert bool(result.converged)
    # Solution is mean-free and solves the singular system.
    mean = float(blas.masked_mean(result.x, solvable))
    assert abs(mean) < 1e-10
    r = jnp.where(solvable, rhs - stencil.apply_poisson(result.x, problem.fine), 0.0)
    rel = float(blas.l2_norm(r, solvable) / blas.l2_norm(rhs, solvable))
    assert rel < 1e-7


def test_assembled_baseline_pipeline_matches_mgpcg():
    """The classic assembled-matrix projection (the reference's baseline
    node, Source/HDK_FreeSurfacePressureSolver.cpp:107-481) must agree with
    the geometric MGPCG pipeline end-to-end."""
    from geometricmultigridpressuresolver_tpu.models import assembled

    n = 20
    phi, velocity = sdf.splash_scene((n, n, n))
    weights = sdf.open_box_weights((n, n, n))

    config = SolverConfig(tolerance=1e-9, max_iterations=500)
    setup = free_surface.build_setup(phi, weights, config=config)
    mg = free_surface.project(setup, velocity, config=config)

    p_base, v_base, max_div = assembled.project_assembled(
        phi, weights, velocity, tolerance=1e-9, max_iterations=2000
    )
    assert max_div < 1e-6
    scale = max(float(np.abs(np.asarray(mg.pressure)).max()), 1e-300)
    diff = float(np.abs(np.asarray(mg.pressure) - p_base).max()) / scale
    assert diff < 1e-5
    for a in range(3):
        np.testing.assert_allclose(
            np.asarray(mg.velocity[a]), v_base[a], atol=1e-6
        )


def test_field_validation_errors():
    """Misaligned inputs get the reference node's explicit rejections."""
    n = 8
    phi, velocity = sdf.splash_scene((n, n, n))
    weights = sdf.open_box_weights((n, n, n))

    with pytest.raises(ValueError, match="cut-cell weights must align"):
        free_surface.validate_fields(phi, [weights[0], weights[1], weights[1]])
    with pytest.raises(ValueError, match="face sampled"):
        free_surface.validate_fields(
            phi, weights, velocity=(velocity[0], velocity[0], velocity[2])
        )
    with pytest.raises(ValueError, match="collision surface must align"):
        free_surface.validate_fields(phi, weights, solid_phi=np.zeros((4, 4, 4)))
    with pytest.raises(ValueError, match="3-D cell grid"):
        free_surface.validate_fields(np.zeros((n, n)), weights)
    # Aligned inputs pass.
    free_surface.validate_fields(phi, weights, velocity=velocity)


def test_sticky_window_reuse():
    """build_setup(reuse_from=prev) keeps the previous window shape when
    the new bounding box fits, so per-frame programs stay compiled."""
    n = 24
    config = SolverConfig(tolerance=1e-6, max_iterations=200)
    phi, velocity = sdf.splash_scene((n, n, n))
    weights = sdf.open_box_weights((n, n, n))
    s0 = free_surface.build_setup(phi, weights, config=config)

    # A slightly SHRUNK liquid (drop removed) must reuse s0's shape.
    phi_shrunk = np.asarray(phi).copy()
    phi_shrunk[:, 2 * n // 3 :, :] = 1.0  # cut the top region to air
    s1 = free_surface.build_setup(
        phi_shrunk, weights, config=config, reuse_from=s0
    )
    assert s1.expanded_shape == s0.expanded_shape
    assert s1.padding == s0.padding and s1.mg_levels == s0.mg_levels

    # The reused-window solve still projects correctly.
    res = free_surface.project(s1, velocity, config=config)
    assert bool(res.cg.converged)
    assert float(res.max_divergence) < 1e-4

    # Without reuse, the shrunk scene gets its own (smaller) shape.
    s2 = free_surface.build_setup(phi_shrunk, weights, config=config)
    assert all(a <= b for a, b in zip(s2.expanded_shape, s0.expanded_shape))


def test_sticky_window_regrowth_adds_slack_on_every_axis():
    """When the previous window no longer fits, the regrown window is the
    minimal one plus `window_slack` paddings on all three axes."""
    n = 24
    config = SolverConfig(tolerance=1e-6, max_iterations=200)
    phi, velocity = sdf.splash_scene((n, n, n))
    weights = sdf.open_box_weights((n, n, n))
    phi_small = np.asarray(phi).copy()
    phi_small[:, 2 * n // 3 :, :] = 1.0  # drop removed: a shorter window
    small = free_surface.build_setup(phi_small, weights, config=config)
    minimal = free_surface.build_setup(phi, weights, config=config)
    assert any(s < m for s, m in zip(small.expanded_shape, minimal.expanded_shape))

    grown = free_surface.build_setup(phi, weights, config=config, reuse_from=small)
    slack = config.window_slack * minimal.padding
    assert grown.expanded_shape == tuple(e + slack for e in minimal.expanded_shape)
    res = free_surface.project(grown, velocity, config=config)
    assert bool(res.cg.converged)
    assert float(res.max_divergence) < 1e-4


def test_empty_liquid_degrades_gracefully():
    """A frame with no liquid anywhere must produce a trivial projection
    (zero pressure, velocity unchanged) instead of failing -- the
    zero-DOF analogue of the reference's no-liquid cook."""
    n = 16
    phi = jnp.full((n, n, n), 1.0)  # all air
    weights = sdf.open_box_weights((n, n, n))
    rng = np.random.default_rng(2)
    velocity = tuple(
        jnp.asarray(
            rng.standard_normal(tuple(n + (1 if a == ax else 0) for a in range(3)))
        )
        for ax in range(3)
    )
    config = SolverConfig()
    setup = free_surface.build_setup(phi, weights, config=config)
    assert int(np.asarray(setup.problem.fine.solvable).sum()) == 0

    result = free_surface.project(setup, velocity, config=config)
    assert int(result.cg.iterations) == 0
    assert bool(result.cg.converged)
    assert float(jnp.max(jnp.abs(result.pressure))) == 0.0
    for a in range(3):
        np.testing.assert_array_equal(
            np.asarray(result.velocity[a]), np.asarray(velocity[a])
        )

"""Operator-level tests against the scipy-assembled oracle.

Replaces the reference's Eigen cross-implementation oracle
(Source/HDK_TestGeometricMultigrid.cpp:675-1165) with scipy.sparse.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from geometricmultigridpressuresolver_tpu.models import assembled
from geometricmultigridpressuresolver_tpu.ops import blas, domain, stencil, transfer
from tests import helpers


def make_coeffs(labels, weights, dtype=jnp.float64):
    host = domain.build_level_coefficients(labels, weights, boundary_width=3)
    return stencil.LevelCoeffs.from_host(host, dtype)


@pytest.mark.parametrize("fractional", [False, True])
def test_apply_poisson_matches_scipy(fractional):
    labels, weights, _ = helpers.expanded_domain(
        helpers.sine_dirichlet_domain, 16, fractional=fractional
    )
    coeffs = make_coeffs(labels, weights)
    x = helpers.random_solvable_field(labels, seed=1)

    y_grid = np.asarray(stencil.apply_poisson(jnp.asarray(x), coeffs))

    a, idx = assembled.assemble_poisson(labels, weights)
    y_ref = assembled.vec_to_grid(a @ assembled.grid_to_vec(x, idx), idx, labels.shape)

    np.testing.assert_allclose(y_grid, y_ref, rtol=0, atol=1e-12)


def test_apply_poisson_coarse_label_only():
    labels, weights, mg_levels = helpers.expanded_domain(
        helpers.sine_dirichlet_domain, 16, fractional=True
    )
    hierarchy = domain.build_label_hierarchy(labels, mg_levels)
    coarse = hierarchy[1]
    coeffs = make_coeffs(coarse, None)
    x = helpers.random_solvable_field(coarse, seed=2)

    y_grid = np.asarray(stencil.apply_poisson(jnp.asarray(x), coeffs))
    a, idx = assembled.assemble_poisson(coarse, None)
    y_ref = assembled.vec_to_grid(a @ assembled.grid_to_vec(x, idx), idx, coarse.shape)
    np.testing.assert_allclose(y_grid, y_ref, rtol=0, atol=1e-12)


def test_interior_diagonal_is_six():
    labels, weights, _ = helpers.expanded_domain(helpers.simple_domain, 16)
    coeffs = make_coeffs(labels, weights)
    interior = np.asarray(labels) == helpers.INT
    assert (np.asarray(coeffs.diag)[interior] == 6.0).all()


@pytest.mark.parametrize(
    "smoother",
    [
        lambda x, b, c: stencil.jacobi_smooth(x, b, c),
        lambda x, b, c: stencil.rb_gauss_seidel(x, b, c, forward=True),
        lambda x, b, c: stencil.boundary_jacobi(x, b, c),
    ],
)
def test_smoothers_reduce_residual(smoother):
    labels, weights, _ = helpers.expanded_domain(
        helpers.sine_dirichlet_domain, 16, fractional=True
    )
    coeffs = make_coeffs(labels, weights)
    b = jnp.asarray(helpers.random_solvable_field(labels, seed=3))
    x = jnp.zeros_like(b)
    r0 = blas.squared_l2_norm(stencil.residual(x, b, coeffs), coeffs.solvable)
    for _ in range(4):
        x = smoother(x, b, coeffs)
    r1 = blas.squared_l2_norm(stencil.residual(x, b, coeffs), coeffs.solvable)
    assert float(r1) < float(r0)
    # Updates stay inside the solvable set.
    assert float(blas.inf_norm(x, ~coeffs.solvable)) == 0.0


def test_boundary_jacobi_only_touches_band():
    labels, weights, _ = helpers.expanded_domain(
        helpers.sine_dirichlet_domain, 16, fractional=True
    )
    coeffs = make_coeffs(labels, weights)
    b = jnp.asarray(helpers.random_solvable_field(labels, seed=4))
    x0 = jnp.asarray(helpers.random_solvable_field(labels, seed=5))
    x1 = stencil.boundary_jacobi(x0, b, coeffs)
    changed = np.asarray(x1 != x0)
    assert not changed[~np.asarray(coeffs.band)].any()


def test_restriction_prolongation_adjoint():
    labels, weights, mg_levels = helpers.expanded_domain(
        helpers.sine_dirichlet_domain, 16, fractional=True
    )
    hierarchy = domain.build_label_hierarchy(labels, mg_levels)
    fine_solv = jnp.asarray(domain.is_solvable(hierarchy[0]))
    coarse_solv = jnp.asarray(domain.is_solvable(hierarchy[1]))

    r = jnp.asarray(helpers.random_solvable_field(hierarchy[0], seed=6))
    y = jnp.asarray(helpers.random_solvable_field(hierarchy[1], seed=7))
    y = jnp.where(coarse_solv, y, 0.0)
    r = jnp.where(fine_solv, r, 0.0)

    # prolong includes the 4x level-scaling factor; per axis the interp
    # weights are 2x the restriction transpose, so  P = 4 * 8 * R^T and
    # <P y, r> = 32 <y, R r> exactly.
    lhs = float(blas.dot(transfer.prolong_add(jnp.zeros_like(r), y, fine_solv), r, fine_solv))
    rhs = 32.0 * float(blas.dot(y, transfer.restrict(r, coarse_solv), coarse_solv))
    assert abs(lhs - rhs) <= 1e-10 * max(1.0, abs(lhs))


def test_restriction_weights_partition():
    # Restricting a constant-1 fine field over a fully interior region gives
    # 1 (weights sum to 1 per axis).
    labels, weights, mg_levels = helpers.expanded_domain(helpers.simple_domain, 32)
    hierarchy = domain.build_label_hierarchy(labels, mg_levels)
    fine = jnp.ones(hierarchy[0].shape, dtype=jnp.float64)
    coarse_solv = jnp.asarray(domain.is_solvable(hierarchy[1]))
    out = transfer.restrict(fine, coarse_solv)
    # Deep interior coarse cells (away from the boundary) see the full window.
    interior = np.asarray(hierarchy[1]) == helpers.INT
    vals = np.asarray(out)[interior]
    np.testing.assert_allclose(vals, 1.0, atol=1e-13)


def test_blas_masked():
    labels, _, _ = helpers.expanded_domain(helpers.simple_domain, 16)
    solv = jnp.asarray(domain.is_solvable(labels))
    x = jnp.ones(labels.shape, dtype=jnp.float64)
    n = int(np.asarray(solv).sum())
    assert float(blas.dot(x, x, solv)) == n
    assert float(blas.inf_norm(x, solv)) == 1.0
    y = blas.project_null_space(x, solv)
    assert abs(float(blas.dot(y, jnp.ones_like(y), solv))) < 1e-10


def test_restriction_prolongation_adjoint_lane_padded():
    """Adjointness on unpadded extents whose halves are odd: the coarse grid
    is exactly fine/2 on every axis, with no trailing padding."""
    import jax.numpy as jnp

    from geometricmultigridpressuresolver_tpu.ops import transfer

    fine_shape = (18, 22, 30)
    coarse_shape = (9, 11, 15)
    rng = np.random.default_rng(5)
    fine = jnp.asarray(rng.standard_normal(fine_shape))
    coarse = jnp.asarray(rng.standard_normal(coarse_shape))
    all_fine = jnp.ones(fine_shape, dtype=bool)
    all_coarse = jnp.ones(coarse_shape, dtype=bool)

    r = transfer.restrict(fine, all_coarse)
    assert r.shape == coarse_shape
    p = transfer.prolong_add(jnp.zeros(fine_shape), coarse, all_fine)
    assert p.shape == fine_shape

    # <R f, c> == 1/(4*8) <f, P c>  (prolongation = 4 * 2^3 x restriction^T
    # per the separable weights)
    lhs = float(jnp.vdot(r, coarse))
    rhs = float(jnp.vdot(fine, p)) / 32.0
    np.testing.assert_allclose(lhs, rhs, rtol=1e-12)


def test_mm_transfers_match_slice_path():
    """Matmul transfers must equal the slice-based path (same operator,
    different rounding) and stay exactly adjoint."""
    import jax.numpy as jnp

    from geometricmultigridpressuresolver_tpu.ops import transfer

    fine_shape = (16, 24, 384)
    coarse_shape = (8, 12, 192)
    rng = np.random.default_rng(9)
    fine = jnp.asarray(rng.standard_normal(fine_shape))
    coarse = jnp.asarray(rng.standard_normal(coarse_shape))
    all_f = jnp.ones(fine_shape, dtype=bool)
    all_c = jnp.ones(coarse_shape, dtype=bool)

    r_sl = transfer.restrict(fine, all_c)
    r_mm = transfer.restrict_mm(fine, all_c)
    np.testing.assert_allclose(np.asarray(r_mm), np.asarray(r_sl), atol=1e-12)

    p_sl = transfer.prolong_add(jnp.zeros(fine_shape), coarse, all_f)
    p_mm = transfer.prolong_add_mm(jnp.zeros(fine_shape), coarse, all_f)
    np.testing.assert_allclose(np.asarray(p_mm), np.asarray(p_sl), atol=1e-12)

    lhs = float(jnp.vdot(r_mm, coarse))
    rhs = float(jnp.vdot(fine, p_mm)) / 32.0
    np.testing.assert_allclose(lhs, rhs, rtol=1e-12)

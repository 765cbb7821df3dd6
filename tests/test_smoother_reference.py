"""The V-cycle's smoothing block against the NumPy float64 reference.

`ops/host_reference.py` writes the block's schedule out independently of
the JAX operators: 3 damped-Jacobi passes over the boundary band, a
red/black Gauss-Seidel (or damped-Jacobi) interior sweep whose colour order
flips on the upstroke, and 3 more band passes (reference applyVCycle,
Source/HDK_GeometricMultigridPoissonSolver.cpp:445-513, 715-783).  Any
faster smoother has to match it the same way.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from geometricmultigridpressuresolver_tpu.config import SolverConfig
from geometricmultigridpressuresolver_tpu.ops import blas, domain, stencil
from geometricmultigridpressuresolver_tpu.ops import host_reference as ref
from geometricmultigridpressuresolver_tpu.solver import mg as mg_mod
from tests import helpers

# (label builder, fractional cut-cell weights)
DOMAINS = {
    "simple": (helpers.simple_domain, False),
    "complex": (helpers.sine_dirichlet_domain, True),
}


def _level(domain_name: str, ew_dtype):
    """A float64 fine level stored as the device path stores it (int8 band,
    optionally narrowed edge weights)."""
    builder, fractional = DOMAINS[domain_name]
    labels, weights, _ = helpers.expanded_domain(builder, 16, fractional=fractional)
    host = domain.build_level_coefficients(labels, weights, boundary_width=3)
    c = stencil.LevelCoeffs.from_host(host, jnp.float64)
    c = c._replace(band=c.band.astype(jnp.int8))
    if ew_dtype is not None:
        c = c._replace(
            ew0=c.ew0.astype(ew_dtype), ew1=c.ew1.astype(ew_dtype),
            ew2=c.ew2.astype(ew_dtype),
        )
    return labels, c


@pytest.mark.parametrize("domain_name", ["simple", "complex"])
@pytest.mark.parametrize("ew_dtype", [None, jnp.bfloat16], ids=["fp64", "bf16"])
@pytest.mark.parametrize("use_gs", [True, False], ids=["gs", "jacobi"])
@pytest.mark.parametrize("forward", [True, False], ids=["forward", "backward"])
def test_smoothing_block_matches_reference(forward, use_gs, ew_dtype, domain_name):
    labels, c = _level(domain_name, ew_dtype)
    config = SolverConfig(use_gauss_seidel=use_gs)
    b = helpers.random_solvable_field(labels, seed=3)
    x0 = helpers.random_solvable_field(labels, seed=4)

    got = mg_mod._smooth_level(jnp.asarray(x0), jnp.asarray(b), c, config, forward)
    want = ref.smooth_block(
        x0, b, ref.host_level(c), forward, use_gauss_seidel=use_gs
    )
    # Same arithmetic in another order: float64 rounding only.
    np.testing.assert_allclose(
        np.asarray(got), want, rtol=0, atol=1e-12 * np.abs(want).max()
    )
    # The block only touches solvable cells.
    assert not np.asarray(got)[~np.asarray(c.solvable)].any()


@pytest.mark.parametrize("forward", [True, False], ids=["forward", "backward"])
def test_emit_dot_matches_blas(forward):
    labels, c = _level("complex", jnp.bfloat16)
    config = SolverConfig()
    b = jnp.asarray(helpers.random_solvable_field(labels, seed=5))
    x0 = jnp.asarray(helpers.random_solvable_field(labels, seed=6))

    x, dot = mg_mod._smooth_level(x0, b, c, config, forward, emit_dot=True)
    plain = mg_mod._smooth_level(x0, b, c, config, forward)
    np.testing.assert_array_equal(np.asarray(x), np.asarray(plain))
    assert dot.dtype == jnp.float32
    assert float(dot) == pytest.approx(float(blas.dot(plain, b, c.solvable)), rel=1e-6)


@pytest.mark.parametrize("use_gs", [True, False], ids=["gs", "jacobi"])
def test_zero_start_vcycle_matches_explicit_zero_guess(use_gs):
    """use_initial_guess=False ignores x entirely: the cycle equals one
    started from an explicit zero guess."""
    labels, weights, mg_levels = helpers.expanded_domain(
        helpers.sine_dirichlet_domain, 16, fractional=True
    )
    config = SolverConfig(use_gauss_seidel=use_gs)
    hier = mg_mod.build_hierarchy(labels, weights, mg_levels, config)
    assert hier.num_levels > 1
    b = jnp.asarray(helpers.random_solvable_field(labels, seed=7))
    garbage = jnp.asarray(helpers.random_solvable_field(labels, seed=8))

    cold = mg_mod.v_cycle(hier, garbage, b, config, use_initial_guess=False)
    zero = mg_mod.v_cycle(hier, jnp.zeros_like(b), b, config, use_initial_guess=True)
    np.testing.assert_array_equal(np.asarray(cold), np.asarray(zero))

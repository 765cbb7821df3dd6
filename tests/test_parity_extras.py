"""Parity items: per-iteration residual history, the dx^2 scaling round
trip, setup granularity and config validation."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from geometricmultigridpressuresolver_tpu import diagnostics
from geometricmultigridpressuresolver_tpu.config import SolverConfig
from geometricmultigridpressuresolver_tpu.solver import mgpcg

from tests import helpers


def _small_problem(n=16, max_iterations=50, **kw):
    labels, weights, mg_levels = helpers.expanded_domain(
        helpers.simple_domain, n
    )
    config = SolverConfig(max_iterations=max_iterations, **kw)
    problem = mgpcg.build_problem(labels, weights, mg_levels, config)
    b = jnp.asarray(helpers.random_solvable_field(labels, seed=7))
    return problem, b, config


def test_residual_history_recorded():
    problem, b, config = _small_problem(record_residuals=True)
    result = mgpcg.solve(problem, b, config=config)
    hist = np.asarray(result.residual_history)
    assert hist.shape == (config.max_iterations + 1,)
    iters = int(result.iterations)
    assert iters >= 1
    # Entry 0 is the initial relative residual (= 1 for a zero guess);
    # entry `iters` matches the exit scalar; later entries stay NaN.
    assert hist[0] == pytest.approx(1.0, rel=1e-12)
    assert hist[iters] == pytest.approx(float(result.relative_residual), rel=1e-10)
    assert np.all(np.isnan(hist[iters + 1:]))
    # Monotone-ish decrease to below tolerance at exit.
    assert hist[iters] < config.tolerance


def test_residual_history_off_by_default():
    problem, b, config = _small_problem()
    result = mgpcg.solve(problem, b, config=config)
    assert result.residual_history is None


def test_dx_scaling_round_trip():
    base = dict(
        grid_size=16, use_complex_domain=False, use_random_guess=False,
        tolerance=1e-7, max_iterations=200,
    )
    plain = diagnostics.run_conjugate_gradient_test(**base)
    scaled = diagnostics.run_conjugate_gradient_test(dx=0.5, **base)
    # The relative residual and the oracle agreement are invariant to the
    # dx^2 round trip (reference HDK_TestGeometricMultigrid.cpp:792-794,
    # 1003-1009); the physical L-inf residual comes back in the same units.
    assert scaled["iterations"] == plain["iterations"]
    assert scaled["relative_l2"] == pytest.approx(
        plain["relative_l2"], rel=1e-6
    )
    assert scaled["l_infinity"] == pytest.approx(
        plain["l_infinity"], rel=1e-5
    )
    assert scaled["max_relative_difference_vs_oracle"] < 1e-5


def test_setup_fusion_granularities_agree():
    """config.setup_fusion="per-level" must build a bit-identical problem
    to the default fused one-program setup."""
    import jax

    from geometricmultigridpressuresolver_tpu.models import free_surface, sdf

    n = 16
    liquid_phi, velocity = sdf.splash_scene((n, n, n))
    weights = sdf.open_box_weights((n, n, n))
    fused = free_surface.build_setup(
        liquid_phi, weights, config=SolverConfig(setup_fusion="fused")
    )
    per_level = free_surface.build_setup(
        liquid_phi, weights, config=SolverConfig(setup_fusion="per-level")
    )
    fl, pl = jax.tree.leaves(fused.problem), jax.tree.leaves(per_level.problem)
    assert len(fl) == len(pl)
    for a, b in zip(fl, pl):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))

    ra = free_surface.project(fused, velocity)
    rb = free_surface.project(per_level, velocity)
    np.testing.assert_array_equal(np.asarray(ra.pressure), np.asarray(rb.pressure))


def test_project_donate_matches_and_consumes():
    """project(donate=True) recycles the velocity/warm-start buffers: same
    numbers as the non-donating call, and the donated inputs are deleted
    (VERDICT r2 #7 -- steady-state HBM diet for the frame loop)."""
    import jax
    import jax.numpy as jnp

    from geometricmultigridpressuresolver_tpu.models import free_surface, sdf

    n = 16
    liquid_phi, velocity = sdf.splash_scene((n, n, n))
    weights = sdf.open_box_weights((n, n, n))
    setup = free_surface.build_setup(liquid_phi, weights)
    velocity = tuple(jnp.asarray(v) for v in velocity)

    ref = free_surface.project(setup, velocity)
    vel2 = tuple(jnp.array(v, copy=True) for v in velocity)
    old_p = jnp.array(ref.pressure, copy=True)
    got = free_surface.project(setup, vel2, old_pressure=old_p, donate=True)
    # Warm-started result still converges and matches shapes; the VELOCITY
    # inputs are consumed while old_pressure is NOT (frame loops retain
    # the previous pressure they warm-start from -- simulate.run returns
    # every frame's pressure).
    assert bool(got.cg.converged)
    assert got.pressure.shape == ref.pressure.shape
    assert vel2[0].is_deleted() and vel2[1].is_deleted() and vel2[2].is_deleted()
    assert not old_p.is_deleted()
    # Against the same warm-started non-donating call: bit-identical.
    vel3 = tuple(jnp.array(v, copy=True) for v in velocity)
    ref2 = free_surface.project(
        setup, vel3, old_pressure=jnp.array(ref.pressure, copy=True)
    )
    np.testing.assert_array_equal(np.asarray(got.pressure), np.asarray(ref2.pressure))
    for a in range(3):
        np.testing.assert_array_equal(
            np.asarray(got.velocity[a]), np.asarray(ref2.velocity[a])
        )
    # The primary-fields diet: the setup holds no derived face fields.
    fields = free_surface.ProjectionSetup._fields
    for gone in ("grad_scale", "valid_faces"):
        assert gone not in fields
    assert jnp.asarray(setup.liquid_mask).dtype == jnp.bool_


def test_setup_fusion_auto_resolution(monkeypatch):
    """"auto" fuses the setup unless the fused program's compiled
    workspace exceeds the device's free memory; a device that reports no
    memory limit (the CPU backend) always fuses."""
    from geometricmultigridpressuresolver_tpu.models import free_surface, sdf
    from geometricmultigridpressuresolver_tpu.solver import mg as mg_mod

    labels, weights, mg_levels = helpers.expanded_domain(
        helpers.simple_domain, 16
    )
    auto = SolverConfig()
    assert auto.setup_fusion == "auto"
    args = (
        jnp.asarray(labels), tuple(jnp.asarray(w) for w in weights), mg_levels,
        auto.boundary_width, auto.mg_dtype_resolved, None, None, False, None,
    )
    fused = mg_mod._device_hierarchy
    assert mg_mod.device_free_bytes() is None
    assert mg_mod.setup_fusion_resolved(auto, fused, args) == "fused"
    monkeypatch.setattr(mg_mod, "device_free_bytes", lambda mesh=None: 1 << 40)
    assert mg_mod.setup_fusion_resolved(auto, fused, args) == "fused"
    monkeypatch.setattr(mg_mod, "device_free_bytes", lambda mesh=None: 1024)
    assert mg_mod.setup_fusion_resolved(auto, fused, args) == "per-level"
    # Explicit modes pass through untouched whatever the memory.
    for mode in ("fused", "per-level"):
        assert mg_mod.setup_fusion_resolved(
            SolverConfig(setup_fusion=mode), fused, args
        ) == mode
    # A build that resolves per-level is the same problem as the fused one.
    n = 16
    liquid_phi, _ = sdf.splash_scene((n, n, n))
    box = sdf.open_box_weights((n, n, n))
    got = free_surface.build_setup(liquid_phi, box, config=auto)
    monkeypatch.undo()
    ref = free_surface.build_setup(
        liquid_phi, box, config=SolverConfig(setup_fusion="fused")
    )
    for a, b in zip(jax.tree.leaves(ref.problem), jax.tree.leaves(got.problem)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_config_rejects_typo_modes():
    with pytest.raises(ValueError, match="setup_fusion"):
        SolverConfig(setup_fusion="per_level")
    with pytest.raises(ValueError, match="transfer_mode"):
        SolverConfig(transfer_mode="auto")
    with pytest.raises(ValueError, match="interior_smoother"):
        SolverConfig(interior_smoother="cheby")

"""Multi-frame simulation driver (the flipSplash-scene equivalent)."""

import jax.numpy as jnp
import numpy as np

from geometricmultigridpressuresolver_tpu.config import SolverConfig
from geometricmultigridpressuresolver_tpu.models import sdf, simulate


def test_advect_velocity_dt0_is_identity():
    # Regression for the half-cell shift: with dt=0 the backtrace lands
    # exactly on each face, so advection must return the field unchanged
    # (up to interpolation-free exactness).
    rng = np.random.default_rng(7)
    n = 12
    velocity = tuple(
        jnp.asarray(
            rng.standard_normal(tuple(n + (1 if a == ax else 0) for a in range(3)))
        )
        for ax in range(3)
    )
    out = simulate.advect_velocity(velocity, dt=0.0, dx=1.0 / n)
    for ax in range(3):
        np.testing.assert_allclose(
            np.asarray(out[ax]), np.asarray(velocity[ax]), atol=1e-12
        )


def test_advect_scalar_dt0_is_identity():
    rng = np.random.default_rng(8)
    n = 10
    field = jnp.asarray(rng.standard_normal((n, n, n)))
    velocity = tuple(
        jnp.asarray(
            rng.standard_normal(tuple(n + (1 if a == ax else 0) for a in range(3)))
        )
        for ax in range(3)
    )
    out = simulate.advect_scalar(field, velocity, dt=0.0, dx=1.0 / n)
    np.testing.assert_allclose(np.asarray(out), np.asarray(field), atol=1e-12)


def test_multiframe_splash_stays_divergence_free():
    n = 24
    config = SolverConfig(tolerance=1e-6, max_iterations=300)
    phi, velocity = sdf.splash_scene((n, n, n))
    weights = sdf.open_box_weights((n, n, n))

    frames = simulate.run(
        jnp.asarray(phi), tuple(jnp.asarray(v) for v in velocity), weights,
        num_frames=3, dt=1.0 / 60.0, config=config,
    )
    assert len(frames) == 3
    # Donation regression (code review r3): every retained frame's pressure
    # and velocity must remain readable -- run() returns them while also
    # feeding the pressure forward as the next warm start, so nothing the
    # caller sees may have been donated away.
    for fr in frames:
        for arr in (fr.pressure, *fr.velocity, fr.liquid_phi):
            np.asarray(arr)
    for fr in frames:
        assert fr.relative_residual <= 1e-6 * 1.01
        # Post-projection divergence audit: the projected field must be
        # (near-)divergence-free on liquid cells every frame.
        assert fr.max_divergence < 1e-4
    # The liquid must persist (advection isn't destroying the pool).
    assert bool((np.asarray(frames[-1].liquid_phi) <= 0).any())
    # Gravity + splash keep the solve nontrivial each frame.
    assert all(fr.iterations > 0 for fr in frames)


def test_checkpoint_resume_matches_straight_run(tmp_path):
    """save_state/load_state + run(start_frame=...) reproduces the
    uninterrupted run (the checkpoint/resume subsystem the reference lacks
    -- SURVEY.md section 5 names it as a gap a standalone framework fills)."""
    n = 24
    config = SolverConfig(tolerance=1e-8, max_iterations=300)
    phi, velocity = sdf.splash_scene((n, n, n))
    weights = sdf.open_box_weights((n, n, n))
    phi = jnp.asarray(phi)
    velocity = tuple(jnp.asarray(v) for v in velocity)

    straight = simulate.run(
        phi, velocity, weights, num_frames=3, dt=1.0 / 60.0, config=config
    )

    ckpt = tmp_path / "ckpt"
    simulate.run(
        phi, velocity, weights, num_frames=2, dt=1.0 / 60.0, config=config,
        checkpoint_dir=ckpt, checkpoint_every=2,
    )
    frame, phi2, vel2, pressure2 = simulate.load_state(ckpt)
    assert frame == 2 and pressure2 is not None
    resumed = simulate.run(
        jnp.asarray(phi2), tuple(jnp.asarray(v) for v in vel2), weights,
        num_frames=1, dt=1.0 / 60.0, config=config,
        start_frame=frame, old_pressure=jnp.asarray(pressure2),
    )
    # The serialization round trip is exact (fp64 tiled format), so the
    # resumed frame reproduces the straight run's frame 3 to solver noise.
    np.testing.assert_allclose(
        np.asarray(resumed[0].liquid_phi),
        np.asarray(straight[2].liquid_phi), atol=1e-12,
    )
    for a in range(3):
        np.testing.assert_allclose(
            np.asarray(resumed[0].velocity[a]),
            np.asarray(straight[2].velocity[a]), atol=1e-9,
        )


def test_run_fused_matches_per_frame_run():
    """run_fused (K frames per compiled program, on-device coarse assembly)
    must reproduce run()'s per-frame path: same iteration counts, same
    final fields to solver noise.  Exercises the traced frame body end to
    end -- including mg._coarse_system_traced against the host scipy
    assembly."""
    n = 24
    config = SolverConfig(tolerance=1e-8, max_iterations=300)
    phi, velocity = sdf.splash_scene((n, n, n))
    weights = sdf.open_box_weights((n, n, n))
    phi = jnp.asarray(phi)
    velocity = tuple(jnp.asarray(v) for v in velocity)

    frames = simulate.run(
        phi, velocity, weights, num_frames=4, dt=1.0 / 60.0, config=config
    )
    f_phi, f_vel, f_pressure, stats = simulate.run_fused(
        phi, velocity, weights, num_frames=4, dt=1.0 / 60.0, config=config,
        chunk=2,
    )

    assert list(stats["iterations"]) == [fr.iterations for fr in frames]
    assert all(stats["relative_residual"] <= 1e-8 * 1.01)
    assert all(stats["max_divergence"] < 1e-6)
    np.testing.assert_allclose(
        np.asarray(f_phi), np.asarray(frames[-1].liquid_phi), atol=1e-12
    )
    for a in range(3):
        np.testing.assert_allclose(
            np.asarray(f_vel[a]), np.asarray(frames[-1].velocity[a]),
            atol=1e-9,
        )
    np.testing.assert_allclose(
        np.asarray(f_pressure), np.asarray(frames[-1].pressure), atol=1e-9
    )


def test_run_fused_geometry_fallback():
    """A chunk whose liquid outgrows the frozen window must be detected and
    recomputed through the per-frame path (correctness never rests on the
    frozen-geometry guess).  Forced here with a fast-falling drop scene and
    a long chunk."""
    n = 20
    config = SolverConfig(tolerance=1e-7, max_iterations=300)
    # A small drop high above a shallow pool: several frames of free fall
    # move the active bbox well outside the frame-0 window.
    points, dx = sdf.cell_centers((n, n, n))
    phi = np.minimum(
        sdf.pool_sdf(points, 0.15),
        sdf.sphere_sdf(points, (0.5, 0.8, 0.5), 0.12),
    )
    velocity = []
    for ax in range(3):
        shape = tuple(n + (1 if a == ax else 0) for a in range(3))
        v = np.zeros(shape)
        if ax == 1:
            v -= 2.0  # uniform fast fall
        velocity.append(v)

    f_phi, f_vel, f_pressure, stats = simulate.run_fused(
        jnp.asarray(phi), tuple(jnp.asarray(v) for v in velocity), 
        sdf.open_box_weights((n, n, n)),
        num_frames=6, dt=1.0 / 30.0, gravity=-9.8, config=config, chunk=6,
    )
    frames = simulate.run(
        jnp.asarray(phi), tuple(jnp.asarray(v) for v in velocity),
        sdf.open_box_weights((n, n, n)),
        num_frames=6, dt=1.0 / 30.0, gravity=-9.8, config=config,
    )
    np.testing.assert_allclose(
        np.asarray(f_phi), np.asarray(frames[-1].liquid_phi), atol=1e-12
    )
    np.testing.assert_allclose(
        np.asarray(f_pressure), np.asarray(frames[-1].pressure), atol=1e-8
    )


def test_upwind_advection_dt0_and_stability():
    """Upwind stencil advection: dt=0 is the identity; a CFL>1 step with
    substeps stays bounded (each substep is CFL<=1 and monotone, so the
    field stays within its initial range)."""
    rng = np.random.default_rng(9)
    n = 12
    field = jnp.asarray(rng.standard_normal((n, n, n)))
    # Bounded |v| <= 1 so the 3-axis CFL sum stays under 1 per substep
    # (monotonicity needs sum_a |v_a| dt_sub / dx <= 1).
    velocity = tuple(
        jnp.asarray(rng.uniform(-1.0, 1.0, size=(
            tuple(n + (1 if a == ax else 0) for a in range(3))
        )))
        for ax in range(3)
    )
    out0 = simulate.advect_scalar_upwind(field, velocity, 0.0, 1.0 / n)
    np.testing.assert_allclose(np.asarray(out0), np.asarray(field), atol=1e-12)
    v0 = simulate.advect_velocity_upwind(velocity, 0.0, 1.0 / n)
    for ax in range(3):
        np.testing.assert_allclose(
            np.asarray(v0[ax]), np.asarray(velocity[ax]), atol=1e-12
        )

    # dt.|v|/dx up to ~4/3 with substeps=4: monotone, so no new extrema.
    out = simulate.advect_scalar_upwind(field, velocity, 1.0 / 18.0, 1.0 / n,
                                        substeps=4)
    assert float(jnp.max(out)) <= float(jnp.max(field)) + 1e-9
    assert float(jnp.min(out)) >= float(jnp.min(field)) - 1e-9


def test_upwind_matches_semi_lagrangian_uniform_flow():
    """Under uniform velocity both schemes transport a smooth field the
    same way to first order: one small-CFL step agrees to O(dx^2)-level
    tolerance on a smooth sine field."""
    n = 32
    pts, dx = sdf.cell_centers((n, n, n))
    field = jnp.asarray(np.sin(2 * np.pi * pts[0]) * np.cos(2 * np.pi * pts[1]))
    velocity = []
    for ax in range(3):
        shape = tuple(n + (1 if a == ax else 0) for a in range(3))
        velocity.append(jnp.full(shape, 0.5 if ax == 0 else 0.25))
    dt = 0.2 * dx  # CFL 0.1
    sl = simulate.advect_scalar(field, tuple(velocity), dt, dx)
    uw = simulate.advect_scalar_upwind(field, tuple(velocity), dt, dx,
                                       substeps=1)
    # Interior only (edge clamping differs at the inflow boundary).
    s = (slice(2, -2),) * 3
    diff = float(jnp.max(jnp.abs(sl[s] - uw[s])))
    assert diff < 5e-3, diff


def test_run_fused_matches_run_upwind():
    """run_fused == run with the gather-free upwind advection scheme."""
    n = 24
    config = SolverConfig(tolerance=1e-8, max_iterations=300,
                          advection="upwind")
    phi, velocity = sdf.splash_scene((n, n, n))
    weights = sdf.open_box_weights((n, n, n))
    phi = jnp.asarray(phi)
    velocity = tuple(jnp.asarray(v) for v in velocity)

    frames = simulate.run(
        phi, velocity, weights, num_frames=3, dt=1.0 / 60.0, config=config
    )
    f_phi, f_vel, f_pressure, stats = simulate.run_fused(
        phi, velocity, weights, num_frames=3, dt=1.0 / 60.0, config=config,
        chunk=3,
    )
    assert list(stats["iterations"]) == [fr.iterations for fr in frames]
    np.testing.assert_allclose(
        np.asarray(f_phi), np.asarray(frames[-1].liquid_phi), atol=1e-12
    )
    np.testing.assert_allclose(
        np.asarray(f_pressure), np.asarray(frames[-1].pressure), atol=1e-9
    )
    assert all(stats["max_divergence"] < 1e-6)

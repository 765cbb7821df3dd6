"""Sharded (multi-chip) SETUP tests: `build_setup(mesh=...)`.

Round-5 headline (VERDICT r4 #1): the hierarchy CONSTRUCTION — not just the
solve — must run SPMD over a device mesh, so configurations one chip cannot
even build (512^3: the fine-level coefficient build alone exhausts one
chip's HBM) become constructible.  The reference's hierarchy constructor is
single-address-space (Source/HDK_GeometricMultigridPoissonSolver.cpp:238-412
over shared-memory tiles); multi-chip construction is this build's own
scale axis (SURVEY.md section 2.10).

Acceptance here (the verdict's "done" terms):
  (a) the mesh-built setup is BIT-IDENTICAL to the single-device build at
      64^3 — every array of the PoissonProblem and the base fields;
  (b) the fine-level arrays are genuinely block-partitioned over all 8
      virtual devices (not replicated);
  (c) a projection through the mesh-built setup (static-window embed /
      extract path) matches the single-device projection.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from geometricmultigridpressuresolver_tpu.config import SolverConfig
from geometricmultigridpressuresolver_tpu.models import free_surface, sdf
from geometricmultigridpressuresolver_tpu.parallel import make_mesh


@pytest.fixture(scope="module")
def mesh8():
    assert len(jax.devices()) >= 8, "conftest must provide 8 virtual devices"
    return make_mesh(8)


def _leaves(tree):
    return jax.tree_util.tree_leaves(tree)


def _assert_bit_identical(ref, got, what):
    ref_l, got_l = _leaves(ref), _leaves(got)
    assert len(ref_l) == len(got_l), what
    for i, (a, b) in enumerate(zip(ref_l, got_l)):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype, (what, i, a.dtype, b.dtype)
        assert a.shape == b.shape, (what, i, a.shape, b.shape)
        assert np.array_equal(a, b, equal_nan=True), (
            f"{what} leaf {i}: max abs diff "
            f"{np.max(np.abs(a.astype(np.float64) - b.astype(np.float64)))}"
        )


@pytest.fixture(scope="module")
def built_64(mesh8):
    """One 64^3 splash scene built both ways (module-scoped: the fused
    64^3 hierarchy build is the expensive part of this file)."""
    n = 64
    liquid_phi, velocity = sdf.splash_scene((n, n, n))
    weights = sdf.open_box_weights((n, n, n))
    config = SolverConfig(tolerance=1e-7)
    ref = free_surface.build_setup(liquid_phi, weights, config=config)
    got = free_surface.build_setup(liquid_phi, weights, config=config,
                                   mesh=mesh8)
    return config, velocity, ref, got


def test_sharded_setup_bit_identical(built_64):
    _, _, ref, got = built_64

    # Static geometry identical; the sharded build additionally pins the
    # window origin statically.
    assert got.expanded_shape == ref.expanded_shape
    assert got.base_pads == ref.base_pads
    assert got.padding == ref.padding
    assert got.mg_levels == ref.mg_levels
    assert ref.window_start_static is None
    assert got.window_start_static == tuple(np.asarray(ref.window_start))

    _assert_bit_identical(ref.problem, got.problem, "PoissonProblem")
    _assert_bit_identical(ref.material, got.material, "material")
    _assert_bit_identical(ref.weights, got.weights, "weights")
    _assert_bit_identical(ref.liquid_phi, got.liquid_phi, "liquid_phi")
    assert np.array_equal(
        np.asarray(ref.window_start), np.asarray(got.window_start)
    )


def test_sharded_setup_fine_level_is_partitioned(built_64, mesh8):
    """(b): no device holds the full fine grid — the fine-level arrays of
    the mesh-built setup live block-partitioned across all 8 devices."""
    _, _, _, got = built_64
    fine = got.problem.fine
    for name, arr in (
        ("solvable", fine.solvable),
        ("inv_diag", fine.inv_diag),
        ("ew0", fine.ew0),
    ):
        assert len(arr.sharding.device_set) == 8, name
        assert not arr.sharding.is_fully_replicated, name
        # Each device's addressable shard is 1/8 of the grid.
        shard = arr.addressable_shards[0]
        local = int(np.prod(shard.data.shape))
        total = int(np.prod(arr.shape))
        assert local * 8 == total, (name, shard.data.shape, arr.shape)


def test_sharded_setup_projection_matches(built_64, mesh8):
    """(c): the per-frame projection through the mesh-built setup (the
    fully-static embed/extract window path) equals the single-device run."""
    from geometricmultigridpressuresolver_tpu.parallel import shard_velocity

    config, velocity, ref, got = built_64
    base = free_surface.project(ref, velocity, config=config)
    v_sharded = shard_velocity(velocity, mesh8)
    dist = free_surface.project(got, v_sharded, config=config)

    assert int(dist.cg.iterations) == int(base.cg.iterations)
    np.testing.assert_allclose(
        np.asarray(dist.pressure), np.asarray(base.pressure), rtol=0,
        atol=1e-11,
    )
    for a in range(3):
        np.testing.assert_allclose(
            np.asarray(dist.velocity[a]), np.asarray(base.velocity[a]),
            rtol=0, atol=1e-11,
        )


def test_sharded_setup_per_level_path(mesh8):
    """The per-level setup granularity (config.setup_fusion="per-level",
    the large-window fallback that 512^3-class scenes resolve to) builds
    the same problem on the mesh as the fused single-device program."""
    n = 32
    liquid_phi, _ = sdf.splash_scene((n, n, n))
    weights = sdf.open_box_weights((n, n, n))
    ref = free_surface.build_setup(
        liquid_phi, weights, config=SolverConfig(setup_fusion="fused")
    )
    got = free_surface.build_setup(
        liquid_phi, weights, config=SolverConfig(setup_fusion="per-level"),
        mesh=mesh8,
    )
    assert got.expanded_shape == ref.expanded_shape
    _assert_bit_identical(ref.problem, got.problem, "PoissonProblem")


def test_sharded_setup_auto_threshold_scales_with_mesh(mesh8, monkeypatch):
    """On a mesh, setup_fusion="auto" weighs the fused program's PER-DEVICE
    workspace: with free memory between the one-device and the 8-device
    workspace, the build fuses on the mesh and not on one device."""
    from geometricmultigridpressuresolver_tpu.parallel import shard_grid
    from geometricmultigridpressuresolver_tpu.solver import mg as mg_mod
    from tests import helpers

    labels, weights, mg_levels = helpers.expanded_domain(helpers.simple_domain, 32)
    config = SolverConfig(setup_fusion="auto")
    fused = mg_mod._device_hierarchy

    def args(mesh):
        place = (lambda a: a) if mesh is None else (lambda a: shard_grid(a, mesh))
        return (
            place(jnp.asarray(labels)),
            tuple(place(jnp.asarray(w)) for w in weights),
            mg_levels, config.boundary_width, config.mg_dtype_resolved,
            None, None, False, mesh,
        )

    def workspace(mesh):
        mem = fused.lower(*args(mesh)).compile().memory_analysis()
        return (mem.temp_size_in_bytes + mem.output_size_in_bytes
                - mem.alias_size_in_bytes)

    one, eight = workspace(None), workspace(mesh8)
    assert eight < one
    free = (one + eight) // 2
    monkeypatch.setattr(mg_mod, "device_free_bytes", lambda mesh=None: free)
    assert mg_mod.setup_fusion_resolved(config, fused, args(None)) == "per-level"
    assert mg_mod.setup_fusion_resolved(config, fused, args(mesh8), mesh8) == "fused"

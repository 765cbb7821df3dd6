"""Free-surface pressure projection pipeline (the flagship model).

JAX equivalent of the reference's flagship node
`HDK_GeometricFreeSurfacePressureSolver` (solveGasSubclass,
Source/HDK_GeometricFreeSurfacePressureSolver.cpp:113-714), minus Houdini:
SDF/velocity arrays in, pressure/projected velocity out.

Pipeline (reference call stack SURVEY.md section 3.1):
  1. material labels from liquid/solid SDFs + cut-cell weights
     (buildMaterialCellLabels, Source/HDK_Utilities.cpp:86-148);
  2. valid-face classification (classifyValidFaces, HDK_Utilities.h:138-195);
  3. MG domain labels (LIQUID->INTERIOR, AIR->DIRICHLET, SOLID->EXTERIOR)
     and boundary weights = cut-cell weight / clamped ghost-fluid theta on
     liquid-air faces (cpp:746-865);
  4. padded power-of-two domain expansion + BOUNDARY relabeling (L2 ops);
  5. RHS = negative cut-cell divergence with solid-velocity terms
     (buildRHS, cpp:867-943);
  6. warm start from the previous pressure (applyOldPressure, cpp:945-997);
  7. MGPCG solve (cpp:426-629);
  8. pressure writeback, velocity -= grad(p) (with theta at liquid-air
     faces) on valid faces (cpp:999-1131);
  9. post-projection divergence audit (cpp:1133-1208).

Setup (label/weight construction) runs on the host in numpy once per frame;
the solve and the per-frame field updates are jittable JAX.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from geometricmultigridpressuresolver_tpu.config import SolverConfig
from geometricmultigridpressuresolver_tpu.grids import CellLabel, MaterialLabel
from geometricmultigridpressuresolver_tpu.ops import domain as domain_ops
from geometricmultigridpressuresolver_tpu.solver import cg as cg_mod
from geometricmultigridpressuresolver_tpu.solver import mgpcg

SOLID = int(MaterialLabel.SOLID)
LIQUID = int(MaterialLabel.LIQUID)
AIR = int(MaterialLabel.AIR)


def _lo_hi(arr, axis):
    lo = [slice(None)] * 3
    hi = [slice(None)] * 3
    lo[axis] = slice(0, -1)
    hi[axis] = slice(1, None)
    return arr[tuple(lo)], arr[tuple(hi)]


def _face_lo(w, axis):
    sl = [slice(None)] * 3
    sl[axis] = slice(0, -1)
    return w[tuple(sl)]


def _face_hi(w, axis):
    sl = [slice(None)] * 3
    sl[axis] = slice(1, None)
    return w[tuple(sl)]


def ghost_fluid_theta(phi0, phi1):
    """Fraction of the face segment inside the liquid.

    Reference computeGhostFluidWeight (Source/HDK_Utilities.h:25-42).
    """
    xp = jnp if isinstance(phi0, jax.Array) else np
    denom01 = phi0 - phi1
    denom10 = phi1 - phi0
    safe01 = xp.where(denom01 == 0, 1.0, denom01)
    safe10 = xp.where(denom10 == 0, 1.0, denom10)
    theta = xp.where(
        phi0 < 0,
        xp.where(phi1 < 0, 1.0, phi0 / safe01),
        xp.where(phi1 < 0, phi1 / safe10, 0.0),
    )
    return theta


def _xp(arr):
    return jnp if isinstance(arr, (jax.Array, jax.core.Tracer)) else np


def _pad_axis(arr, axis, before, after, fill):
    xp = _xp(arr)
    pad = [(0, 0)] * arr.ndim
    pad[axis] = (before, after)
    return xp.pad(arr, pad, constant_values=fill)


def build_material_labels(
    liquid_phi,
    cut_cell_weights: Sequence,
    solid_phi=None,
):
    """Material labels: SOLID unless an incident face is open; then LIQUID if
    the cell passes isCellLiquid, else AIR.

    Reference buildMaterialCellLabels + isCellLiquid
    (Source/HDK_Utilities.cpp:86-148, 5-46).  Functional: runs on numpy or
    on device under jit.
    """
    xp = _xp(liquid_phi)
    shape = liquid_phi.shape

    has_open = xp.zeros(shape, dtype=bool)
    for axis in range(3):
        w = cut_cell_weights[axis]
        has_open = has_open | (_face_lo(w, axis) > 0) | (_face_hi(w, axis) > 0)

    liquid = liquid_phi <= 0.0

    if solid_phi is not None:
        # A cell whose center is inside the solid still counts as liquid if
        # an open face connects it to a liquid cell (sub-grid-resolution
        # solids; reference isCellLiquid steps 1-3).
        in_solid = solid_phi >= 0.0
        extra = xp.zeros(shape, dtype=bool)
        for axis in range(3):
            w = cut_cell_weights[axis]
            interior = [slice(None)] * 3
            interior[axis] = slice(1, -1)
            open_face = w[tuple(interior)] > 0
            phi_lo, phi_hi = _lo_hi(liquid_phi, axis)
            # open face to a liquid neighbor, padded back to cell shape
            extra = extra | _pad_axis(open_face & (phi_hi <= 0), axis, 0, 1, False)
            extra = extra | _pad_axis(open_face & (phi_lo <= 0), axis, 1, 0, False)
        liquid = liquid | (in_solid & extra)

    return xp.where(
        has_open, xp.where(liquid, LIQUID, AIR), SOLID
    ).astype(np.int8)


def classify_valid_faces(material, cut_cell_weights: Sequence) -> list:
    """Face is VALID iff its weight > 0, both cells are in bounds, and at
    least one adjacent cell is LIQUID.

    Reference classifyValidFaces (Source/HDK_Utilities.h:138-195).
    """
    valid = []
    for axis in range(3):
        w = cut_cell_weights[axis]
        interior = [slice(None)] * 3
        interior[axis] = slice(1, -1)
        lo_lbl, hi_lbl = _lo_hi(material, axis)
        v_int = (w[tuple(interior)] > 0) & ((lo_lbl == LIQUID) | (hi_lbl == LIQUID))
        valid.append(_pad_axis(v_int, axis, 1, 1, False))
    return valid


class ProjectionSetup(NamedTuple):
    """Per-frame solver data: device arrays + static window geometry.

    The multigrid domain is a WINDOW into the (exterior-padded) base grid:
    ``expanded[j] = padded_base[window_start + j]``.  The window's start is
    a traced device scalar vector while every shape is static, so frames
    whose liquid moves (different bounding boxes) reuse the same compiled
    programs as long as the window SHAPE is reused (see `build_setup`'s
    `reuse_from`).

    Storage diet (single-device ceiling): only the PRIMARY
    fields persist -- material labels (int8), cut-cell weights, and the
    liquid SDF.  The derived per-frame fields (liquid mask, valid faces,
    ghost-fluid gradient scales) are recomputed inside the fused per-frame
    program from these (`face_projection_fields`) -- a few elementwise
    passes per frame instead of ~1.4 GB of resident device memory at 448^3
    (3 fp32 face arrays + 4 bool/byte masks).
    """

    problem: mgpcg.PoissonProblem
    material: jax.Array                  # int8 (base shape) material labels
    weights: tuple[jax.Array, ...]       # cut-cell weights, base shape
    liquid_phi: jax.Array                # liquid SDF, base shape (solve dtype)
    window_start: jax.Array              # int32[3], window origin (padded base coords)
    expanded_shape: tuple[int, int, int]
    base_pads: tuple[tuple[int, int], ...]  # static per-axis base padding
    padding: int                         # multigrid exterior padding
    mg_levels: int
    # Static window origin (sharded setups only; None on the single-device
    # path, where the origin stays a traced device scalar so moving-liquid
    # frames reuse one compiled program).  When set, the per-frame
    # embed/extract use fully-static slices that partition over the mesh
    # without resharding.  Appended last with a default so positional
    # consumers of the public NamedTuple keep their meaning.
    window_start_static: tuple[int, int, int] | None = None

    @property
    def liquid_mask(self) -> jax.Array:
        """bool base-shape liquid mask, derived from the material labels
        (kept as a property for the round-1/2 field's many callers)."""
        return self.material == LIQUID


def _face_inv_theta(material, liquid_phi, axis: int, theta_clamp: float, dtype):
    """Face-shaped 1/theta on liquid-air faces (1 elsewhere), ghost-fluid
    clamped (Source/HDK_GeometricFreeSurfacePressureSolver.cpp:795-865)."""
    xp = _xp(material)
    lbl_lo, lbl_hi = _lo_hi(material, axis)
    phi_lo, phi_hi = _lo_hi(liquid_phi, axis)
    liquid_air = ((lbl_lo == LIQUID) & (lbl_hi == AIR)) | (
        (lbl_lo == AIR) & (lbl_hi == LIQUID)
    )
    theta = xp.clip(ghost_fluid_theta(phi_lo, phi_hi), theta_clamp, 1.0).astype(dtype)
    return _pad_axis(
        xp.where(liquid_air, 1.0 / theta, xp.ones_like(theta)), axis, 1, 1, 1.0
    )


def face_projection_fields(
    material, liquid_phi, cut_cell_weights, theta_clamp: float, dtype
):
    """(valid_faces, grad_scale) derived from the primary fields.

    grad_scale is 1/theta on valid liquid-air faces, 1 elsewhere (reference
    applyPressureGradient, cpp:1049-1131).  Recomputed per frame inside the
    fused projection program instead of stored in ProjectionSetup -- a few
    elementwise passes versus ~1.4 GB resident at 448^3.
    """
    xp = _xp(material)
    valid = classify_valid_faces(material, cut_cell_weights)
    grad_scale = []
    for axis in range(3):
        inv_theta = _face_inv_theta(material, liquid_phi, axis, theta_clamp, dtype)
        grad_scale.append(
            xp.where(valid[axis], inv_theta, xp.ones_like(inv_theta))
        )
    return valid, grad_scale


def _setup_base_fields(
    liquid_phi,
    cut_cell_weights,
    solid_phi,
    theta_clamp: float,
    dtype,
    dirichlet_band: int,
    want_compact: bool = True,
    want_derived: bool = True,
):
    """Steps 1-3 array work on the base grid: labels, valid faces, MG
    weights, far-field Dirichlet trimming, occupancy projections.

    Functional, so it runs under jit on the device (production) or eagerly
    on host numpy arrays (tests/oracles use the pieces directly).

    `want_derived=False` (the production build_setup path) drops the
    valid/grad_scale OUTPUTS -- they are recomputed per frame inside the
    fused projection program, so emitting them from the setup program
    would only write ~1.4 GB of soon-discarded device memory at 448^3.  The
    assembled baseline keeps them (it consumes them directly).
    """
    xp = _xp(liquid_phi)
    material = build_material_labels(liquid_phi, cut_cell_weights, solid_phi)
    valid = classify_valid_faces(material, cut_cell_weights)

    # Material -> MG labels on the base grid.
    mg_labels = xp.where(
        material == LIQUID,
        int(CellLabel.INTERIOR),
        xp.where(material == AIR, int(CellLabel.DIRICHLET), int(CellLabel.EXTERIOR)),
    ).astype(np.int8)

    # Boundary weights: cut-cell weight on valid faces, divided by the
    # clamped ghost-fluid theta on liquid-air faces
    # (Source/HDK_GeometricFreeSurfacePressureSolver.cpp:795-865).
    mg_weights = []
    grad_scale = []
    for axis in range(3):
        w = cut_cell_weights[axis].astype(dtype)
        v = valid[axis]
        inv_theta = _face_inv_theta(material, liquid_phi, axis, theta_clamp, dtype)
        bw = xp.where(v, w * inv_theta, xp.zeros_like(w))
        # Gradient scale: 1/theta on valid liquid-air faces, 1 elsewhere
        # (reference applyPressureGradient, cpp:1049-1131).
        scale = xp.where(v, inv_theta, xp.ones_like(inv_theta))
        mg_weights.append(bw)
        grad_scale.append(scale)
    if not want_derived:
        valid = grad_scale = None

    if not want_compact:
        # Callers on the classic/raw-grid path (assembled baseline) skip
        # the trimming and occupancy reductions entirely.
        return material, valid, grad_scale, mg_labels, None, mg_weights, None

    # Far-field Dirichlet trimming: identical linear system, much smaller
    # active bounding box (see domain.trim_far_dirichlet).
    trimmed = domain_ops.trim_far_dirichlet(mg_labels, dirichlet_band)
    non_ext = trimmed != int(CellLabel.EXTERIOR)
    projections = (
        non_ext.any(axis=(1, 2)),
        non_ext.any(axis=(0, 2)),
        non_ext.any(axis=(0, 1)),
        non_ext.sum(dtype=np.int32),
    )
    return material, valid, grad_scale, mg_labels, trimmed, mg_weights, projections


def _window_static(arr, start, base_pads, out_shape, fill):
    """out[j] = base[start - pad_lo + j] with `fill` outside the base grid.

    The fully-STATIC form of the window slice (start / pads / shapes all
    Python ints), used on the sharded-setup path: a dynamic_slice with
    traced start on a block-partitioned operand forces the GSPMD
    partitioner to reshard the whole padded base (it cannot prove the
    offsets respect shard boundaries), while a static pad+slice partitions
    exactly.  One-shot large builds trade the per-window recompile for it.
    """
    xp = _xp(arr)
    sl, pads = [], []
    for a in range(3):
        off = int(start[a]) - base_pads[a][0]
        lo_fill = max(0, -off)
        b_lo = min(max(0, off), arr.shape[a])
        b_hi = max(b_lo, min(arr.shape[a], off + out_shape[a]))
        hi_fill = out_shape[a] - lo_fill - (b_hi - b_lo)
        sl.append(slice(b_lo, b_hi))
        pads.append((lo_fill, hi_fill))
    return xp.pad(arr[tuple(sl)], pads, constant_values=fill)


def _expand_window_fields(mg_labels, mg_weights, start, base_pads, expanded_shape,
                          static_start=None, mesh=None):
    """Step 4: slice the multigrid window out of the exterior-padded base.

    `start` is TRACED (int32[3]); only shapes are static, so consecutive
    frames with moving liquid share one compiled program.  Covers both the
    compact bbox window and the reference-style full-grid expansion (where
    the window is the whole padded grid, Source/HDK_GeometricMultigridOperators.h:1328-1456).

    `static_start` (sharded setup) switches to the fully-static slice so the
    expansion partitions over `mesh` without resharding (see _window_static);
    `start` is then ignored.
    """
    from geometricmultigridpressuresolver_tpu.grids import face_shape

    xp = _xp(mg_labels)
    base = xp.where(mg_labels == int(CellLabel.BOUNDARY), int(CellLabel.INTERIOR),
                    mg_labels).astype(np.int8)
    if static_start is not None:
        labels = _window_static(
            base, static_start, base_pads, expanded_shape,
            int(CellLabel.EXTERIOR),
        )
        exp_weights = [
            _window_static(
                mg_weights[axis], static_start, base_pads,
                face_shape(expanded_shape, axis), 0.0,
            )
            for axis in range(3)
        ]
    else:
        lbl_p = xp.pad(base, base_pads, constant_values=int(CellLabel.EXTERIOR))
        idx = (start[0], start[1], start[2])
        labels = jax.lax.dynamic_slice(lbl_p, idx, expanded_shape)
        exp_weights = []
        for axis in range(3):
            w_p = xp.pad(mg_weights[axis], base_pads, constant_values=0.0)
            exp_weights.append(
                jax.lax.dynamic_slice(w_p, idx, face_shape(expanded_shape, axis))
            )
    if mesh is not None:
        from geometricmultigridpressuresolver_tpu.parallel.mesh import constrain_grid

        labels = constrain_grid(labels, mesh)
        exp_weights = [constrain_grid(w, mesh) for w in exp_weights]
    labels = domain_ops.set_boundary_labels(labels, exp_weights)
    return labels, exp_weights


_setup_base_jit = None
_expand_window_jit = None


def _jitted():
    global _setup_base_jit, _expand_window_jit
    if _setup_base_jit is None:
        _setup_base_jit = jax.jit(
            _setup_base_fields,
            static_argnames=(
                "theta_clamp", "dtype", "dirichlet_band", "want_compact",
                "want_derived",
            ),
        )
        _expand_window_jit = jax.jit(
            _expand_window_fields,
            static_argnames=("base_pads", "expanded_shape", "static_start", "mesh"),
        )
    return _setup_base_jit, _expand_window_jit


@functools.partial(
    jax.jit,
    static_argnames=(
        "base_pads", "expanded_shape", "target_levels", "boundary_width",
        "mg_dtype", "ew_dtype", "fine_dtype", "fine_full", "static_start",
        "mesh",
    ),
)
def _expand_build_device(
    window_labels,
    mg_weights,
    window_start,
    base_pads,
    expanded_shape,
    target_levels: int,
    boundary_width: int,
    mg_dtype,
    ew_dtype,
    fine_dtype,
    fine_full: bool,
    static_start=None,
    mesh=None,
):
    """Window expansion + EVERY hierarchy level + the fine CG operator as
    ONE compiled program.

    This program plus _setup_base_fields plus the coarse densify/invert
    makes setup three compiles and three dispatches in all.

    With `mesh` (sharded setup) the whole program runs SPMD over
    block-partitioned inputs; `static_start` replaces the traced window
    origin so the expansion slice partitions statically.
    """
    from geometricmultigridpressuresolver_tpu.solver import mg as mg_mod

    labels, exp_weights = _expand_window_fields(
        window_labels, mg_weights, window_start, base_pads, expanded_shape,
        static_start=static_start, mesh=mesh,
    )
    levels, flags, label_levels, fine = mg_mod._build_levels_traced(
        labels, tuple(exp_weights), target_levels, boundary_width,
        mg_dtype, ew_dtype, fine_dtype, fine_full, mesh=mesh,
    )
    return labels, exp_weights, levels, flags, label_levels, fine


def validate_fields(
    liquid_phi, cut_cell_weights, velocity=None, solid_phi=None
) -> None:
    """Shape validation with the reference node's error semantics.

    HDK_GeometricFreeSurfacePressureSolver::solveGasSubclass rejects
    missing/misaligned fields with explicit node errors
    (Source/HDK_GeometricFreeSurfacePressureSolver.cpp:125-250): velocity
    must be face-sampled, cut-cell weights must align with velocity, the
    surface must align with the cell grid.
    """
    shape = np.shape(liquid_phi)  # np.shape: duck-typed (lists included)
    if len(shape) != 3:
        raise ValueError(f"surface field must be a 3-D cell grid, got {shape}")
    if len(cut_cell_weights) != 3:
        raise ValueError("cut-cell weights must have one array per axis")
    from geometricmultigridpressuresolver_tpu.grids import face_shape

    for axis in range(3):
        want = face_shape(shape, axis)
        got = np.shape(cut_cell_weights[axis])
        if got != want:
            raise ValueError(
                "cut-cell weights must align with the velocity field: axis "
                f"{axis} expected {want}, got {got}"
            )
    if velocity is not None:
        for axis in range(3):
            want = face_shape(shape, axis)
            got = np.shape(velocity[axis])
            if got != want:
                raise ValueError(
                    f"velocity must be face sampled: axis {axis} expected "
                    f"{want}, got {got}"
                )
    if solid_phi is not None and np.shape(solid_phi) != shape:
        raise ValueError(
            "collision surface must align with the liquid surface: expected "
            f"{shape}, got {np.shape(solid_phi)}"
        )


def validate_density(density) -> float | None:
    """Constant-density validation, mirroring the reference node.

    The reference loads a density field, requires it to be constant, and
    rejects variable density ("Variable density is not currently
    supported", Source/HDK_GeometricFreeSurfacePressureSolver.cpp:245-250);
    the constant value itself does not enter the solve (the computed
    pressure is p / rho).  Accepts None, a scalar, or a constant array.
    """
    if density is None:
        return None
    arr = np.asarray(density)
    if arr.size > 1 and not np.all(arr == arr.flat[0]):
        raise ValueError("Variable density is not currently supported")
    return float(arr.flat[0])


def build_setup(
    liquid_phi,
    cut_cell_weights: Sequence,
    solid_phi=None,
    config: SolverConfig | None = None,
    validate: bool = False,
    density=None,
    reuse_from: ProjectionSetup | None = None,
    mesh=None,
) -> ProjectionSetup:
    """Steps 1-4: labels, valid faces, MG domain + weights, expansion.

    All heavy array work runs on the device (the grids may be 512^3), then
    the hierarchy is built level by
    level on the device as well.  With `config.compact_domain` (default) the
    multigrid domain is the aligned bounding box of the liquid plus a
    narrow Dirichlet band -- the same linear system as the reference's
    full-grid power-of-two expansion at a fraction of the cell count.

    `mesh` (a jax.sharding.Mesh) runs the whole setup SPMD over the mesh:
    the base fields are block-partitioned first, the expansion slice is
    static (the window origin becomes `window_start_static`), every
    hierarchy level stays sharding-constrained, and the finished setup is
    placed per parallel.sharding.shard_setup.  No device ever materializes
    a full fine-level grid, so a grid too large for one device's memory
    builds on a mesh.  The reference's hierarchy constructor is
    single-address-space
    (Source/HDK_GeometricMultigridPoissonSolver.cpp:238-412); multi-device
    construction is this build's own scale axis (SURVEY.md section 2.10).
    """
    # Default resolved at CALL time (not import time), so late
    # jax_enable_x64 changes are honored by the default config.
    if config is None:
        config = SolverConfig()
    validate_density(density)
    validate_fields(liquid_phi, cut_cell_weights, solid_phi=solid_phi)
    sd = config.solve_dtype
    liquid_phi = jnp.asarray(liquid_phi, dtype=sd)
    cut_cell_weights = tuple(jnp.asarray(w, dtype=sd) for w in cut_cell_weights)
    if solid_phi is not None:
        solid_phi = jnp.asarray(solid_phi, dtype=sd)
    if mesh is not None:
        from geometricmultigridpressuresolver_tpu.parallel import sharding

        liquid_phi = sharding.shard_grid(liquid_phi, mesh)
        cut_cell_weights = tuple(
            sharding.shard_grid(w, mesh) for w in cut_cell_weights
        )
        if solid_phi is not None:
            solid_phi = sharding.shard_grid(solid_phi, mesh)

    setup_base, expand_window = _jitted()
    # want_derived=False: valid/grad_scale are per-frame recomputes inside
    # the projection program, so the setup program does not emit them.
    material, _, _, mg_labels, trimmed, mg_weights, projections = (
        setup_base(
            liquid_phi,
            cut_cell_weights,
            solid_phi,
            config.theta_clamp,
            sd,
            config.dirichlet_band,
            want_derived=False,
        )
    )

    base_shape = tuple(liquid_phi.shape)
    if config.compact_domain:
        non_ext_count = int(projections[3])
        if non_ext_count == 0:
            # No liquid anywhere (e.g. a frame where it all left the
            # domain): a tiny all-EXTERIOR window keeps every downstream
            # program well-formed -- zero DOFs, zero RHS, and the CG
            # zero-RHS early-out makes the solve trivially free (the
            # reference node similarly degrades to a no-op when
            # buildMaterialCellLabels finds no liquid).
            mg_levels, padding = 2, 2
            bbox = tuple((s // 2, s // 2 + 1) for s in base_shape)
            expanded_shape = (8, 8, 8)
            window_labels = trimmed
        else:
            proj_host = [np.asarray(p) for p in projections[:3]]
            mg_levels, padding, bbox, expanded_shape = (
                domain_ops.compact_expansion_params(
                    proj_host,
                    non_ext_count=non_ext_count,
                    coarse_dof_target=config.coarse_dof_target,
                )
            )
            window_labels = trimmed
    else:
        mg_levels, padding, expanded_shape = domain_ops.expansion_params(base_shape)
        bbox = tuple((0, n) for n in base_shape)
        window_labels = mg_labels

    # Sticky window shape: reuse the previous frame's (larger-or-equal)
    # window so every downstream program -- expansion, hierarchy build, the
    # whole solve -- keeps its compiled shape while the liquid moves.  The
    # fit check uses the MINIMAL requirement; fresh allocations add
    # `window_slack` padding quanta of headroom so near-future growth keeps
    # fitting.
    if (
        reuse_from is not None
        and reuse_from.padding == padding
        and reuse_from.mg_levels == mg_levels
        and all(
            pe >= ne for pe, ne in zip(reuse_from.expanded_shape, expanded_shape)
        )
    ):
        expanded_shape = reuse_from.expanded_shape
    elif reuse_from is not None and config.window_slack:
        # Regrowth (the previous window no longer fits): add headroom on
        # every axis so the next growth spurts keep fitting.  One-shot
        # solves (reuse_from=None) keep exact minimal shapes.
        expanded_shape = tuple(
            e + config.window_slack * padding for e in expanded_shape
        )

    # Static per-axis base padding: at least `padding`, and enough that the
    # window always fits (padded >= expanded per axis).
    base_pads = tuple(
        (padding, max(padding, e - b - padding))
        for e, b in zip(expanded_shape, base_shape)
    )
    # Window origin in padded-base coords: leading exterior margin of at
    # least `padding` in front of the active bbox, clamped to the slice
    # bound (both margins stay >= padding; see the NamedTuple docstring).
    start_host = [
        min(lo, b + plo + phi - e)
        for (lo, _), b, (plo, phi), e in zip(
            bbox, base_shape, base_pads, expanded_shape
        )
    ]
    window_start = jnp.asarray(start_host, dtype=jnp.int32)
    # Sharded setups slice the window STATICALLY (see _window_static); the
    # single-device path keeps the traced origin for sticky-window program
    # reuse across moving-liquid frames.
    static_start = (
        tuple(int(s) for s in start_host) if mesh is not None else None
    )

    # Expansion + hierarchy + fine CG operator: ONE device program (plus
    # the coarse direct solve's densify program inside _finish_hierarchy).
    from geometricmultigridpressuresolver_tpu.solver import mg as mg_mod

    mg_dtype, fine_dtype, fine_full = mgpcg.fine_plan(config)
    target_levels = mg_levels
    if config.max_mg_levels is not None:
        target_levels = min(target_levels, config.max_mg_levels)
    fused_args = (
        window_labels, mg_weights, window_start, base_pads,
        tuple(expanded_shape), target_levels, config.boundary_width,
        mg_dtype, config.mg_ew_dtype, fine_dtype, fine_full,
        static_start, mesh,
    )
    if mg_mod.setup_fusion_resolved(
        config, _expand_build_device, fused_args, mesh
    ) != "per-level":
        labels, exp_weights, levels, flags, label_levels, fine = (
            _expand_build_device(*fused_args)
        )
    else:
        labels, exp_weights = expand_window(
            window_labels, mg_weights, window_start, base_pads,
            tuple(expanded_shape), static_start, mesh,
        )
        levels, flags, label_levels, fine = mg_mod.device_hierarchy(
            labels, tuple(exp_weights), target_levels,
            dataclasses.replace(config, setup_fusion="per-level"),
            fine_dtype, fine_full, mesh=mesh,
        )

    if validate:
        labels_np = np.asarray(labels)
        exp_w_np = [np.asarray(w) for w in exp_weights]
        assert domain_ops.check_boundary_cells(labels_np, exp_w_np)
        assert domain_ops.check_exterior_shell(labels_np)

    hier = mg_mod._finish_hierarchy(
        levels, flags, label_levels, config, validate=validate,
        host_fw=tuple(exp_weights),
    )
    problem = mgpcg._finish_problem(hier, fine, fine_full)
    setup = ProjectionSetup(
        problem=problem,
        material=material,
        weights=cut_cell_weights,
        liquid_phi=liquid_phi,
        window_start=window_start,
        expanded_shape=tuple(labels.shape),
        base_pads=base_pads,
        padding=padding,
        mg_levels=mg_levels,
        window_start_static=static_start,
    )
    if mesh is not None:
        from geometricmultigridpressuresolver_tpu.parallel import sharding

        # Canonical placement: replicates the tiny coarse direct-solve
        # arrays and the scalar window origin; the per-level and base grids
        # already match their canonical specs, so those puts are no-ops.
        setup = sharding.shard_setup(setup, mesh)
    return setup


def embed_window(base, window_start, base_pads, expanded_shape,
                 static_start=None) -> jax.Array:
    """Window a base-grid cell field into the expanded multigrid domain.

    `window_start` is traced; `base_pads`/`expanded_shape` must be static
    Python tuples (pass them explicitly under jit -- ProjectionSetup's
    static fields are pytree leaves and would be traced).  With
    `static_start` (sharded setups) the slice is fully static and
    partitions over a mesh without resharding."""
    if static_start is not None:
        return _window_static(base, static_start, base_pads, expanded_shape, 0)
    padded = jnp.pad(base, base_pads)
    idx = tuple(window_start[a] for a in range(3))
    return jax.lax.dynamic_slice(padded, idx, expanded_shape)


def extract_window(expanded, window_start, base_pads, base_shape,
                   static_start=None) -> jax.Array:
    """Scatter an expanded-domain field back onto the base grid."""
    if static_start is not None:
        # base[i] = expanded[i + pad_lo - start] (0 outside the window): the
        # inverse of the static embed is itself a static window slice.
        inv_start = tuple(
            plo - s for (plo, _), s in zip(base_pads, static_start)
        )
        zero_pads = ((0, 0), (0, 0), (0, 0))
        return _window_static(expanded, inv_start, zero_pads, base_shape, 0)
    padded_shape = tuple(
        b + plo + phi for b, (plo, phi) in zip(base_shape, base_pads)
    )
    buf = jnp.zeros(padded_shape, dtype=expanded.dtype)
    idx = tuple(window_start[a] for a in range(3))
    buf = jax.lax.dynamic_update_slice(buf, expanded, idx)
    sl = tuple(slice(plo, plo + b) for b, (plo, _) in zip(base_shape, base_pads))
    return buf[sl]


def _embed(base: jax.Array, setup: "ProjectionSetup") -> jax.Array:
    """Eager-context convenience wrapper over `embed_window`."""
    return embed_window(
        base, setup.window_start, setup.base_pads, setup.expanded_shape,
        static_start=setup.window_start_static,
    )


def _extract(expanded: jax.Array, setup: "ProjectionSetup") -> jax.Array:
    """Eager-context convenience wrapper over `extract_window`."""
    return extract_window(
        expanded, setup.window_start, setup.base_pads, setup.material.shape,
        static_start=setup.window_start_static,
    )


def negative_divergence(
    liquid_mask: jax.Array,
    velocity: Sequence[jax.Array],
    weights: Sequence[jax.Array],
    solid_velocity: Sequence[jax.Array] | None = None,
) -> jax.Array:
    """RHS on the base grid: per liquid cell, sum over faces of
    sign * (w * u + (1 - w) * u_solid), sign +1 on lower faces.

    Reference buildRHS (Source/HDK_GeometricFreeSurfacePressureSolver.cpp:867-943).
    """
    div = jnp.zeros(liquid_mask.shape, dtype=velocity[0].dtype)
    for axis in range(3):
        w = weights[axis]
        u = velocity[axis]
        flux = w * u
        if solid_velocity is not None:
            flux = flux + (1.0 - w) * solid_velocity[axis]
        div = div + _face_lo(flux, axis) - _face_hi(flux, axis)
    return jnp.where(liquid_mask, div, jnp.zeros_like(div))


def apply_pressure_gradient(
    velocity: Sequence[jax.Array],
    pressure: jax.Array,
    valid_faces: Sequence[jax.Array],
    grad_scale: Sequence[jax.Array],
) -> tuple[jax.Array, ...]:
    """v -= grad(p) on valid faces, with the ghost-fluid 1/theta scale on
    liquid-air faces.  Reference applyPressureGradient
    (Source/HDK_GeometricFreeSurfacePressureSolver.cpp:1049-1131)."""
    out = []
    for axis in range(3):
        u = velocity[axis]
        interior = [slice(None)] * 3
        interior[axis] = slice(1, -1)
        interior = tuple(interior)
        p_lo, p_hi = _lo_hi(pressure, axis)
        grad = jnp.zeros_like(u)
        grad = grad.at[interior].set((p_hi - p_lo) * grad_scale[axis][interior])
        out.append(jnp.where(valid_faces[axis], u - grad, u))
    return tuple(out)


def divergence_stats(
    liquid_mask: jax.Array,
    velocity: Sequence[jax.Array],
    weights: Sequence[jax.Array],
    solid_velocity: Sequence[jax.Array] | None = None,
):
    """(max, accumulated, average) divergence over liquid cells.

    Reference computeResultingDivergence
    (Source/HDK_GeometricFreeSurfacePressureSolver.cpp:1133-1208); note the
    sign is the true divergence (+ on upper faces), opposite of the RHS.
    """
    div = -negative_divergence(liquid_mask, velocity, weights, solid_velocity)
    count = jnp.maximum(jnp.sum(liquid_mask), 1)
    total = jnp.sum(div)
    max_div = jnp.max(jnp.abs(div))
    return max_div, total, total / count


class ProjectionResult(NamedTuple):
    pressure: jax.Array
    velocity: tuple[jax.Array, ...]
    cg: cg_mod.CGResult
    # Post-projection divergence audit: max / average over liquid cells, as
    # printed by the reference
    # (Source/HDK_GeometricFreeSurfacePressureSolver.cpp:704-706).
    max_divergence: jax.Array
    avg_divergence: jax.Array
    # Recomputed (not recurrence-drifted) residual diagnostics, as the
    # reference node prints after the solve
    # (Source/HDK_GeometricFreeSurfacePressureSolver.cpp:620-628).
    residual_rel_l2: jax.Array
    residual_linf: jax.Array
    # Accumulated (summed) divergence, the third number of the reference's
    # audit line.  Appended last: fields added after the round-1 release go
    # at the END so positional/index consumers of this public NamedTuple
    # keep their meaning.
    accumulated_divergence: jax.Array


def _project_impl_fn(
    setup: ProjectionSetup,
    velocity,
    solid_velocity,
    old_pressure,
    config: SolverConfig,
    has_solid_vel: bool,
    has_x0: bool,
    base_pads,
    expanded_shape,
    static_start=None,
):
    """The whole per-frame computation as ONE program: RHS, warm start,
    MGPCG solve, writeback, audit.  Static geometry is threaded explicitly
    because ProjectionSetup's static fields are pytree leaves.
    """
    sd = config.solve_dtype
    solid_velocity = solid_velocity if has_solid_vel else None

    # Derived per-frame fields, recomputed from the primary setup arrays
    # (a few elementwise passes fused into this program; see ProjectionSetup's
    # storage-diet note).
    liquid_mask = setup.material == LIQUID
    valid_faces, grad_scale = face_projection_fields(
        setup.material, setup.liquid_phi, setup.weights, config.theta_clamp, sd
    )

    rhs_base = negative_divergence(
        liquid_mask, velocity, setup.weights, solid_velocity
    )
    rhs = embed_window(rhs_base, setup.window_start, base_pads, expanded_shape,
                       static_start=static_start)

    x0 = None
    if config.use_old_pressure and has_x0:
        warm = jnp.where(liquid_mask, old_pressure.astype(sd), 0.0)
        x0 = embed_window(warm, setup.window_start, base_pads, expanded_shape,
                          static_start=static_start)

    cg_result = mgpcg._solve(setup.problem, rhs, x0 if x0 is not None else rhs,
                             config, x0 is not None)

    pressure = extract_window(
        cg_result.x, setup.window_start, base_pads, rhs_base.shape,
        static_start=static_start,
    )
    pressure = jnp.where(liquid_mask, pressure, jnp.zeros_like(pressure))

    # Recomputed residual report (reference cpp:620-628).
    from geometricmultigridpressuresolver_tpu.ops import stencil as stencil_ops

    rel_l2, linf = cg_mod.recomputed_residual_norms(
        lambda v: stencil_ops.apply_poisson(v, setup.problem.fine),
        cg_result.x,
        rhs,
        setup.problem.fine.solvable,
    )

    new_velocity = apply_pressure_gradient(
        velocity, pressure, valid_faces, grad_scale
    )
    max_div, total_div, avg_div = divergence_stats(
        liquid_mask, new_velocity, setup.weights, solid_velocity
    )
    return ProjectionResult(
        pressure, new_velocity, cg_result, max_div, avg_div,
        rel_l2, linf, total_div,
    )


_PROJECT_STATICS = (
    "config", "has_solid_vel", "has_x0", "base_pads", "expanded_shape",
    "static_start",
)
_project_impl = functools.partial(
    jax.jit, static_argnames=_PROJECT_STATICS
)(_project_impl_fn)
# Donating variant: the input velocity buffers are reused for the projected
# output velocity (same shapes/dtypes -- a perfect alias covering the three
# largest per-frame arrays).  VELOCITY ONLY: the warm-start pressure must
# NOT be donated -- frame loops legitimately retain the previous frame's
# pressure (e.g. simulate.run returns every FrameResult.pressure while
# also warm-starting from it), and donating it would delete the retained
# array.  Opt-in (`project(donate=True)`) because even the velocity inputs
# are DELETED -- callers that reuse them (tests comparing sharded vs
# single-device runs, benches timing repeated solves on fixed inputs) must
# keep the default.
_project_impl_donated = functools.partial(
    jax.jit, static_argnames=_PROJECT_STATICS, donate_argnums=(1,)
)(_project_impl_fn)


def project(
    setup: ProjectionSetup,
    velocity: Sequence[jax.Array],
    solid_velocity: Sequence[jax.Array] | None = None,
    old_pressure: jax.Array | None = None,
    config: SolverConfig | None = None,
    donate: bool = False,
) -> ProjectionResult:
    """Steps 5-9: RHS, warm start, MGPCG solve, writeback, audit.

    `donate=True` donates the velocity buffers to the computation -- the
    frame loop's steady-state device memory drops by one full velocity field
    (~1.4 GB at 448^3).  The passed velocity arrays are consumed: keep
    using the RESULT's velocity, never the inputs (models/simulate.py
    does this).  `old_pressure` is never donated (frame loops retain it).
    """
    # Default resolved at CALL time (not import time), so late
    # jax_enable_x64 changes are honored by the default config.
    if config is None:
        config = SolverConfig()
    validate_fields(setup.material, setup.weights, velocity=velocity)
    sd = config.solve_dtype
    velocity = tuple(jnp.asarray(v, dtype=sd) for v in velocity)
    has_solid_vel = solid_velocity is not None
    solid_velocity = (
        tuple(jnp.asarray(v, dtype=sd) for v in solid_velocity)
        if has_solid_vel
        else velocity  # placeholder pytree (ignored when has_solid_vel=False)
    )
    has_x0 = config.use_old_pressure and old_pressure is not None
    old_pressure = (
        jnp.asarray(old_pressure, dtype=sd) if has_x0 else setup.liquid_phi
    )
    if donate and not has_solid_vel:
        # The placeholder must not alias the donated velocity buffers.
        solid_velocity = tuple(jnp.zeros((1, 1, 1), dtype=sd) for _ in range(3))

    impl = _project_impl_donated if donate else _project_impl
    return impl(
        setup, velocity, solid_velocity, old_pressure, config,
        has_solid_vel, has_x0, setup.base_pads, setup.expanded_shape,
        setup.window_start_static,
    )

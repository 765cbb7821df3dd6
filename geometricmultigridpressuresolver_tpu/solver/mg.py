"""Geometric multigrid V-cycle engine.

Equivalent of the reference `GeometricMultigridPoissonSolver`
(Source/HDK_GeometricMultigridPoissonSolver.{h,cpp}):

  * build_hierarchy -> the constructor (cpp:135-412): label coarsening with
    level capping when a coarse level has no DOFs (cpp:243-248), per-level
    boundary bands of width 3 (cpp:279-281), and the coarsest-level direct
    solver.  The reference factors an Eigen SimplicialCholesky (cpp:405-411)
    and back-substitutes every cycle; we instead precompute the dense
    inverse of the (tiny, SPD) coarsest DOF system once on the host and
    apply it as a single matmul on-device -- exactly symmetric.

  * v_cycle -> applyVCycle (cpp:420-881): a V(1,1) cycle where each interior
    smooth is bracketed by 3 damped-Jacobi passes over the boundary band,
    Gauss-Seidel sweeps use adjoint ordering on the upstroke, and the
    prolongation adds 4x the trilinear upsample.  With a single level the
    cycle is smoothing-only (cpp:516-517 early-out).

The hierarchy is a pytree of static per-level coefficient grids, so
`v_cycle` is a pure jittable function; one V-cycle is used per PCG
iteration as the preconditioner.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from geometricmultigridpressuresolver_tpu.config import SolverConfig
from geometricmultigridpressuresolver_tpu.models import assembled
from geometricmultigridpressuresolver_tpu.ops import domain as domain_ops
from geometricmultigridpressuresolver_tpu.ops import blas, stencil, transfer


# Largest bucketed coarse-system size solved via explicit dense inverse
# (one matmul per cycle); bigger systems use a Cholesky factorization
# (fp32-safe conditioning, 2x less HBM than the inverse of the same size).
COARSE_INVERSE_MAX_PAD = 4096


class MGHierarchy(NamedTuple):
    """Static multigrid hierarchy (a pytree of device arrays).

    The coarsest direct solver is one of two exact representations chosen
    at build time by system size (see build_hierarchy): a dense inverse
    applied as a single matmul (small systems), or a Cholesky factor
    applied by triangular solves (large systems; matches the reference's
    Eigen SimplicialCholesky,
    Source/HDK_GeometricMultigridPoissonSolver.cpp:405-411, with better
    fp32 conditioning than an explicit inverse).  The unused
    representation is a (0, 0) array -- shapes are static, so the choice
    is a trace-time branch.
    """

    levels: tuple[stencil.LevelCoeffs, ...]
    coarse_dofs: jax.Array  # int32 flat indices of coarsest-level DOF cells
    coarse_minv: jax.Array  # (ndof, ndof) dense inverse, or (0, 0)
    coarse_chol: jax.Array  # (ndof, ndof) lower Cholesky factor, or (0, 0)

    @property
    def num_levels(self) -> int:
        return len(self.levels)


def _level_coeffs_traced(labels, face_weights, boundary_width: int, dtype, ew_dtype,
                         mesh=None):
    """One level's LevelCoeffs (pure traced helper; no jit boundary).

    `ew_dtype` optionally narrows the storage of the off-diagonal edge
    weights (config.mg_ew_dtype): unit weights stay exact, and quantizing
    the off-diagonal symmetrically keeps the operator symmetric, so the
    V-cycle remains a valid CG preconditioner.  diag/inv_diag stay in
    `dtype` (an exact reciprocal pair, which the smoother identity
    inv_diag * diag = 1 relies on).

    With `mesh`, every output grid is sharding-constrained to its canonical
    mesh partitioning (sharded setup path; see parallel.mesh.constrain_grid).
    """
    c = domain_ops.build_level_coefficients(labels, face_weights, boundary_width, dtype)
    ew = c["ew"]
    if ew_dtype is not None:
        ew = [w.astype(ew_dtype) for w in ew]
    coeffs = stencil.LevelCoeffs(
        solvable=c["solvable"],
        # int8 storage (one byte per cell); boundary_jacobi casts it back
        # to bool inside its fusion.
        band=c["band"].astype(jnp.int8),
        diag=c["diag"],
        inv_diag=c["inv_diag"],
        ew0=ew[0],
        ew1=ew[1],
        ew2=ew[2],
    )
    if mesh is not None:
        from geometricmultigridpressuresolver_tpu.parallel.mesh import constrain_grid

        coeffs = stencil.LevelCoeffs(*(constrain_grid(a, mesh) for a in coeffs))
    return coeffs


def _build_levels_traced(
    labels,
    face_weights,
    target_levels: int,
    boundary_width: int,
    dtype,
    ew_dtype=None,
    fine_dtype=None,
    fine_full: bool = False,
    mesh=None,
):
    """EVERY level's coefficients + capping flags as ONE traced computation.

    Tracing the whole level loop into one program makes setup one compile
    and one dispatch; shapes shrink 8x per level, so the merged program is
    not much bigger than the finest level's alone.

    `fine_dtype` additionally emits the finest-level CG operator in the
    solve dtype inside the SAME program: the full LevelCoeffs when
    `fine_full`, else just the three edge-weight arrays (the caller shares
    solvable/band/diag/inv_diag with levels[0], which are bit-identical
    when only the edge-weight storage dtype differs -- see
    mgpcg.build_problem).

    Returns (levels, flags, label_levels, fine) -- all pytrees of device
    arrays when called under jit.
    """
    if mesh is not None:
        from geometricmultigridpressuresolver_tpu.parallel.mesh import constrain_grid
    else:
        constrain_grid = lambda a, _m: a  # noqa: E731

    cur = labels
    label_levels = [cur]
    levels = []
    flags = []
    for i in range(target_levels):
        fw_i = face_weights if i == 0 else None
        # The compact domain only guarantees even extents down to the
        # coarsest level; never coarsen past an odd extent (or the cap).
        can_coarsen = i + 1 < target_levels and all(s % 2 == 0 for s in cur.shape)
        levels.append(
            _level_coeffs_traced(cur, fw_i, boundary_width, dtype, ew_dtype, mesh)
        )
        if not can_coarsen:
            break
        coarse = constrain_grid(
            domain_ops.coarsen_labels(cur), mesh
        )
        flags.append(domain_ops.is_solvable(coarse).any())
        cur = coarse
        label_levels.append(cur)

    fine = None
    if fine_dtype is not None:
        fc = _level_coeffs_traced(
            labels, face_weights, boundary_width, fine_dtype, None, mesh
        )
        fine = fc if fine_full else (fc.ew0, fc.ew1, fc.ew2)
    return tuple(levels), tuple(flags), tuple(label_levels), fine


@functools.partial(
    jax.jit,
    static_argnames=(
        "target_levels", "boundary_width", "dtype", "ew_dtype", "fine_dtype",
        "fine_full", "mesh",
    ),
)
def _device_hierarchy(
    labels,
    face_weights,
    target_levels: int,
    boundary_width: int,
    dtype,
    ew_dtype=None,
    fine_dtype=None,
    fine_full: bool = False,
    mesh=None,
):
    """All hierarchy levels in ONE compiled program (see _build_levels_traced)."""
    return _build_levels_traced(
        labels, face_weights, target_levels, boundary_width, dtype, ew_dtype,
        fine_dtype, fine_full, mesh,
    )


@functools.partial(
    jax.jit,
    static_argnames=("boundary_width", "dtype", "ew_dtype", "coarsen", "mesh"),
)
def _device_level(
    labels, face_weights, boundary_width: int, dtype, ew_dtype=None,
    coarsen: bool = True, mesh=None,
):
    """One level's coefficients (+ next-coarser labels): the per-level
    program of config.setup_fusion="per-level"."""
    coeffs = _level_coeffs_traced(
        labels, face_weights, boundary_width, dtype, ew_dtype, mesh
    )
    if not coarsen:
        return coeffs
    coarse = domain_ops.coarsen_labels(labels)
    if mesh is not None:
        from geometricmultigridpressuresolver_tpu.parallel.mesh import constrain_grid

        coarse = constrain_grid(coarse, mesh)
    return coeffs, coarse, domain_ops.is_solvable(coarse).any()


def device_free_bytes(mesh=None) -> int | None:
    """Free device memory in bytes (the least over a mesh's devices), or
    None when the device reports no memory limit (the CPU backend)."""
    devices = jax.devices()[:1] if mesh is None else list(mesh.devices.flat)
    free = []
    for d in devices:
        stats = d.memory_stats()
        if not stats or "bytes_limit" not in stats:
            return None
        free.append(stats["bytes_limit"] - stats.get("bytes_in_use", 0))
    return min(free)


def setup_fusion_resolved(config, fused_program, args, mesh=None) -> str:
    """The concrete setup granularity for one build: "fused" or "per-level".

    "auto" fuses unless the fused program's per-device workspace (its
    compiled temporaries plus outputs) exceeds the memory the device has
    free; the per-level build then needs only one level's workspace at a
    time.  A device that reports no memory limit always fuses.  Compiling
    here costs nothing extra when fusion wins: the call that follows
    reuses the executable.
    """
    if config.setup_fusion != "auto":
        return config.setup_fusion
    free = device_free_bytes(mesh)
    if free is None:
        return "fused"
    mem = fused_program.lower(*args).compile().memory_analysis()
    need = (
        mem.temp_size_in_bytes + mem.output_size_in_bytes
        - mem.alias_size_in_bytes
    )
    return "fused" if need <= free else "per-level"


def device_hierarchy(labels, face_weights, target_levels: int, config,
                     fine_dtype=None, fine_full: bool = False, mesh=None):
    """Build the level stack on device at the configured program granularity.

    Same (levels, flags, label_levels, fine) contract as _device_hierarchy;
    "per-level" runs one program per level, whose workspace is one level's
    rather than the whole hierarchy's (see setup_fusion_resolved).

    With `mesh`, the build runs SPMD over the mesh: inputs should already be
    block-partitioned (parallel.sharding.shard_grid) and every level's
    arrays stay sharding-constrained to their canonical partitioning, so no
    device ever materializes a full fine-level grid.
    """
    dtype = config.mg_dtype_resolved
    fused_args = (
        labels, face_weights, target_levels, config.boundary_width,
        dtype, config.mg_ew_dtype, fine_dtype, fine_full, mesh,
    )
    mode = setup_fusion_resolved(config, _device_hierarchy, fused_args, mesh)
    if mode != "per-level":
        return _device_hierarchy(*fused_args)
    cur = labels
    label_levels = [cur]
    levels, flags = [], []
    for i in range(target_levels):
        fw_i = face_weights if i == 0 else None
        can_coarsen = i + 1 < target_levels and all(s % 2 == 0 for s in cur.shape)
        if not can_coarsen:
            levels.append(
                _device_level(
                    cur, fw_i, config.boundary_width, dtype,
                    config.mg_ew_dtype, coarsen=False, mesh=mesh,
                )
            )
            break
        coeffs, coarse, has_dofs = _device_level(
            cur, fw_i, config.boundary_width, dtype, config.mg_ew_dtype,
            mesh=mesh,
        )
        levels.append(coeffs)
        flags.append(has_dofs)
        cur = coarse
        label_levels.append(cur)
    fine = None
    if fine_dtype is not None:
        fc = _device_level(
            labels, face_weights, config.boundary_width, fine_dtype,
            coarsen=False, mesh=mesh,
        )
        fine = fc if fine_full else (fc.ew0, fc.ew1, fc.ew2)
    return tuple(levels), tuple(flags), tuple(label_levels), fine


@functools.partial(jax.jit, static_argnames=("nd_pad",))
def _densify(rows, cols, vals, ndof, nd_pad: int):
    """Scatter COO triplets into a dense (nd_pad, nd_pad) matrix with an
    identity pad block (block_diag(A, I) keeps the bucketed shape exact)."""
    a = jnp.zeros((nd_pad, nd_pad), dtype=jnp.float32)
    a = a.at[rows, cols].add(vals)
    i = jnp.arange(nd_pad)
    a = a + jnp.where(i >= ndof, 1.0, 0.0) * jnp.eye(nd_pad, dtype=jnp.float32)
    return a


@functools.partial(jax.jit, static_argnames=("nd_pad",))
def _densify_invert(rows, cols, vals, ndof, nd_pad: int):
    """Dense inverse of the padded system, symmetrized on-device."""
    minv = jnp.linalg.inv(_densify(rows, cols, vals, ndof, nd_pad))
    return 0.5 * (minv + minv.T)


@functools.partial(jax.jit, static_argnames=("nd_pad",))
def _densify_cholesky(rows, cols, vals, ndof, nd_pad: int):
    """Lower Cholesky factor of the padded SPD system."""
    return jnp.linalg.cholesky(_densify(rows, cols, vals, ndof, nd_pad))


def _coarse_system_traced(c: stencil.LevelCoeffs, nd_pad: int):
    """Coarsest-level direct solve assembled ON DEVICE, fully traced.

    The host path (_finish_hierarchy) assembles the coarsest matrix with
    scipy and ships bucketed triplets; this builds the SAME identity-padded
    dense system straight from the level's stencil coefficients (A[i,i] =
    diag, A[i,j] = -ew between solvable neighbors -- the operator
    apply_poisson applies), so a per-frame hierarchy rebuild can live
    INSIDE one compiled multi-frame program (models/simulate.run_fused;
    no host round trip).  Returns (coarse_dofs, coarse_minv) ready for
    MGHierarchy; DOF ordering is flat-C cell order, same as the host
    assembler's.

    Bucketing contract: solvable cells beyond `nd_pad` DOFs spill into a
    dump row/column and are trimmed -- the preconditioner stays symmetric
    but weakens, so callers must size the bucket with headroom and check
    the emitted per-frame DOF count (run_fused does).
    """
    dtype = c.diag.dtype
    solv = c.solvable.reshape(-1)
    ncell = solv.size
    slot = jnp.where(solv, jnp.cumsum(solv.astype(jnp.int32)) - 1, nd_pad)
    ndof = jnp.sum(solv.astype(jnp.int32))
    # Dense system with one dump row/col at nd_pad: scatters from non-DOF
    # cells (and bucket overflow) land there and are trimmed.
    a = jnp.zeros((nd_pad + 1, nd_pad + 1), dtype=dtype)
    a = a.at[slot, slot].add(
        jnp.where(solv, c.diag.reshape(-1).astype(dtype), 0), mode="drop"
    )
    slot3 = slot.reshape(c.shape)
    for axis, ew in enumerate((c.ew0, c.ew1, c.ew2)):
        lo = [slice(None)] * 3
        hi = [slice(None)] * 3
        lo[axis] = slice(0, -1)
        hi[axis] = slice(1, None)
        s_lo = slot3[tuple(lo)].reshape(-1)
        s_hi = slot3[tuple(hi)].reshape(-1)
        # ew[i] couples cells i and i+1 along `axis`; couplings to
        # Dirichlet/exterior neighbors carry slot nd_pad and fall in the
        # dump (they contribute to diag only, already in c.diag).
        w = ew[tuple(lo)].reshape(-1).astype(dtype)
        a = a.at[s_lo, s_hi].add(-w, mode="drop")
        a = a.at[s_hi, s_lo].add(-w, mode="drop")
    a = a[:nd_pad, :nd_pad]
    i = jnp.arange(nd_pad)
    a = a + jnp.where(i >= ndof, dtype.type(1.0), dtype.type(0.0)) * jnp.eye(
        nd_pad, dtype=dtype
    )
    minv = jnp.linalg.inv(a)
    minv = dtype.type(0.5) * (minv + minv.T)
    # Slot -> flat cell index (the gather/scatter map coarse_solve uses);
    # pad slots keep the out-of-range sentinel ncell.
    dofs = (
        jnp.full((nd_pad,), ncell, dtype=jnp.int32)
        .at[slot]
        .set(jnp.arange(ncell, dtype=jnp.int32), mode="drop")
    )
    return dofs, minv, ndof


def build_hierarchy(
    labels,
    face_weights: Sequence | None,
    mg_levels: int,
    config: SolverConfig | None = None,
    validate: bool = False,
    mesh=None,
) -> MGHierarchy:
    """Hierarchy construction from expanded+relabeled finest labels.

    `labels` must already be the expanded power-of-two domain with BOUNDARY
    relabeling applied (see ops.domain.expand_domain / set_boundary_labels);
    `face_weights` exist only at the finest level.  All per-level array work
    runs on the device under jit; only the (tiny) coarsest-level direct
    solver is assembled on the host.

    With `mesh`, the build runs SPMD: inputs are block-partitioned over the
    mesh first and every level's arrays stay sharded (see device_hierarchy).
    """
    # Default resolved at CALL time (not import time), so late
    # jax_enable_x64 changes are honored by the default config.
    if config is None:
        config = SolverConfig()
    dtype = config.mg_dtype_resolved
    ew_dtype = config.mg_ew_dtype
    target_levels = mg_levels
    if config.max_mg_levels is not None:
        target_levels = min(target_levels, config.max_mg_levels)

    cur = jnp.asarray(labels)
    fw = (
        None
        if face_weights is None
        else tuple(jnp.asarray(w, dtype=dtype) for w in face_weights)
    )
    if mesh is not None:
        from geometricmultigridpressuresolver_tpu.parallel import sharding

        cur = sharding.shard_grid(cur, mesh)
        fw = None if fw is None else tuple(
            sharding.shard_grid(w, mesh) for w in fw
        )

    # Build every level on device (ONE program when setup_fusion resolves
    # to "fused", see setup_fusion_resolved; one program per level
    # otherwise), then finish on host.
    levels, flags, label_levels, _ = device_hierarchy(
        cur, fw, target_levels, config, mesh=mesh
    )
    return _finish_hierarchy(
        levels, flags, label_levels, config, validate=validate, host_fw=fw
    )


def _finish_hierarchy(
    levels,
    flags,
    label_levels,
    config: SolverConfig,
    validate: bool = False,
    host_fw=None,
) -> MGHierarchy:
    """Host side of hierarchy construction: level capping and the coarsest
    direct solver, from the device outputs of _device_hierarchy."""
    dtype = config.mg_dtype_resolved
    levels = list(levels)
    label_levels = list(label_levels)

    # One round trip: the capping flags plus the (tiny) coarsest labels;
    # the full label stack is only fetched under `validate`.
    flags_host, coarsest = jax.device_get((flags, label_levels[-1]))
    # Cap the hierarchy at the first coarse level with no DOFs (reference
    # MGPoissonSolver.cpp:243-248).
    for i, ok in enumerate(flags_host):
        if not bool(ok):
            levels = levels[: i + 1]
            label_levels = label_levels[: i + 1]
            coarsest = jax.device_get(label_levels[-1])
            break

    if validate:
        label_host = jax.device_get(label_levels)
        host_fw = None if host_fw is None else [np.asarray(w) for w in host_fw]
        assert domain_ops.check_exterior_shell(label_host[0])
        assert domain_ops.check_boundary_cells(label_host[0], host_fw)
        for fine, coarse_lv in zip(label_host, label_host[1:]):
            assert domain_ops.check_coarsening(fine, coarse_lv)
            assert domain_ops.check_boundary_cells(coarse_lv, None)

    # Coarsest-level direct solver over DOFs: dense inverse (one matmul
    # per cycle) for small systems, Cholesky factor + triangular
    # solves for large ones -- an explicit 16k x 16k fp32 inverse is
    # conditioning-fragile where the factorization is not.
    a, idx = assembled.assemble_poisson(coarsest, None)
    ndof = a.shape[0]
    if ndof > 16384:
        raise ValueError(
            f"coarsest level has {ndof} DOFs; increase mg levels "
            "(dense coarse solve would be too large)"
        )
    # The DOF count is bucketed (rounded up with zero-padded inverse rows
    # and out-of-range scatter indices) so per-frame liquid motion does not
    # change the coarse system's SHAPE -- shape changes would recompile the
    # entire fused solve program (see free_surface.build_setup's sticky
    # windows).
    nd_pad = max(256, -(-ndof // 256) * 256) if ndof else 0
    use_chol = nd_pad > COARSE_INVERSE_MAX_PAD
    chol = jnp.zeros((0, 0), dtype=dtype)
    if ndof == 0:
        minv = jnp.zeros((0, 0), dtype=dtype)
    else:
        # Pad to the bucket with an identity block BEFORE inverting:
        # block_diag(A, I)^-1 = block_diag(A^-1, I), and the fixed bucketed
        # shape keeps the device inversion's compiled program stable across
        # frames with drifting DOF counts.
        try:
            on_accel = jax.devices()[0].platform == "gpu"
        except RuntimeError:
            on_accel = False
        if on_accel and dtype == jnp.float32:
            # Densify + invert ON DEVICE from the sparse triplets: the
            # dense padded matrix is tens of MB while the triplets are
            # ~KB.  The nnz count is bucketed like the DOF count so the
            # program stays compiled across frames.
            coo = a.tocoo()
            nnz_pad = -(-coo.nnz // 4096) * 4096
            rows = np.zeros(nnz_pad, np.int32)
            cols = np.zeros(nnz_pad, np.int32)
            vals = np.zeros(nnz_pad, np.float32)
            rows[: coo.nnz] = coo.row
            cols[: coo.nnz] = coo.col
            vals[: coo.nnz] = coo.data  # padded entries add 0 at (0, 0)
            args = (
                jnp.asarray(rows), jnp.asarray(cols), jnp.asarray(vals),
                jnp.int32(ndof), nd_pad,
            )
            if use_chol:
                chol = _densify_cholesky(*args)
                minv = jnp.zeros((0, 0), dtype=dtype)
            else:
                minv = _densify_invert(*args)
        else:
            a_pad = np.eye(nd_pad)
            a_pad[:ndof, :ndof] = a.toarray()
            if use_chol:
                chol = jnp.asarray(np.linalg.cholesky(a_pad), dtype=dtype)
                minv = jnp.zeros((0, 0), dtype=dtype)
            else:
                minv = jnp.asarray(np.linalg.inv(a_pad), dtype=dtype)
                # Symmetrize so the preconditioner stays exactly SPD.
                minv = 0.5 * (minv + minv.T)
    dofs = np.flatnonzero(np.asarray(idx).ravel() >= 0).astype(np.int32)
    # Pad indices point one past the grid; gathers clip (zero minv columns
    # neutralize the garbage) and scatters drop them.
    dofs = np.pad(dofs, (0, nd_pad - ndof), constant_values=idx.size)

    return MGHierarchy(
        levels=tuple(levels),
        coarse_dofs=jnp.asarray(dofs),
        coarse_minv=minv.astype(dtype),
        coarse_chol=chol.astype(dtype),
    )


def coarse_solve(hier: MGHierarchy, b: jax.Array) -> jax.Array:
    """Direct solve on the coarsest level: gather DOFs, apply the dense
    inverse as one matmul, scatter back.

    Reference: copyGridToVector -> Eigen SimplicialCholesky solve ->
    copyVectorToGrid (Source/HDK_GeometricMultigridPoissonSolver.cpp:669-692).
    """
    # Padded (bucketed) DOF entries carry an out-of-range index: the gather
    # clips, the scatter drops them.  With the inverse representation the
    # zero minv columns neutralize the clipped garbage; with the Cholesky
    # factor the identity pad block maps pad entries to themselves, and the
    # scatter drops them either way.
    bv = b.reshape(-1)[jnp.minimum(hier.coarse_dofs, b.size - 1)]
    if hier.coarse_chol.shape[0] > 0:
        xv = jax.scipy.linalg.cho_solve((hier.coarse_chol, True), bv)
    else:
        xv = jnp.matmul(
            hier.coarse_minv, bv, precision=jax.lax.Precision.HIGHEST
        )
    flat = jnp.zeros(b.size, dtype=b.dtype).at[hier.coarse_dofs].set(
        xv, mode="drop"
    )
    return flat.reshape(b.shape)


def _smooth_level(
    x: jax.Array,
    b: jax.Array,
    c: stencil.LevelCoeffs,
    config: SolverConfig,
    forward: bool,
    emit_dot: bool = False,
):
    """boundary^k ; interior ; boundary^k smoothing block.

    Reference applyVCycle per-level schedule
    (Source/HDK_GeometricMultigridPoissonSolver.cpp:445-513 and 715-783).
    With `emit_dot`, returns (x, <x, b>) (the CG rho = <r, z> when the
    block is the preconditioner's last step on the finest level).
    """
    for _ in range(config.boundary_iterations):
        x = stencil.boundary_jacobi(x, b, c, config.jacobi_damping)
    if config.interior_smoother == "chebyshev":
        # Polynomial smoother (self-adjoint in the A-inner product; no
        # forward/backward ordering needed).
        x = stencil.chebyshev_smooth(x, b, c, config.chebyshev_degree)
    elif config.use_gauss_seidel:
        x = stencil.rb_gauss_seidel(x, b, c, forward=forward)
    else:
        x = stencil.jacobi_smooth(x, b, c, config.jacobi_damping)
    for _ in range(config.boundary_iterations):
        x = stencil.boundary_jacobi(x, b, c, config.jacobi_damping)
    if emit_dot:
        return x, blas.dot(x, b, c.solvable).astype(jnp.float32)
    return x


def v_cycle(
    hier: MGHierarchy,
    x: jax.Array,
    b: jax.Array,
    config: SolverConfig | None = None,
    use_initial_guess: bool = False,
    emit_fine_dot: bool = False,
):
    """One V(1,1) multigrid cycle; returns the updated solution grid.

    Pure and jittable; `config` / `use_initial_guess` are trace-time
    constants.  With `emit_fine_dot`, returns (x, <x, b>) from the last
    fine-level smoothing block.  Reference applyVCycle
    (Source/HDK_GeometricMultigridPoissonSolver.cpp:420-881).
    """
    # Default resolved at CALL time (not import time), so late
    # jax_enable_x64 changes are honored by the default config.
    if config is None:
        config = SolverConfig()
    nlev = hier.num_levels
    dtype = hier.levels[0].diag.dtype
    x = x.astype(dtype)
    b = b.astype(dtype)
    if config.transfer_mode == "mm":
        restrict, prolong_add = transfer.restrict_mm, transfer.prolong_add_mm
    else:
        restrict, prolong_add = transfer.restrict, transfer.prolong_add

    if not use_initial_guess:
        x = jnp.zeros_like(x)

    if nlev == 1:
        # Single-level cycle is smoothing-only (reference cpp:516-517).
        return _smooth_level(
            x, b, hier.levels[0], config, forward=True, emit_dot=emit_fine_dot
        )

    # Downstroke.
    rhs = [b] + [None] * (nlev - 1)
    sols: list[jax.Array | None] = [None] * nlev
    for level in range(nlev - 1):
        c = hier.levels[level]
        xl = x if level == 0 else jnp.zeros(c.shape, dtype=dtype)
        xl = _smooth_level(xl, rhs[level], c, config, forward=True)
        sols[level] = xl
        r = stencil.residual(xl, rhs[level], c)
        rhs[level + 1] = restrict(r, hier.levels[level + 1].solvable)

    # Coarsest level direct solve.
    sols[nlev - 1] = coarse_solve(hier, rhs[nlev - 1])

    # Upstroke with adjoint smoother ordering.
    for level in range(nlev - 2, -1, -1):
        c = hier.levels[level]
        xl = prolong_add(sols[level], sols[level + 1], c.solvable)
        sols[level] = _smooth_level(
            xl, rhs[level], c, config, forward=False,
            emit_dot=emit_fine_dot and level == 0,
        )

    # sols[0] is (x, <x, b>) with emit_fine_dot: the preconditioner output
    # and the CG rho = <r, z> (b IS the CG residual when used as
    # preconditioner).
    return sols[0]

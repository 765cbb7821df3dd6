"""MGPCG Poisson solver: V-cycle-preconditioned conjugate gradient.

Ties the V-cycle engine to the PCG driver the way the reference's flagship
node does (Source/HDK_GeometricFreeSurfacePressureSolver.cpp:426-629): one
`applyVCycle` per CG iteration when `use_mg_preconditioner`, else the
inverse-diagonal preconditioner (cpp:486-618).

Mixed precision: the outer CG runs in `config.solve_dtype` while the
V-cycle runs in `config.mg_dtype` (the reference README's named future
evolution, README.md:34-35).  A preconditioner that is a fixed linear
operator in lower precision is still a fixed symmetric operator, so CG
remains valid.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from geometricmultigridpressuresolver_tpu.config import SolverConfig
from geometricmultigridpressuresolver_tpu.ops import domain as domain_ops
from geometricmultigridpressuresolver_tpu.ops import stencil
from geometricmultigridpressuresolver_tpu.solver import cg as cg_mod
from geometricmultigridpressuresolver_tpu.solver import mg as mg_mod


class PoissonProblem(NamedTuple):
    """Device-side static data for one label/weight set (a pytree)."""

    fine: stencil.LevelCoeffs       # finest-level coeffs in solve dtype
    hier: mg_mod.MGHierarchy        # V-cycle hierarchy in mg dtype


def fine_plan(config: SolverConfig):
    """(mg_dtype, fine_dtype, fine_full): which extra finest-level CG
    operator pieces the setup device program must emit.  None/False means
    the hierarchy's finest level is shared as-is; a fine_dtype with
    fine_full=False emits just the solve-dtype edge weights (only the ew
    storage narrows); fine_full emits the full coefficient set (distinct
    MG precision)."""
    dtype = config.mg_dtype_resolved
    same = dtype == config.solve_dtype
    fine_dtype = None if (same and config.mg_ew_dtype is None) else config.solve_dtype
    return dtype, fine_dtype, not same


def build_problem(
    labels: np.ndarray,
    face_weights: Sequence[np.ndarray] | None,
    mg_levels: int,
    config: SolverConfig | None = None,
    validate: bool = False,
    mesh=None,
) -> PoissonProblem:
    """Host-side setup from expanded+relabeled labels (+ finest weights).

    ALL device array work -- every hierarchy level plus the finest-level CG
    operator -- runs as ONE compiled program (mg._device_hierarchy) unless
    config.setup_fusion resolves to one program per level.

    With `mesh`, the whole build runs SPMD over the mesh: inputs are
    block-partitioned first, every level's arrays stay sharded, and the
    finished problem is placed per parallel.sharding.shard_problem -- no
    device ever holds a full fine-level grid (the reference's equivalent
    hierarchy constructor is single-address-space,
    Source/HDK_GeometricMultigridPoissonSolver.cpp:238-412; multi-chip
    construction is this build's own scale axis, SURVEY.md section 2.10).
    """
    # Default resolved at CALL time (not import time), so late
    # jax_enable_x64 changes are honored by the default config.
    if config is None:
        config = SolverConfig()
    dtype, fine_dtype, fine_full = fine_plan(config)
    sd = config.solve_dtype
    target_levels = mg_levels
    if config.max_mg_levels is not None:
        target_levels = min(target_levels, config.max_mg_levels)

    lab = jnp.asarray(labels)
    # Weights ship in the WIDER solve dtype; each level's builder narrows
    # internally (build_level_coefficients astypes per level), which is
    # value-identical to pre-casting on the host.
    fw = (
        None
        if face_weights is None
        else tuple(jnp.asarray(w, dtype=sd) for w in face_weights)
    )
    if mesh is not None:
        from geometricmultigridpressuresolver_tpu.parallel import sharding

        lab = sharding.shard_grid(lab, mesh)
        fw = None if fw is None else tuple(
            sharding.shard_grid(w, mesh) for w in fw
        )
    levels, flags, label_levels, fine = mg_mod.device_hierarchy(
        lab, fw, target_levels, config, fine_dtype, fine_full, mesh=mesh
    )
    hier = mg_mod._finish_hierarchy(
        levels, flags, label_levels, config, validate=validate, host_fw=fw
    )
    problem = _finish_problem(hier, fine, fine_full)
    if mesh is not None:
        from geometricmultigridpressuresolver_tpu.parallel import sharding

        # Canonical placement (replicates the tiny coarse direct-solve
        # arrays; per-level grids already match, so those puts are no-ops).
        problem = sharding.shard_problem(problem, mesh)
    return problem


def _finish_problem(
    hier: mg_mod.MGHierarchy, fine, fine_full: bool
) -> PoissonProblem:
    """Attach the finest-level CG operator to the hierarchy (host side).

    `fine` is the optional extra output of mg._device_hierarchy: None
    (share the finest MG level outright), an (ew0, ew1, ew2) triple (share
    solvable/band/diag/inv_diag -- bit-identical when only the edge-weight
    storage dtype differs -- saving ~10 B/cell of HBM), or a full
    LevelCoeffs (distinct MG precision).
    """
    if fine is None:
        fine_coeffs = hier.levels[0]
    elif fine_full:
        fine_coeffs = fine
    else:
        fine_coeffs = hier.levels[0]._replace(
            ew0=fine[0], ew1=fine[1], ew2=fine[2]
        )
    return PoissonProblem(fine=fine_coeffs, hier=hier)


def _solve_fn(
    problem: PoissonProblem, rhs, x0, config: SolverConfig, has_x0: bool,
    interrupt_check=None,
):
    fine = problem.fine
    solve_dtype = config.solve_dtype

    def apply_a(x):
        return stencil.apply_poisson(x, fine)

    if config.use_mg_preconditioner:
        def preconditioner(r):
            z = mg_mod.v_cycle(
                problem.hier,
                jnp.zeros_like(r, dtype=config.mg_dtype_resolved),
                r,
                config,
                use_initial_guess=False,
            )
            return z.astype(solve_dtype)
    else:
        def preconditioner(r):
            return fine.inv_diag * r

    return cg_mod.solve_pcg(
        apply_a,
        preconditioner,
        rhs.astype(solve_dtype),
        fine.solvable,
        x0=x0 if has_x0 else None,
        tolerance=config.tolerance,
        max_iterations=config.max_iterations,
        project_null_space=config.project_null_space,
        interrupt_check=interrupt_check,
        record_residuals=config.record_residuals,
    )


_SOLVE_STATICS = ("config", "has_x0", "interrupt_check")
_solve = functools.partial(jax.jit, static_argnames=_SOLVE_STATICS)(_solve_fn)
# Donating variant: the rhs and warm-start buffers are recycled for the CG
# residual/solution -- two full-window grids of device memory.  Opt-in because
# donated inputs are DELETED (benches that re-solve a fixed rhs must keep
# the default).
_solve_donated = functools.partial(
    jax.jit, static_argnames=_SOLVE_STATICS, donate_argnums=(1, 2)
)(_solve_fn)


def solve(
    problem: PoissonProblem,
    rhs: jax.Array,
    x0: jax.Array | None = None,
    config: SolverConfig | None = None,
    interrupt_check=None,
    donate: bool = False,
) -> cg_mod.CGResult:
    """MGPCG solve of the dimensionless Poisson system over solvable cells.

    Block-partitioned inputs (parallel.sharding) run under the GSPMD
    partitioner, which inserts the halo exchanges and reductions.

    `interrupt_check(iteration) -> bool` opts into cooperative
    cancellation (the reference's UT_Interrupt analogue): evaluated on the
    host once per CG iteration; True stops the solve after that iteration.
    Off by default -- the per-iteration host round trip stalls the device.
    The callable is a jit-STATIC argument: pass one
    long-lived function object, not a fresh lambda per call, or every
    call retraces and recompiles the whole solve program.
    """
    # Default resolved at CALL time (not import time), so late
    # jax_enable_x64 changes are honored by the default config.
    if config is None:
        config = SolverConfig()
    has_x0 = x0 is not None
    if x0 is None:
        x0 = jnp.zeros_like(rhs)
    impl = _solve_donated if donate else _solve
    return impl(problem, rhs, x0, config, has_x0, interrupt_check)

"""Solver configuration.

The reference hard-codes its knobs in C++ (damping 2/3 at
Source/HDK_GeometricMultigridOperators.h:291; boundary band width 3 and 3
boundary Jacobi iterations at Source/HDK_GeometricMultigridPoissonSolver.cpp:141-142;
ghost-fluid theta clamp 0.01 at
Source/HDK_GeometricFreeSurfacePressureSolver.cpp:854; CG tolerance 1e-5 and
2500 max iterations at Source/HDK_GeometricFreeSurfacePressureSolver.cpp:65-68)
and exposes the rest as Houdini node parameters.  Here everything is one
dataclass.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import jax
import jax.numpy as jnp


def _default_solve_dtype():
    """float64 like the reference when x64 is enabled, float32 otherwise.

    JAX silently truncates float64 requests without `jax_enable_x64` (off
    by default), so defaulting to float64 there would only produce
    truncation warnings; the resolved default is captured when the config
    object is created.
    """
    return jnp.float64 if jax.config.jax_enable_x64 else jnp.float32


@dataclasses.dataclass(frozen=True)
class SolverConfig:
    """Configuration for the MGPCG pressure solver.

    Attributes:
      solve_dtype: dtype of the outer CG iteration (reference: all-double,
        Source/HDK_GeometricMultigridPoissonSolver.h:14-15).
      mg_dtype: dtype of the V-cycle preconditioner.  Setting this to
        float32 while solve_dtype stays float64 is the mixed-precision mode
        the reference README names as future work (README.md:34-35).
      use_gauss_seidel: red/black Gauss-Seidel interior smoother when True,
        damped Jacobi otherwise (reference `useGaussSeidel`,
        Source/HDK_GeometricMultigridPoissonSolver.h:24).
      jacobi_damping: damped-Jacobi weight (reference 2/3,
        Source/HDK_GeometricMultigridOperators.h:291).
      boundary_width: BFS band width for extra boundary smoothing
        (reference myBoundarySmootherWidth = 3).
      boundary_iterations: damped-Jacobi passes over the band before/after
        each interior smooth (reference myBoundarySmootherIterations = 3).
      tolerance: relative residual tolerance (||r|| <= tol * ||b||).
      max_iterations: CG iteration cap.
      theta_clamp: lower clamp of the ghost-fluid theta
        (reference 0.01, Source/HDK_GeometricFreeSurfacePressureSolver.cpp:854).
      project_null_space: subtract the mean from the residual each iteration
        (all-Neumann / smoke case; reference `doProjectNullSpace`,
        Source/HDK_Utilities.h:197-297).
      use_old_pressure: warm-start CG from the previous pressure
        (reference `useOldPressure`, default on).
      use_mg_preconditioner: MG V-cycle preconditioner when True, inverse
        diagonal otherwise (reference `useMGPreconditioner`, default on).
      max_mg_levels: optional cap on the multigrid hierarchy depth.
      compact_domain: crop the multigrid domain to the aligned active
        bounding box after trimming far-field Dirichlet cells -- the same
        linear system as the reference's full-grid power-of-two expansion
        (Source/HDK_GeometricMultigridOperators.h:1341-1360) at a fraction
        of the cell count (the dense-grid answer to the reference's
        constant-tile compression).
      dirichlet_band: Dirichlet rings kept around the liquid when trimming.
    """

    solve_dtype: Any = dataclasses.field(default_factory=_default_solve_dtype)
    mg_dtype: Any = None  # defaults to solve_dtype
    use_gauss_seidel: bool = True
    # Optional interior-smoother override: None derives from
    # use_gauss_seidel; "chebyshev" uses the polynomial smoother
    # (ops.stencil.chebyshev_smooth) of `chebyshev_degree`.
    interior_smoother: str | None = None
    chebyshev_degree: int = 2
    jacobi_damping: float = 2.0 / 3.0
    boundary_width: int = 3
    boundary_iterations: int = 3
    tolerance: float = 1e-5
    max_iterations: int = 2500
    theta_clamp: float = 0.01
    project_null_space: bool = False
    use_old_pressure: bool = True
    use_mg_preconditioner: bool = True
    max_mg_levels: int | None = None
    compact_domain: bool = True
    dirichlet_band: int = 4
    coarse_dof_target: int = 3000
    # Storage dtype of the V-cycle's off-diagonal edge weights (None keeps
    # the mg dtype).  bfloat16 halves the largest coefficient arrays' HBM
    # traffic; unit weights (all faces away from the irregular boundary)
    # are exact in bfloat16, and quantizing the off-diagonal symmetrically
    # preserves operator symmetry exactly, so the V-cycle remains a valid
    # CG preconditioner.  The outer CG operator always stays in solve_dtype.
    mg_ew_dtype: Any = None
    # Transfer operators: "slice" is the shift-based stencil form; "mm"
    # runs restriction/prolongation as per-axis matmuls (exactly adjoint
    # by construction: the prolongation uses the transposed restriction
    # matrix).  Same operator, different rounding.
    transfer_mode: str = "slice"
    # Extra window headroom (units of the exterior padding) so a growing
    # liquid bbox keeps fitting the previous frame's window shape; see
    # free_surface.build_setup(reuse_from=...).
    window_slack: int = 1
    # Device-program granularity of setup (build_setup / build_problem).
    # "fused": window expansion + every hierarchy level + the fine CG
    # operator compile as ONE program -- fewest compiles and dispatches,
    # but its workspace holds every hierarchy intermediate in one live
    # range.  "per-level": one program per hierarchy level (plus the
    # expansion), so only one level's workspace is live at a time.
    # "auto" (default): fused when its compiled workspace fits the
    # device's free memory, per-level otherwise (mg.setup_fusion_resolved).
    setup_fusion: str = "auto"
    # Advection scheme for the simulation driver (models/simulate):
    # "semi_lagrangian" is the reference-flavored backtrace (trilinear
    # map_coordinates, 8 arbitrary-index gathers per field).  "upwind" is
    # a stencil scheme (same formal order, shift/select arithmetic, no
    # gathers) with `advect_substeps` sub-Euler steps keeping CFL <= 1 per
    # substep.
    advection: str = "semi_lagrangian"
    advect_substeps: int = 4
    # Record the relative residual of EVERY CG iteration into
    # CGResult.residual_history (a fixed (max_iterations + 1,) buffer;
    # entries past the exit iteration stay NaN).  The reference prints
    # this trace per iteration (Source/HDK_GeometricCGPoissonSolver.h:159);
    # here it is an opt-in device buffer so the production while-loop solve
    # keeps convergence forensics without per-iteration host traffic.
    record_residuals: bool = False

    def __post_init__(self):
        # Every string-mode knob is compared with `==`/`!=` at use sites;
        # validating here turns a typo ("per_level", "mmm") into an
        # immediate error instead of a silently-selected default path.
        allowed = {
            "transfer_mode": ("slice", "mm"),
            "setup_fusion": ("auto", "fused", "per-level"),
            "interior_smoother": (None, "chebyshev"),
            "advection": ("semi_lagrangian", "upwind"),
        }
        for name, values in allowed.items():
            value = getattr(self, name)
            if value not in values:
                raise ValueError(
                    f"config.{name}={value!r}; expected one of {values}"
                )

    @property
    def mg_dtype_resolved(self):
        return self.solve_dtype if self.mg_dtype is None else self.mg_dtype

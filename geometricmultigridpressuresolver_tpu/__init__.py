"""Geometric multigrid pressure-Poisson framework in JAX.

A from-scratch JAX/XLA re-design of the capabilities of
rgoldade/GeometricMultigridPressureSolver (McAdams et al. 2010 multigrid
preconditioned conjugate gradient for free-surface liquid pressure
projection).  The reference is a Houdini HDK C++ plug-in over tiled sparse
voxel grids with TBB threading; this framework instead uses dense
device-resident voxel grids masked by cell labels, XLA-fused stencils,
and `jax.sharding` SPMD for multi-device scaling.

Layer map (mirrors reference SURVEY.md section 1):
  L1  utils/, grids.py      -- labels, masks, ghost-fluid weights
  L2  ops/                  -- multigrid operator library (stencils, transfer,
                               grid BLAS), the numerical core
  L3  solver/               -- V-cycle engine + matrix-free PCG driver
  L4  models/               -- free-surface pressure projection pipelines
      parallel/             -- device-mesh sharding (new vs reference)
"""

from geometricmultigridpressuresolver_tpu.grids import CellLabel, MaterialLabel
from geometricmultigridpressuresolver_tpu.config import SolverConfig

__version__ = "0.1.0"

__all__ = ["CellLabel", "MaterialLabel", "SolverConfig", "__version__"]


def __getattr__(name):
    # Lazy subsystem access (keeps bare import light for CLI/tools):
    # gmg.free_surface, gmg.mgpcg, gmg.simulate, gmg.diagnostics, gmg.io ...
    import importlib

    lazy = {
        "free_surface": "geometricmultigridpressuresolver_tpu.models.free_surface",
        "simulate": "geometricmultigridpressuresolver_tpu.models.simulate",
        "assembled": "geometricmultigridpressuresolver_tpu.models.assembled",
        "sdf": "geometricmultigridpressuresolver_tpu.models.sdf",
        "mgpcg": "geometricmultigridpressuresolver_tpu.solver.mgpcg",
        "diagnostics": "geometricmultigridpressuresolver_tpu.diagnostics",
        "io": "geometricmultigridpressuresolver_tpu.io",
        "parallel": "geometricmultigridpressuresolver_tpu.parallel",
        "profiling": "geometricmultigridpressuresolver_tpu.utils.profiling",
    }
    if name in lazy:
        return importlib.import_module(lazy[name])
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")

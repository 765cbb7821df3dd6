"""Multigrid operator library (numerical core, layer L2).

Host-side (numpy) domain construction lives in `domain`; device-side (JAX)
stencils, transfer operators, and grid BLAS live in `stencil`, `transfer`,
and `blas`.
"""

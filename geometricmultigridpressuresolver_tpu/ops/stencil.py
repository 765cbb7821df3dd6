"""Device-side Poisson stencil operators (JAX).

Vectorized, label-masked equivalents of the reference's per-cell operator
loops (Source/HDK_GeometricMultigridOperators.h:177-732):

  * apply_poisson      -> applyPoissonMatrix (h:621-714)
  * residual           -> computePoissonResidual (h:716-732)
  * jacobi_smooth      -> jacobiPoissonSmoother (h:262-367), damping 2/3
  * boundary_jacobi    -> boundaryJacobiPoissonSmoother (h:524-619), the
                          explicit cell list becomes a dense band mask
  * rb_gauss_seidel    -> tiledGaussSeidelPoissonSmoother (h:369-520).  The
                          reference colors 16^3 tiles by parity and sweeps
                          serially inside each tile -- hostile to a vector
                          machine.  We use cell-level red/black coloring
                          instead: each color pass is a parallel exact
                          Gauss-Seidel half-sweep, and running red->black on
                          the V-cycle downstroke and black->red on the
                          upstroke keeps the preconditioner symmetric (the
                          adjoint-ordering requirement validated by the
                          symmetry suite, Source/HDK_TestGeometricMultigrid.cpp:1167-1876).

All stencil coefficients are precomputed per level (see
`ops.domain.build_level_coefficients`), so every operator is a pure 7-point
stencil with static coefficient grids: memory-bandwidth-bound, fully
fusible by XLA.

The operator is the dimensionless Poisson matrix (dx factored out, interior
diagonal 6).  Fields are maintained identically zero outside the solvable
set, mirroring the reference's active-set discipline.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp


class LevelCoeffs(NamedTuple):
    """Static per-level stencil coefficients (a pytree of device arrays).

    ew0/ew1/ew2 are per-axis off-diagonal edge weights stored CELL-shaped:
    entry i along the axis is the weight of the face between cell i and cell
    i+1, nonzero only when both cells are solvable (the final entry is the
    domain-edge face, always 0).  diag/inv_diag are zero on non-solvable
    cells, so operators are implicitly masked.  Every array shares the cell
    grid shape, which keeps SPMD sharding uniform.
    """

    solvable: jax.Array  # bool  (nx, ny, nz)
    band: jax.Array      # int8 (0/1) or bool (nx, ny, nz); int8 on the
    #                      device path (one byte per cell)
    diag: jax.Array      # float (nx, ny, nz)
    inv_diag: jax.Array  # float (nx, ny, nz)
    ew0: jax.Array       # float (nx, ny, nz)
    ew1: jax.Array       # float (nx, ny, nz)
    ew2: jax.Array       # float (nx, ny, nz)

    @classmethod
    def from_host(cls, coeffs: dict, dtype) -> "LevelCoeffs":
        ew = coeffs["ew"]
        return cls(
            solvable=jnp.asarray(coeffs["solvable"]),
            band=jnp.asarray(coeffs["band"]),
            diag=jnp.asarray(coeffs["diag"], dtype=dtype),
            inv_diag=jnp.asarray(coeffs["inv_diag"], dtype=dtype),
            ew0=jnp.asarray(ew[0], dtype=dtype),
            ew1=jnp.asarray(ew[1], dtype=dtype),
            ew2=jnp.asarray(ew[2], dtype=dtype),
        )

    @property
    def shape(self):
        return self.diag.shape

    def astype(self, dtype) -> "LevelCoeffs":
        return LevelCoeffs(
            self.solvable,
            self.band,
            self.diag.astype(dtype),
            self.inv_diag.astype(dtype),
            self.ew0.astype(dtype),
            self.ew1.astype(dtype),
            self.ew2.astype(dtype),
        )


def _shift_m(x: jax.Array, axis: int) -> jax.Array:
    """out[i] = x[i-1] along `axis`, zero at i = 0."""
    pad = [(0, 0)] * x.ndim
    pad[axis] = (1, 0)
    sl = [slice(None)] * x.ndim
    sl[axis] = slice(0, -1)
    return jnp.pad(x, pad)[tuple(sl)]


def _shift_p(x: jax.Array, axis: int) -> jax.Array:
    """out[i] = x[i+1] along `axis`, zero at i = n-1."""
    pad = [(0, 0)] * x.ndim
    pad[axis] = (0, 1)
    sl = [slice(None)] * x.ndim
    sl[axis] = slice(1, None)
    return jnp.pad(x, pad)[tuple(sl)]


def neighbor_sum(x: jax.Array, c: LevelCoeffs) -> jax.Array:
    """Off-diagonal part of the stencil: sum over faces of w_f * x_neighbor.

    With cell-shaped upper-face weights e (e[i] = weight of the face between
    cells i and i+1): S[i] = e[i] * x[i+1] + e[i-1] * x[i-1]
                           = (e * x+)[i] + shift_m(e * x)[i].
    """
    out = jnp.zeros_like(x)
    for axis, ew in enumerate((c.ew0, c.ew1, c.ew2)):
        out = out + ew * _shift_p(x, axis)
        out = out + _shift_m(ew * x, axis)
    return out


def apply_poisson(x: jax.Array, c: LevelCoeffs) -> jax.Array:
    """y = A x over the solvable set (zero elsewhere).

    Reference applyPoissonMatrix
    (Source/HDK_GeometricMultigridOperators.h:621-714).
    """
    return c.diag * x - neighbor_sum(x, c)


def residual(x: jax.Array, b: jax.Array, c: LevelCoeffs) -> jax.Array:
    """r = b - A x, masked to the solvable set.

    Reference computePoissonResidual
    (Source/HDK_GeometricMultigridOperators.h:716-732).
    """
    r = b - apply_poisson(x, c)
    return jnp.where(c.solvable, r, jnp.zeros_like(r))


def jacobi_smooth(
    x: jax.Array, b: jax.Array, c: LevelCoeffs, damping: float = 2.0 / 3.0
) -> jax.Array:
    """One damped Jacobi pass: x += damping * (b - A x) / diag.

    inv_diag is zero outside the solvable set, so exterior/Dirichlet cells
    are untouched.  Reference jacobiPoissonSmoother
    (Source/HDK_GeometricMultigridOperators.h:262-367).
    """
    dtype = x.dtype
    return x + dtype.type(damping) * c.inv_diag * (b - apply_poisson(x, c))


def boundary_jacobi(
    x: jax.Array, b: jax.Array, c: LevelCoeffs, damping: float = 2.0 / 3.0
) -> jax.Array:
    """One damped Jacobi pass restricted to the boundary band.

    Reference boundaryJacobiPoissonSmoother
    (Source/HDK_GeometricMultigridOperators.h:524-619): all band cells read
    pre-update values (two-pass list semantics), which a masked simultaneous
    update reproduces exactly.
    """
    dtype = x.dtype
    update = x + dtype.type(damping) * c.inv_diag * (b - apply_poisson(x, c))
    return jnp.where(c.band.astype(bool), update, x)


def color_mask(shape, color: int) -> jax.Array:
    """Checkerboard mask: cells with (i + j + k) % 2 == color."""
    i = jax.lax.broadcasted_iota(jnp.int32, shape, 0)
    j = jax.lax.broadcasted_iota(jnp.int32, shape, 1)
    k = jax.lax.broadcasted_iota(jnp.int32, shape, 2)
    return (i + j + k) % 2 == color


def rb_gauss_seidel_color(
    x: jax.Array, b: jax.Array, c: LevelCoeffs, color: int
) -> jax.Array:
    """One undamped Gauss-Seidel half-sweep over cells of one checkerboard color.

    Within a color, no two updated cells are stencil neighbors, so the
    simultaneous update is an exact Gauss-Seidel sub-sweep.
    """
    update = x + c.inv_diag * (b - apply_poisson(x, c))
    return jnp.where(color_mask(x.shape, color), update, x)


def rb_gauss_seidel(
    x: jax.Array, b: jax.Array, c: LevelCoeffs, forward: bool
) -> jax.Array:
    """Full red/black Gauss-Seidel sweep.

    forward=True (downstroke): red then black; forward=False (upstroke):
    black then red -- the adjoint ordering the reference realizes with
    odd/even tile order + in-tile sweep direction
    (Source/HDK_GeometricMultigridPoissonSolver.cpp:466-479 vs 740-751).
    """
    order = (0, 1) if forward else (1, 0)
    for color in order:
        x = rb_gauss_seidel_color(x, b, c, color)
    return x


def chebyshev_smooth(
    x: jax.Array,
    b: jax.Array,
    c: LevelCoeffs,
    degree: int = 2,
    lambda_max: float | jax.Array | None = None,
    smoothing_ratio: float = 4.0,
) -> jax.Array:
    """Chebyshev polynomial smoother of the given degree.

    An optional alternative to the reference's smoothers (an extra beyond
    the reference, informed by the polynomial-smoother literature in
    PAPERS.md): x' = x + p(A) r with Chebyshev coefficients targeting the
    upper part of the spectrum [lambda_max / smoothing_ratio, lambda_max].

    `lambda_max=None` (default) computes the Gershgorin bound from the
    level itself: max over solvable cells of diag + off-diagonal row sum.
    For a unit-weight interior this is the classic 12 (diagonal 6 plus
    off-diagonal 6), but ghost-fluid theta-clamped boundary rows carry
    diagonals up to weight/theta_clamp -- a fixed bound of 12 lets the
    polynomial AMPLIFY those modes (measured: divergence on free-surface
    domains at degree 3).  The bound is a cheap device reduction and keeps
    the smoother a fixed polynomial in A for a fixed level, so it stays
    self-adjoint in the A-inner product automatically -- the V-cycle
    remains a symmetric preconditioner WITHOUT the adjoint sweep-ordering
    bookkeeping Gauss-Seidel requires.
    """
    dtype = x.dtype
    if lambda_max is None:
        ones = jnp.ones_like(c.diag)
        row = c.diag + neighbor_sum(ones, c)
        lambda_max = jnp.max(jnp.where(c.solvable, row, 0.0))
    lambda_max = jnp.asarray(lambda_max, dtype=dtype)
    lambda_min = lambda_max / dtype.type(smoothing_ratio)
    theta = 0.5 * (lambda_max + lambda_min)
    delta = 0.5 * (lambda_max - lambda_min)
    sigma = theta / delta

    r = residual(x, b, c)
    d = (1.0 / theta).astype(dtype) * r
    x = x + d
    rho = 1.0 / sigma
    for _ in range(1, degree):
        rho_new = 1.0 / (2.0 * sigma - rho)
        r = residual(x, b, c)
        d = (rho_new * rho).astype(dtype) * d + (
            2.0 * rho_new / delta
        ).astype(dtype) * r
        x = x + d
        rho = rho_new
    return x

"""Inter-level transfer operators: restriction and prolongation (JAX).

Reference: downsample (full-weighting, separable 1D weights
[1/8, 3/8, 3/8, 1/8] over a 4^3 fine window centered at 2*cell - 1,
Source/HDK_GeometricMultigridOperators.h:734-835) and upsampleAndAdd
(trilinear interpolation at samplePoint = (cell + 0.5)/2 - 0.5 scaled by 4,
h:873-972).  The 4x accounts for the factored-out dx^2 between levels; the
interpolation weights are kept hand-rolled/symmetric exactly like the
reference's custom lerp (h:837-871): per axis, prolongation is 2x the
transpose of restriction, so the pair stays adjoint to machine precision.

Both operators assume fields are identically zero outside the solvable set
(the reference asserts this in debug builds) and mask their output to the
destination level's solvable set.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

# Separable full-weighting restriction stencil.
_R_WEIGHTS = (1.0 / 8.0, 3.0 / 8.0, 3.0 / 8.0, 1.0 / 8.0)


@functools.lru_cache(maxsize=None)
def _restrict_matrix_np(n_fine: int, n_coarse: int) -> np.ndarray:
    """(n_fine, n_coarse) separable restriction matrix R.

    R[2c-1+k, c] = _R_WEIGHTS[k].  Prolongation along the axis is 2 * R^T
    (the pair P = 4 * R^T over three axes), so using the same matrix
    transposed keeps the pair adjoint EXACTLY by construction.
    """
    m = np.zeros((n_fine, n_coarse), dtype=np.float64)
    for c in range(n_fine // 2):
        for k, w in enumerate(_R_WEIGHTS):
            f = 2 * c - 1 + k
            if 0 <= f < n_fine:
                m[f, c] = w
    return m


def _axis_matmul(x: jax.Array, m: jax.Array, axis: int) -> jax.Array:
    """Contract `axis` of x with the first dim of m.

    HIGHEST precision: a float32 contraction may otherwise run in TF32,
    which keeps about three decimal digits.
    """
    out = jnp.tensordot(
        x, m, axes=([axis], [0]), precision=jax.lax.Precision.HIGHEST
    )
    # tensordot moves the contracted axis to the end; rotate it back.
    return jnp.moveaxis(out, -1, axis)


def restrict_mm(fine: jax.Array, coarse_solvable: jax.Array) -> jax.Array:
    """Full-weighting restriction as three per-axis matmuls.

    Numerically the same operator as `restrict` (different rounding), with
    the contractions as matrix products.  Masked to the coarse solvable set.
    """
    out = fine
    for axis in range(3):
        m = jnp.asarray(
            _restrict_matrix_np(fine.shape[axis], coarse_solvable.shape[axis]),
            dtype=fine.dtype,
        )
        out = _axis_matmul(out, m, axis)
    return jnp.where(coarse_solvable, out, jnp.zeros_like(out))


def prolong_add_mm(
    fine_x: jax.Array, coarse_x: jax.Array, fine_solvable: jax.Array
) -> jax.Array:
    """fine_x += 4 * trilerp(coarse_x) via the transposed restriction
    matrices (x2 per axis), exactly adjoint to `restrict_mm`."""
    up = coarse_x
    for axis in range(3):
        m2t = jnp.asarray(
            2.0
            * _restrict_matrix_np(fine_x.shape[axis], coarse_x.shape[axis]).T,
            dtype=coarse_x.dtype,
        )
        up = _axis_matmul(up, m2t, axis)
    up = up.dtype.type(4.0) * up
    return jnp.where(fine_solvable, fine_x + up, fine_x)


def _restrict_axis(x: jax.Array, axis: int) -> jax.Array:
    """1D full-weighting along `axis`: y[c] = sum_k w[k] * x[2c - 1 + k]."""
    n = x.shape[axis]
    pad = [(0, 0)] * x.ndim
    pad[axis] = (1, 1)
    xp = jnp.pad(x, pad)

    def sl(start):
        s = [slice(None)] * x.ndim
        s[axis] = slice(start, start + n - 1, 2)
        return xp[tuple(s)]

    w = _R_WEIGHTS
    dtype = x.dtype
    return (
        dtype.type(w[0]) * sl(0)
        + dtype.type(w[1]) * sl(1)
        + dtype.type(w[2]) * sl(2)
        + dtype.type(w[3]) * sl(3)
    )


def restrict(fine: jax.Array, coarse_solvable: jax.Array) -> jax.Array:
    """Full-weighting restriction, masked to the coarse solvable set."""
    out = fine
    for axis in range(3):
        out = _restrict_axis(out, axis)
    return jnp.where(coarse_solvable, out, jnp.zeros_like(out))


def _prolong_axis(x: jax.Array, axis: int) -> jax.Array:
    """1D linear upsampling along `axis` (2x the restriction transpose).

    out[2c]   = 0.25 * x[c-1] + 0.75 * x[c]
    out[2c+1] = 0.75 * x[c]   + 0.25 * x[c+1]
    """
    c = x.shape[axis]
    pad = [(0, 0)] * x.ndim
    pad[axis] = (1, 1)
    xp = jnp.pad(x, pad)

    def sl(start):
        s = [slice(None)] * x.ndim
        s[axis] = slice(start, start + c)
        return xp[tuple(s)]

    dtype = x.dtype
    q, t = dtype.type(0.25), dtype.type(0.75)
    even = q * sl(0) + t * sl(1)
    odd = t * sl(1) + q * sl(2)
    stacked = jnp.stack((even, odd), axis=axis + 1)
    new_shape = list(x.shape)
    new_shape[axis] = 2 * c
    return stacked.reshape(new_shape)


def prolong(coarse: jax.Array) -> jax.Array:
    """Trilinear interpolation of a coarse field onto the fine grid, scaled 4x."""
    out = coarse
    for axis in range(3):
        out = _prolong_axis(out, axis)
    return out.dtype.type(4.0) * out


def prolong_add(
    fine_x: jax.Array, coarse_x: jax.Array, fine_solvable: jax.Array
) -> jax.Array:
    """fine_x += 4 * trilerp(coarse_x), masked to the fine solvable set."""
    up = prolong(coarse_x)
    return jnp.where(fine_solvable, fine_x + up, fine_x)

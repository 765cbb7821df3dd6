"""Plain NumPy float64 reference of the V-cycle's operators.

Written from the reference's per-cell formulas
(Source/HDK_GeometricMultigridOperators.h:262-972) with explicit slices,
independently of the JAX operators in `stencil` and `transfer`, so the two
can check each other: the CPU tests compare them at small sizes, and
`chip_smoke.py` compares the device's float32 results with these at full
width.  Any faster smoother must match `smooth_block` to rounding.

Coefficients come as a `HostLevel` (float64 copies of one level's
`stencil.LevelCoeffs`); fields are float64 cell grids that are zero outside
the solvable set.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np


class HostLevel(NamedTuple):
    solvable: np.ndarray  # bool
    band: np.ndarray      # bool
    diag: np.ndarray
    inv_diag: np.ndarray
    ew: tuple             # three cell-shaped upper-face weights


def host_level(c) -> HostLevel:
    """float64 host copy of a `stencil.LevelCoeffs` (narrow storage such
    as bfloat16 edge weights upcasts exactly)."""
    f64 = lambda a: np.asarray(a).astype(np.float64)  # noqa: E731
    return HostLevel(
        solvable=np.asarray(c.solvable).astype(bool),
        band=np.asarray(c.band).astype(bool),
        diag=f64(c.diag),
        inv_diag=f64(c.inv_diag),
        ew=(f64(c.ew0), f64(c.ew1), f64(c.ew2)),
    )


def _axis_slices(axis: int):
    lo = [slice(None)] * 3
    hi = [slice(None)] * 3
    lo[axis] = slice(0, -1)
    hi[axis] = slice(1, None)
    return tuple(lo), tuple(hi)


def apply_poisson(x: np.ndarray, c: HostLevel) -> np.ndarray:
    """y = A x: diag * x minus w_f * x_neighbor over every interior face
    (w_f of the face between i and i+1 is ew[axis][i])."""
    y = c.diag * x
    for axis in range(3):
        lo, hi = _axis_slices(axis)
        w = c.ew[axis][lo]
        y[lo] -= w * x[hi]
        y[hi] -= w * x[lo]
    return y


def residual(x: np.ndarray, b: np.ndarray, c: HostLevel) -> np.ndarray:
    return np.where(c.solvable, b - apply_poisson(x, c), 0.0)


def relative_residual(x: np.ndarray, b: np.ndarray, c: HostLevel) -> float:
    """||b - A x|| / ||b|| over the solvable set."""
    r = residual(x, b, c)
    bn = np.linalg.norm(np.where(c.solvable, b, 0.0))
    return float(np.linalg.norm(r) / bn) if bn else 0.0


def _jacobi_update(x, b, c, weight):
    return x + weight * c.inv_diag * (b - apply_poisson(x, c))


def smooth_block(
    x: np.ndarray,
    b: np.ndarray,
    c: HostLevel,
    forward: bool,
    use_gauss_seidel: bool = True,
    damping: float = 2.0 / 3.0,
    boundary_iterations: int = 3,
) -> np.ndarray:
    """One smoothing block: `boundary_iterations` damped-Jacobi passes over
    the band, an interior sweep, the same band passes again.

    The interior sweep is red/black Gauss-Seidel (red then black forward,
    black then red backward: the adjoint ordering of the upstroke) or one
    damped-Jacobi pass.  Reference applyVCycle
    (Source/HDK_GeometricMultigridPoissonSolver.cpp:445-513, 715-783).
    """
    i, j, k = np.indices(x.shape)
    parity = (i + j + k) % 2

    def band_passes(x):
        for _ in range(boundary_iterations):
            x = np.where(c.band, _jacobi_update(x, b, c, damping), x)
        return x

    x = band_passes(np.array(x, dtype=np.float64))
    if use_gauss_seidel:
        for color in ((0, 1) if forward else (1, 0)):
            x = np.where(parity == color, _jacobi_update(x, b, c, 1.0), x)
    else:
        x = _jacobi_update(x, b, c, damping)
    return band_passes(x)


_R = (1.0 / 8.0, 3.0 / 8.0, 3.0 / 8.0, 1.0 / 8.0)


def _restrict_axis(x: np.ndarray, axis: int) -> np.ndarray:
    """y[c] = sum_k _R[k] * x[2c - 1 + k] (zero outside the grid)."""
    xm = np.moveaxis(x, axis, 0)
    n = xm.shape[0]
    padded = np.zeros((n + 2,) + xm.shape[1:])
    padded[1:-1] = xm
    y = sum(w * padded[k : k + n : 2] for k, w in enumerate(_R))
    return np.moveaxis(y, 0, axis)


def restrict(fine: np.ndarray, coarse_solvable: np.ndarray) -> np.ndarray:
    """Full-weighting restriction, masked to the coarse solvable set."""
    out = fine
    for axis in range(3):
        out = _restrict_axis(out, axis)
    return np.where(coarse_solvable, out, 0.0)


def _prolong_axis(x: np.ndarray, axis: int) -> np.ndarray:
    """out[2c] = x[c-1]/4 + 3x[c]/4, out[2c+1] = 3x[c]/4 + x[c+1]/4."""
    xm = np.moveaxis(x, axis, 0)
    n = xm.shape[0]
    padded = np.zeros((n + 2,) + xm.shape[1:])
    padded[1:-1] = xm
    out = np.empty((2 * n,) + xm.shape[1:])
    out[0::2] = 0.25 * padded[:-2] + 0.75 * padded[1:-1]
    out[1::2] = 0.75 * padded[1:-1] + 0.25 * padded[2:]
    return np.moveaxis(out, 0, axis)


def prolong_add(
    fine_x: np.ndarray, coarse_x: np.ndarray, fine_solvable: np.ndarray
) -> np.ndarray:
    """fine_x + 4 * trilinear(coarse_x), masked to the fine solvable set."""
    up = coarse_x
    for axis in range(3):
        up = _prolong_axis(up, axis)
    return np.where(fine_solvable, fine_x + 4.0 * up, fine_x)

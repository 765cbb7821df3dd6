"""Multigrid domain construction (functional; numpy or JAX).

The setup phase that runs once per label set: domain expansion, level
coarsening, boundary relabeling, boundary-band construction, and per-level
stencil-coefficient precomputation.  The reference does all of this with
tile-parallel C++ loops over Houdini voxel arrays; here the same label
semantics are expressed as *functional* array ops that run identically on
host numpy (tests, oracles) or on the device under `jit` (production setup
-- the grids may be 512^3, so the setup pipeline itself is
device-resident).

Reference equivalents:
  * expand_domain        -> buildExpandedCellLabels
                            (Source/HDK_GeometricMultigridOperators.h:1328-1456)
  * expand_face_weights  -> buildExpandedBoundaryWeights
                            (Source/HDK_GeometricMultigridOperators.h:1458-1572)
  * set_boundary_labels  -> setBoundaryCellLabels
                            (Source/HDK_GeometricMultigridOperators.h:1574-1644)
  * coarsen_labels       -> buildCoarseCellLabels
                            (Source/HDK_GeometricMultigridOperators.cpp:23-163)
  * boundary_band        -> buildBoundaryCells
                            (Source/HDK_GeometricMultigridOperators.cpp:165-469),
                            but as a dense mask instead of a sorted cell list
  * check_* invariants   -> unitTestCoarsening / unitTestBoundaryCells /
                            unitTestExteriorCells
                            (Source/HDK_GeometricMultigridOperators.cpp:471-632,
                             Source/HDK_GeometricMultigridOperators.h:1771-1870)
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np

try:  # jnp optional: every function also works on plain numpy
    import jax
    import jax.numpy as jnp
except ImportError:  # pragma: no cover
    jax = None
    jnp = None

from geometricmultigridpressuresolver_tpu.grids import (
    LABEL_DTYPE,
    CellLabel,
    face_shape,
    is_solvable,
)

EXT = int(CellLabel.EXTERIOR)
DIR = int(CellLabel.DIRICHLET)
INT = int(CellLabel.INTERIOR)
BND = int(CellLabel.BOUNDARY)


def _xp(arr):
    """Array-module dispatch: jax.numpy for device/traced arrays, else numpy."""
    if jnp is not None and isinstance(arr, (jax.Array, jax.core.Tracer)):
        return jnp
    return np


def _neighbor(arr, axis: int, direction: int, fill):
    """Face-neighbor values: direction 0 -> arr[i-1], 1 -> arr[i+1], `fill`
    outside the grid."""
    xp = _xp(arr)
    n = arr.shape[axis]
    pad = [(0, 0)] * arr.ndim
    sl = [slice(None)] * arr.ndim
    if direction == 0:
        pad[axis] = (1, 0)
        sl[axis] = slice(0, n)
    else:
        pad[axis] = (0, 1)
        sl[axis] = slice(1, n + 1)
    return xp.pad(arr, pad, constant_values=fill)[tuple(sl)]


def _cell_faces(w, axis: int):
    """(lower, upper) face values of each cell from a face array."""
    lo = [slice(None)] * w.ndim
    hi = [slice(None)] * w.ndim
    lo[axis] = slice(0, -1)
    hi[axis] = slice(1, None)
    return w[tuple(lo)], w[tuple(hi)]


def next_pow2(n: int) -> int:
    return 1 << max(0, math.ceil(math.log2(n))) if n > 1 else 1


def expansion_params(base_shape: Sequence[int]) -> tuple[int, int, tuple[int, int, int]]:
    """Multigrid level count, exterior padding, and expanded grid shape.

    mg_levels = ceil(log2(min dim)) - 1 (caps the hierarchy at 4 voxels in
    the smallest dimension); padding = 2**(mg_levels-1) exterior cells per
    side so every coarse level keeps >= 1 exterior ring; each axis is then
    rounded up to a power of two.
    Reference: Source/HDK_GeometricMultigridOperators.h:1341-1360.
    """
    min_dim = min(base_shape)
    if min_dim < 4:
        raise ValueError(f"grid too small for multigrid: {base_shape}")
    mg_levels = math.ceil(math.log2(min_dim)) - 1
    padding = 2 ** (mg_levels - 1)
    expanded = tuple(next_pow2(s + 2 * padding) for s in base_shape)
    return mg_levels, padding, expanded


def expand_domain(base_labels) -> tuple[object, tuple[int, int, int], int]:
    """Embed base labels into the padded power-of-two multigrid domain.

    Non-exterior base cells are copied at offset `padding`; everything else
    is EXTERIOR.  Returns (expanded_labels, offset, mg_levels).
    """
    xp = _xp(base_labels)
    mg_levels, padding, expanded_shape = expansion_params(base_labels.shape)
    base = xp.where(base_labels == BND, INT, base_labels).astype(LABEL_DTYPE)
    pad = [
        (padding, expanded_shape[a] - padding - base_labels.shape[a])
        for a in range(3)
    ]
    expanded = xp.pad(base, pad, constant_values=EXT)
    return expanded, (padding, padding, padding), mg_levels


def dilate(mask, rings: int):
    """Face-neighbor dilation of a boolean mask, `rings` layers."""
    for _ in range(rings):
        grown = mask
        for axis in range(3):
            for direction in (0, 1):
                grown = grown | _neighbor(mask, axis, direction, False)
        mask = grown
    return mask


def trim_far_dirichlet(labels, keep_rings: int = 4):
    """Relabel DIRICHLET cells farther than `keep_rings` from any solvable
    cell as EXTERIOR.

    The Poisson system only sees Dirichlet cells through faces incident to
    solvable cells, so trimming the far field leaves the matrix and RHS
    bit-identical while shrinking the active bounding box dramatically
    (e.g. the air above a pool).  This plays the role of the reference's
    constant-tile compression of far-field regions (SURVEY.md section 2.1).
    """
    xp = _xp(labels)
    near = dilate(is_solvable(labels), keep_rings)
    return xp.where((labels == DIR) & ~near, EXT, labels).astype(LABEL_DTYPE)


def compact_expansion_params(
    non_ext_proj: Sequence[np.ndarray],
    non_ext_count: int | None = None,
    coarse_dof_target: int = 3000,
) -> tuple[int, int, tuple[tuple[int, int], ...], tuple[int, int, int]]:
    """Compact-domain geometry from per-axis occupancy projections.

    `non_ext_proj[a]` is the 1-D boolean projection (any over the other two
    axes) of non-EXTERIOR cells along axis a.  Returns
    (mg_levels, padding, bbox, expanded_shape) where bbox[a] = (lo, hi) is
    the half-open active range per axis.

    Two departures from the reference's expansion (power-of-two rounding of
    the full grid with depth ceil(log2(min))-1,
    Source/HDK_GeometricMultigridOperators.h:1341-1360), both exact:

      * the domain crops to the active bounding box, and each axis length
        only needs to be a multiple of 2**(mg_levels-1) (even extents plus
        one exterior ring at every level is all the hierarchy needs);
      * the depth is the SMALLEST L whose estimated coarsest-level DOF
        count (non_ext_count / 8**(L-1)) fits the dense direct solve.
        The coarsest level is solved exactly either way, so a shallower
        hierarchy preconditions just as well while cutting the exterior
        padding from 2**(Lref-1) to 2**(L-1) cells per side -- a large
        fraction of all cells at 256^3+.
    """
    bbox = []
    for proj in non_ext_proj:
        idx = np.flatnonzero(np.asarray(proj))
        if idx.size == 0:
            raise ValueError("domain has no non-exterior cells")
        bbox.append((int(idx[0]), int(idx[-1]) + 1))
    extents = [hi - lo for lo, hi in bbox]
    min_dim = min(extents)

    max_levels = 2 if min_dim < 4 else max(2, math.ceil(math.log2(min_dim)) - 1)
    if non_ext_count is None:
        mg_levels = max_levels
    else:
        mg_levels = max_levels
        for level in range(2, max_levels + 1):
            if non_ext_count / 8 ** (level - 1) <= coarse_dof_target:
                mg_levels = level
                break

    padding = 2 ** (mg_levels - 1)
    expanded = tuple(
        ((e + 2 * padding + padding - 1) // padding) * padding for e in extents
    )
    return mg_levels, padding, tuple(bbox), expanded


def expand_face_weights(
    base_weights: Sequence, expanded_shape: Sequence[int], offset: Sequence[int]
) -> list:
    """Copy per-axis face weights into the expanded index space (zero elsewhere).

    Weights exist only at the finest level.
    Reference: Source/HDK_GeometricMultigridOperators.h:1458-1572.
    """
    out = []
    for axis in range(3):
        w = base_weights[axis]
        xp = _xp(w)
        target = face_shape(expanded_shape, axis)
        pad = [(offset[a], target[a] - offset[a] - w.shape[a]) for a in range(3)]
        out.append(xp.pad(w, pad, constant_values=0.0))
    return out


def set_boundary_labels(labels, face_weights: Sequence | None):
    """Relabel INTERIOR -> BOUNDARY next to Dirichlet/exterior cells or
    non-unit incident face weights.

    Reference: Source/HDK_GeometricMultigridOperators.h:1574-1644.
    """
    xp = _xp(labels)
    touches = xp.zeros(labels.shape, dtype=bool)
    for axis in range(3):
        for direction in (0, 1):
            nbr = _neighbor(labels, axis, direction, EXT)
            touches = touches | (nbr == DIR) | (nbr == EXT)
    if face_weights is not None:
        for axis in range(3):
            wl, wu = _cell_faces(face_weights[axis], axis)
            touches = touches | (wl != 1) | (wu != 1)
    return xp.where((labels == INT) & touches, BND, labels).astype(LABEL_DTYPE)


def coarsen_labels(fine_labels):
    """One level of label coarsening (8-children vote + boundary pass).

    Any DIRICHLET child -> DIRICHLET; else any solvable child -> INTERIOR;
    else EXTERIOR.  Then INTERIOR cells face-adjacent to DIRICHLET/EXTERIOR
    become BOUNDARY.  Coarse levels carry no fractional weights.
    Reference: Source/HDK_GeometricMultigridOperators.cpp:23-163.
    """
    xp = _xp(fine_labels)
    assert all(s % 2 == 0 for s in fine_labels.shape), fine_labels.shape
    nx, ny, nz = (s // 2 for s in fine_labels.shape)
    children = fine_labels.reshape(nx, 2, ny, 2, nz, 2)
    has_dirichlet = (children == DIR).any(axis=(1, 3, 5))
    has_interior = is_solvable(children).any(axis=(1, 3, 5))
    coarse = xp.where(has_dirichlet, DIR, xp.where(has_interior, INT, EXT)).astype(
        LABEL_DTYPE
    )
    return set_boundary_labels(coarse, None)


def boundary_band(labels, width: int):
    """Dense mask of the boundary smoothing band.

    Seeds are all BOUNDARY cells; each of the remaining `width - 1` layers
    expands through unvisited INTERIOR face neighbors (BFS through INTERIOR
    only).  Replaces the reference's sorted explicit cell list with a mask.
    Reference: Source/HDK_GeometricMultigridOperators.cpp:165-469.
    """
    visited = labels == BND
    frontier = visited
    interior = labels == INT
    for _ in range(width - 1):
        dilated = frontier
        for axis in range(3):
            for direction in (0, 1):
                dilated = dilated | _neighbor(frontier, axis, direction, False)
        frontier = dilated & interior & ~visited
        visited = visited | frontier
    return visited


def build_level_coefficients(
    labels,
    face_weights: Sequence | None,
    boundary_width: int,
    dtype=np.float64,
) -> dict:
    """Precompute static stencil coefficient grids for one multigrid level.

    The reference recomputes the per-cell Laplacian coefficients from labels
    and weights inside every smoother application
    (Source/HDK_GeometricMultigridOperators.h:177-260).  Since labels and
    weights are fixed for a solve, we bake them once into:

      * ``diag``      -- stencil diagonal: sum over faces of w_f for
                         neighbors in {INTERIOR, BOUNDARY, DIRICHLET}
                         (6.0 on INTERIOR cells), 0 on non-solvable cells.
      * ``inv_diag``  -- 1/diag on solvable cells, 0 elsewhere (doubles as
                         the solvable mask for smoother updates).
      * ``ew[axis]``  -- off-diagonal edge weights stored CELL-shaped:
                         entry i along the axis is w_f of the face between
                         cell i and i+1 where both cells are solvable, else
                         0 (the last entry is the domain-edge face, always
                         0).  Cell-shaped storage keeps every hot-loop array
                         the same shape for SPMD sharding.
      * ``solvable``  -- bool DOF mask.
      * ``band``      -- bool boundary smoothing band mask.

    On coarse levels (face_weights=None) all face weights are implicitly 1.
    """
    xp = _xp(labels)
    solvable = is_solvable(labels)
    one = xp.ones((), dtype=dtype)
    diag = xp.zeros(labels.shape, dtype=dtype)
    edge_weights = []
    for axis in range(3):
        if face_weights is not None:
            wl, wu = _cell_faces(face_weights[axis].astype(dtype), axis)
        else:
            wl = wu = one
        lbl_m = _neighbor(labels, axis, 0, EXT)
        lbl_p = _neighbor(labels, axis, 1, EXT)

        # Diagonal: each face contributes w_f to its solvable cell whenever
        # the opposite cell is not EXTERIOR (INTERIOR/BOUNDARY/DIRICHLET all
        # count; reference computeLaplacian,
        # Source/HDK_GeometricMultigridOperators.h:177-260).
        zero = xp.zeros(labels.shape, dtype=dtype)
        diag = diag + xp.where(solvable & (lbl_p != EXT), wu, zero)
        diag = diag + xp.where(solvable & (lbl_m != EXT), wl, zero)

        # Off-diagonal upper-face edge weight (cell-shaped).
        edge_weights.append(xp.where(solvable & is_solvable(lbl_p), wu, zero))

    safe = xp.where(diag > 0, diag, one)
    inv_diag = xp.where(solvable & (diag > 0), one / safe, xp.zeros_like(diag))

    return {
        "labels": labels,
        "solvable": solvable,
        "band": boundary_band(labels, boundary_width),
        "diag": diag,
        "inv_diag": inv_diag,
        "ew": edge_weights,
    }


def build_label_hierarchy(
    expanded_labels,
    mg_levels: int,
    max_levels: int | None = None,
) -> list:
    """Coarsen labels level by level, capping when a level has no DOFs.

    Reference caps `myMGLevels` when a coarse level has no solvable cell
    (Source/HDK_GeometricMultigridPoissonSolver.cpp:243-248).
    """
    if max_levels is not None:
        mg_levels = min(mg_levels, max_levels)
    levels = [expanded_labels]
    for _ in range(1, mg_levels):
        coarse = coarsen_labels(levels[-1])
        if not bool(is_solvable(coarse).any()):
            break
        levels.append(coarse)
    return levels


# ---------------------------------------------------------------------------
# Invariant checks (reference built-in unit tests; host-side numpy)
# ---------------------------------------------------------------------------


def check_exterior_shell(labels) -> bool:
    """All six outer faces of the grid must be fully EXTERIOR.

    Reference unitTestExteriorCells
    (Source/HDK_GeometricMultigridOperators.cpp:602-632).
    """
    labels = np.asarray(labels)
    for axis in range(3):
        for idx in (0, -1):
            sl = [slice(None)] * 3
            sl[axis] = idx
            if not (labels[tuple(sl)] == EXT).all():
                return False
    return True


def check_coarsening(fine, coarse) -> bool:
    """Fine<->coarse label consistency in both directions.

    Mirrors reference unitTestCoarsening
    (Source/HDK_GeometricMultigridOperators.cpp:471-600):
      * coarse equals an independent recoarsening of fine;
      * coarse DIRICHLET  => at least one DIRICHLET child;
      * coarse solvable   => at least one solvable child, no DIRICHLET child;
      * coarse EXTERIOR   => no DIRICHLET or solvable child;
      * fine solvable     => parent not EXTERIOR (a Dirichlet sibling may
                             have voted the parent DIRICHLET);
      * fine DIRICHLET    => parent DIRICHLET.
    """
    fine = np.asarray(fine)
    coarse = np.asarray(coarse)
    if tuple(2 * np.asarray(coarse.shape)) != fine.shape:
        return False
    if not np.array_equal(coarse, np.asarray(coarsen_labels(fine))):
        return False

    nx, ny, nz = coarse.shape
    children = fine.reshape(nx, 2, ny, 2, nz, 2)
    has_dir = (children == DIR).any(axis=(1, 3, 5))
    has_solv = is_solvable(children).any(axis=(1, 3, 5))
    all_ext = (children == EXT).all(axis=(1, 3, 5))

    if not has_dir[coarse == DIR].all():
        return False
    coarse_solv = is_solvable(coarse)
    if not (has_solv[coarse_solv] & ~has_dir[coarse_solv]).all():
        return False
    if not all_ext[coarse == EXT].all():
        return False

    parent = coarse.repeat(2, axis=0).repeat(2, axis=1).repeat(2, axis=2)
    if (parent[is_solvable(fine)] == EXT).any():
        return False
    if not (parent[fine == DIR] == DIR).all():
        return False
    return True


def check_boundary_cells(labels, face_weights: Sequence | None) -> bool:
    """Every INTERIOR cell is fully regular; every BOUNDARY cell is justified.

    Mirrors reference unitTestBoundaryCells
    (Source/HDK_GeometricMultigridOperators.h:1771-1870).
    """
    labels = np.asarray(labels)
    interior = labels == INT

    irregular = np.zeros(labels.shape, dtype=bool)
    for axis in range(3):
        for direction in (0, 1):
            nbr = _neighbor(labels, axis, direction, EXT)
            irregular |= (nbr == DIR) | (nbr == EXT)
    if face_weights is not None:
        for axis in range(3):
            wl, wu = _cell_faces(np.asarray(face_weights[axis]), axis)
            irregular |= (wl != 1) | (wu != 1)

    if irregular[interior].any():
        return False
    boundary = labels == BND
    if (~irregular[boundary]).any():
        return False
    # Edge cells can never be solvable (no out-of-bounds stencil reads).
    if not check_exterior_shell(np.where(is_solvable(labels), labels, EXT)):
        return False
    return True

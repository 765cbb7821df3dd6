"""Synthetic signed-distance fields and cut-cell face weights.

Scene generators for tests and benchmarks, standing in for the Houdini
fields the reference nodes consume (and for the test node's own generators,
Source/HDK_TestGeometricMultigrid.cpp:233-360: sine-wave Dirichlet surface,
solid sphere with cut-cell weights via computeSDFWeightsFace, domain-edge
faces zeroed).

Every generator takes an `xp` array module (numpy by default, jax.numpy for
device-resident generation: at 256^3+ the scene build runs on the device
rather than in host numpy).

Conventions:
  * liquid SDF `phi`: cell-centered, <= 0 inside the liquid;
  * solid SDF: cell-centered samples, >= 0 inside the solid (matches the
    reference's isCellLiquid check `solidSurface.getValue(pos) >= 0`,
    Source/HDK_Utilities.cpp:26; the node default of -10*dx means
    "no solid anywhere").
  * cut-cell weight: fraction of the face open to fluid, in [0, 1]; small
    weights are clamped to zero (reference clamps below .01,
    Source/HDK_TestGeometricMultigrid.cpp:321).
"""

from __future__ import annotations

import numpy as np

from geometricmultigridpressuresolver_tpu.grids import face_shape


def cell_centers(shape, dx: float | None = None, xp=np):
    """Cell-center coordinates in [0,1]^3 (dx = 1/max(shape) by default)."""
    if dx is None:
        dx = 1.0 / max(shape)
    axes = [(xp.arange(s) + 0.5) * dx for s in shape]
    return xp.meshgrid(*axes, indexing="ij"), dx


def sphere_sdf(points, center, radius, xp=np):
    x, y, z = points
    return xp.sqrt(
        (x - center[0]) ** 2 + (y - center[1]) ** 2 + (z - center[2]) ** 2
    ) - radius


def pool_sdf(points, height):
    """Liquid pool filling the domain below `height` (phi <= 0 in liquid)."""
    return points[1] - height


def splash_scene(
    shape,
    pool_height=0.35,
    drop_center=(0.5, 0.7, 0.5),
    drop_radius=0.15,
    xp=np,
):
    """flipSplash-style scene: a pool plus a falling liquid drop.

    Returns (liquid_phi, velocity).  The drop carries downward velocity with
    a jump at its surface, and the x-component is compressive, so the
    pre-projection velocity has nonzero divergence throughout the liquid.
    """
    points, dx = cell_centers(shape, xp=xp)
    phi_pool = pool_sdf(points, pool_height)
    phi_drop = sphere_sdf(points, drop_center, drop_radius, xp=xp)
    liquid_phi = xp.minimum(phi_pool, phi_drop)

    velocity = []
    for axis in range(3):
        coords = []
        for a in range(3):
            n = shape[a] + (1 if a == axis else 0)
            offset = 0.0 if a == axis else 0.5
            coords.append((xp.arange(n) + offset) * dx)
        gx, gy, gz = xp.meshgrid(*coords, indexing="ij")
        if axis == 0:
            # Compressive x-component: nonzero divergence everywhere.
            v = 0.3 * xp.sin(2.0 * np.pi * gx)
        elif axis == 1:
            # Downward velocity inside the falling drop only, so drop-surface
            # cells see a velocity jump.
            inside = sphere_sdf((gx, gy, gz), drop_center, drop_radius, xp=xp) <= 0
            v = xp.where(inside, -1.0, 0.0)
        else:
            v = xp.zeros(face_shape(shape, axis))
        velocity.append(v)
    return liquid_phi, velocity


def face_weights_from_solid(
    solid_fn, shape, dx: float | None = None, clamp: float = 0.01,
    samples: int = 4, xp=np,
):
    """Cut-cell face weights: supersampled fraction of each face open to fluid.

    `solid_fn((x, y, z)) -> phi` with phi >= 0 inside the solid.  Each face
    is sampled on a `samples x samples` grid; the weight is the fraction of
    samples with phi < 0.  Weights below `clamp` become 0; domain-boundary
    faces are zeroed (closed-box convention, as in the reference test scene,
    Source/HDK_TestGeometricMultigrid.cpp:345-360).
    """
    if dx is None:
        dx = 1.0 / max(shape)
    offsets = (np.arange(samples) + 0.5) / samples
    weights = []
    for axis in range(3):
        fshape = face_shape(shape, axis)
        coords = [xp.arange(fshape[a]) * dx for a in range(3)]
        w = xp.zeros(fshape)
        tangent = [a for a in range(3) if a != axis]
        for o1 in offsets:
            for o2 in offsets:
                shift = [0.0, 0.0, 0.0]
                shift[tangent[0]] = float(o1) * dx
                shift[tangent[1]] = float(o2) * dx
                grid = xp.meshgrid(
                    coords[0] + shift[0],
                    coords[1] + shift[1],
                    coords[2] + shift[2],
                    indexing="ij",
                )
                w = w + (solid_fn(grid) < 0).astype(w.dtype)
        w = w / (samples * samples)
        w = xp.where(w < clamp, 0.0, w)

        # Close the domain boundary faces.
        mask = np.ones(fshape, dtype=bool)
        edge = [slice(None)] * 3
        edge[axis] = 0
        mask[tuple(edge)] = False
        edge[axis] = -1
        mask[tuple(edge)] = False
        w = xp.where(xp.asarray(mask), w, 0.0)
        weights.append(w)
    return weights


def open_box_weights(shape, xp=np):
    """Unit weights everywhere except closed domain-boundary faces."""
    return face_weights_from_solid(
        lambda pts: xp.full_like(pts[0], -1.0), shape, samples=1, xp=xp
    )

"""Domain construction + invariant tests (reference built-in unit tests).

Fixtures mirror the reference test node's synthetic domains
(Source/HDK_TestGeometricMultigrid.cpp:466-625 buildSimpleDomain,
cpp:233-461 buildComplexDomain).
"""

import numpy as np
import pytest

from geometricmultigridpressuresolver_tpu.grids import CellLabel, face_shape
from geometricmultigridpressuresolver_tpu.ops import domain

EXT, DIR, INT, BND = (
    int(CellLabel.EXTERIOR),
    int(CellLabel.DIRICHLET),
    int(CellLabel.INTERIOR),
    int(CellLabel.BOUNDARY),
)


def simple_domain(n, dirichlet_band=1):
    """Cube of INTERIOR wrapped in a Dirichlet shell (buildSimpleDomain)."""
    labels = np.full((n, n, n), DIR, dtype=np.int8)
    b = dirichlet_band
    labels[b:-b, b:-b, b:-b] = INT
    return labels


def sine_dirichlet_domain(n):
    """Sine-wave implicit Dirichlet surface (buildComplexDomain flavor)."""
    x, y, z = np.meshgrid(*[(np.arange(n) + 0.5) / n] * 3, indexing="ij")
    phi = x - 0.5 + 0.25 * np.sin(2 * np.pi * y + 4 * np.pi * z)
    labels = np.where(phi <= 0, INT, DIR).astype(np.int8)
    return labels


def test_expansion_params_64():
    mg_levels, padding, expanded = domain.expansion_params((64, 64, 64))
    assert mg_levels == 5
    assert padding == 16
    assert expanded == (128, 128, 128)


def test_expansion_params_anisotropic():
    mg_levels, padding, expanded = domain.expansion_params((64, 32, 48))
    # min dim 32 -> mg_levels = 4, padding 8
    assert mg_levels == 4
    assert padding == 8
    assert expanded == (128, 64, 64)


@pytest.mark.parametrize("builder", [simple_domain, sine_dirichlet_domain])
def test_hierarchy_invariants(builder):
    base = builder(32)
    expanded, offset, mg_levels = domain.expand_domain(base)
    assert domain.check_exterior_shell(expanded)

    # Unit face weights on faces touching interior cells, as in the simple
    # test domain; then relabel boundaries.
    weights = []
    for axis in range(3):
        w = np.zeros(face_shape(expanded.shape, axis))
        lo = [slice(None)] * 3
        hi = [slice(None)] * 3
        lo[axis] = slice(0, -1)
        hi[axis] = slice(1, None)
        interior_faces = [slice(None)] * 3
        interior_faces[axis] = slice(1, -1)
        touch = (expanded[tuple(lo)] != EXT) & (expanded[tuple(hi)] != EXT)
        w[tuple(interior_faces)] = touch.astype(float)
        weights.append(w)

    labeled = domain.set_boundary_labels(expanded, weights)
    assert domain.check_boundary_cells(labeled, weights)

    hierarchy = domain.build_label_hierarchy(labeled, mg_levels)
    assert len(hierarchy) >= 2
    for fine, coarse in zip(hierarchy, hierarchy[1:]):
        assert domain.check_coarsening(fine, coarse)
        assert domain.check_boundary_cells(coarse, None)
        assert domain.check_exterior_shell(coarse)


def test_boundary_band_width():
    base = simple_domain(32)
    expanded, _, _ = domain.expand_domain(base)
    labeled = domain.set_boundary_labels(expanded, None)
    band1 = domain.boundary_band(labeled, 1)
    band3 = domain.boundary_band(labeled, 3)
    assert np.array_equal(band1, labeled == BND)
    assert band3.sum() > band1.sum()
    # Width-3 band = boundary cells plus two interior layers: for the cube
    # domain that is exactly the 3 outermost interior shells.
    inner = labeled == INT
    assert band3[inner].sum() > 0
    # band only covers solvable cells
    assert not band3[(labeled == EXT) | (labeled == DIR)].any()


def test_level_coefficients_interior_diag():
    base = simple_domain(16)
    expanded, _, mg_levels = domain.expand_domain(base)
    labeled = domain.set_boundary_labels(expanded, None)
    coeffs = domain.build_level_coefficients(labeled, None, 3)
    diag = coeffs["diag"]
    assert (diag[labeled == INT] == 6.0).all()
    assert (diag[labeled == BND] > 0).all()
    assert (diag[(labeled == EXT) | (labeled == DIR)] == 0).all()
    # Cell-shaped edge weights: entry i along the axis is the weight of the
    # face between cell i and i+1; it vanishes unless both cells are solvable.
    for axis in range(3):
        ew = coeffs["ew"][axis]
        assert ew.shape == labeled.shape
        lo = [slice(None)] * 3
        hi = [slice(None)] * 3
        lo[axis] = slice(0, -1)
        hi[axis] = slice(1, None)
        both_solvable = (labeled[tuple(lo)] >= INT) & (labeled[tuple(hi)] >= INT)
        ew_faces = ew[tuple(lo)]
        assert (ew_faces[~both_solvable] == 0).all()
        assert (ew_faces[both_solvable] == 1).all()
        # Domain-edge entry is always zero.
        edge = [slice(None)] * 3
        edge[axis] = -1
        assert (ew[tuple(edge)] == 0).all()


def test_level_capping():
    # A domain with a single tiny blob of interior cells: coarse levels
    # quickly run out of solvable cells only if the blob vanishes; with
    # vote-based coarsening the blob persists, so just check the cap logic
    # doesn't produce empty levels.
    base = np.full((16, 16, 16), DIR, dtype=np.int8)
    base[7:9, 7:9, 7:9] = INT
    expanded, _, mg_levels = domain.expand_domain(base)
    labeled = domain.set_boundary_labels(expanded, None)
    hierarchy = domain.build_label_hierarchy(labeled, mg_levels)
    for lv in hierarchy:
        assert (lv >= INT).any()


@pytest.mark.parametrize("n", [16, 48, 100, 130])
def test_compact_window_extents_are_minimal(n):
    """Every window extent is the smallest multiple of the exterior padding
    that holds the active box plus one padding on each side -- on the last
    axis too, at every size."""
    from geometricmultigridpressuresolver_tpu.models import free_surface, sdf

    phi, _ = sdf.splash_scene((n, n, n))
    weights = sdf.open_box_weights((n, n, n))
    *_, projections = free_surface._setup_base_fields(
        phi, weights, None, 0.01, np.float64, dirichlet_band=4,
        want_derived=False,
    )
    mg_levels, padding, bbox, expanded = domain.compact_expansion_params(
        projections[:3], non_ext_count=int(projections[3])
    )
    assert padding == 2 ** (mg_levels - 1)
    for (lo, hi), e in zip(bbox, expanded):
        need = hi - lo + 2 * padding
        assert e % padding == 0
        assert need <= e < need + padding

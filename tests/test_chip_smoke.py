"""chip_smoke.py's host-side pieces, checked on the CPU.

The phases themselves run only on the card; here: the script refuses a
CPU backend, its float64 host residual agrees with the assembled matrix,
its four-card comparison passes on four virtual CPU devices, and its last
line is exactly the contract's JSON object.
"""

import importlib.util
import json
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from geometricmultigridpressuresolver_tpu.models import assembled
from geometricmultigridpressuresolver_tpu.ops import domain, stencil
from geometricmultigridpressuresolver_tpu.ops import host_reference as ref
from tests import helpers

ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_main_refuses_cpu_backend(chip_smoke, capsys):
    assert jax.devices()[0].platform == "cpu"
    assert chip_smoke.main([]) != 0
    out = capsys.readouterr()
    assert out.out == ""
    assert "needs a GPU" in out.err


def test_host_residual_matches_assembled_matrix():
    labels, weights, _ = helpers.expanded_domain(
        helpers.sine_dirichlet_domain, 16, fractional=True
    )
    host = domain.build_level_coefficients(labels, weights, boundary_width=3)
    c = ref.host_level(stencil.LevelCoeffs.from_host(host, jnp.float64))
    x = helpers.random_solvable_field(labels, seed=1)
    b = helpers.random_solvable_field(labels, seed=2)

    a, idx = assembled.assemble_poisson(labels, weights)
    ax = assembled.vec_to_grid(a @ assembled.grid_to_vec(x, idx), idx, labels.shape)
    np.testing.assert_allclose(ref.apply_poisson(x, c), ax, rtol=0, atol=1e-12)
    bv = assembled.grid_to_vec(b, idx)
    want = np.linalg.norm(bv - a @ assembled.grid_to_vec(x, idx)) / np.linalg.norm(bv)
    assert ref.relative_residual(x, b, c) == pytest.approx(want, rel=1e-12)


def test_four_card_check_on_virtual_devices(chip_smoke):
    out = chip_smoke.four_card_check(16, jax.devices("cpu")[:4])
    assert out["mesh"] == (2, 2, 1)
    assert out["fine_devices"] == 4 and not out["fine_replicated"]
    assert out["pressure_rel_linf"] <= chip_smoke.FOUR_CARD_PRESSURE_LIMIT


def test_result_line_is_the_contract(chip_smoke):
    line = chip_smoke.result_line("gpu", "NVIDIA H100 80GB HBM3", 1)
    assert "\n" not in line
    assert json.loads(line) == {
        "ok": True,
        "device": {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1},
    }

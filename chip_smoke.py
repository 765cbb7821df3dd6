"""On-card check of the MGPCG free-surface pressure projection.

Drives the system's own entry points (`free_surface.build_setup`,
`free_surface.project`, `mgpcg.solve`, `simulate.run_fused`) on one GPU at
the README's headline size, the 256^3 splash, and checks every result
against a plain reference:

  1. main path at 256^3: setup, compile count, warm solve seconds,
     iterations, recurrence residual, divergence audit, device memory;
  2. the true residual of that solve, recomputed on the host in float64;
  3. the V-cycle's operators at full width against the NumPy float64
     reference (ops/host_reference.py), and the coarsest direct solve;
  4. the whole projection at 128^3 against the scipy assembled solve;
  5. the six-operator symmetry check at 64^3 in float64 on the card;
  6. the fused frame loop at 128^3;
  7. per-stage times at 256^3 against the bandwidth floor.

`--four-cards` runs only the multi-device check: the 256^3 projection
built and solved on a (2, 2, 1) mesh of four cards against the same
projection on one card, in one process.

Run from the repository root:

    python chip_smoke.py              # one card
    python chip_smoke.py --four-cards

The last line of standard output is one JSON object, printed only when
every phase passed.  Without a GPU the script exits non-zero and prints no
result.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
import traceback

import numpy as np

N_MAIN = 256
N_SMALL = 128
N_SYMMETRY = 64
TOLERANCE = 1e-5
# CG stops on its float32 recurrence, which drifts from the true residual;
# the recomputed residual is allowed 10x the tolerance.
TRUE_RESIDUAL_LIMIT = 10 * TOLERANCE
# float32 rounding over at most 8 stencil passes, relative to the largest
# reference value.
OPERATOR_LIMIT = 1e-5
COARSE_SOLVE_LIMIT = 1e-4
ASSEMBLED_PRESSURE_LIMIT = 1e-3
SYMMETRY_LIMIT = 1e-10
# Same operator on four cards, different reduction order.
FOUR_CARD_PRESSURE_LIMIT = 1e-4
# H100 SXM device-memory bandwidth (NVIDIA data sheet), the stencils' roof.
HBM_BYTES_PER_S = 3.35e12


def log(msg: str) -> None:
    print(msg, flush=True)


def result_line(platform: str, kind: str, count: int) -> str:
    """The contract's last line."""
    return json.dumps(
        {"ok": True, "device": {"platform": platform, "kind": kind, "count": count}}
    )


def fp32_config(**kw):
    """The README quick-start configuration, every dtype pinned: fp32 CG,
    fp32 V-cycle, bf16 V-cycle edge weights."""
    import jax.numpy as jnp

    from geometricmultigridpressuresolver_tpu.config import SolverConfig

    base = dict(
        solve_dtype=jnp.float32, mg_dtype=jnp.float32,
        mg_ew_dtype=jnp.bfloat16, tolerance=TOLERANCE, max_iterations=200,
    )
    base.update(kw)
    return SolverConfig(**base)


def splash(n: int):
    """Splash scene at n^3 built on the device, as float32."""
    import jax
    import jax.numpy as jnp

    from geometricmultigridpressuresolver_tpu.models import sdf

    @jax.jit
    def scene():
        phi, vel = sdf.splash_scene((n, n, n), xp=jnp)
        w = sdf.open_box_weights((n, n, n), xp=jnp)
        f32 = lambda a: jnp.asarray(a, jnp.float32)  # noqa: E731
        return f32(phi), tuple(f32(v) for v in vel), tuple(f32(x) for x in w)

    return jax.block_until_ready(scene())


class CompileCounter:
    """Counts XLA backend compilations (jax.monitoring events)."""

    def __init__(self):
        import jax

        self.count = 0
        jax.monitoring.register_event_duration_secs_listener(self._on_event)

    def _on_event(self, event, duration, **kw):
        if event == "/jax/core/compile/backend_compile_duration":
            self.count += 1


def window_rhs(setup, velocity):
    """The solve's right-hand side in the multigrid window."""
    import functools

    import jax

    from geometricmultigridpressuresolver_tpu.models import free_surface

    @functools.partial(jax.jit, static_argnames=("base_pads", "expanded_shape"))
    def rhs(material, velocity, weights, window_start, base_pads, expanded_shape):
        b = free_surface.negative_divergence(
            material == free_surface.LIQUID, velocity, weights
        )
        return free_surface.embed_window(b, window_start, base_pads, expanded_shape)

    return rhs(setup.material, velocity, setup.weights, setup.window_start,
               setup.base_pads, setup.expanded_shape)


def rel_max_diff(got, ref) -> float:
    got = np.asarray(got, dtype=np.float64)
    scale = float(np.max(np.abs(ref))) or 1.0
    return float(np.max(np.abs(got - ref))) / scale


def check(name: str, value: float, limit: float, failures: list) -> None:
    ok = value <= limit
    log(f"  {name}: {value:.3e} (limit {limit:.0e}) {'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append(name)


def timed(fn, *args, reps: int = 2, **kw):
    """(last result, list of wall seconds) of `reps` synchronized calls."""
    import jax

    times, out = [], None
    for _ in range(reps):
        t0 = time.perf_counter()
        out = jax.block_until_ready(fn(*args, **kw))
        times.append(time.perf_counter() - t0)
    return out, times


# ---------------------------------------------------------------- phases


def phase_main(state: dict, failures: list) -> None:
    """Phase 1: build_setup + project at 256^3, then mgpcg.solve."""
    import jax
    import jax.numpy as jnp

    from geometricmultigridpressuresolver_tpu.models import free_surface
    from geometricmultigridpressuresolver_tpu.solver import mgpcg

    counter = state["compiles"]
    config = fp32_config()
    phi, velocity, weights = splash(N_MAIN)
    c0, t0 = counter.count, time.perf_counter()
    setup = free_surface.build_setup(phi, weights, config=config)
    jax.block_until_ready(setup.problem)
    log(f"  setup {time.perf_counter() - t0:.3f} s, "
        f"{counter.count - c0} compiles, window {setup.expanded_shape}, "
        f"{setup.problem.hier.num_levels} levels")
    fine, hier = setup.problem.fine, setup.problem.hier
    log(f"  dtypes: fine diag {fine.diag.dtype}, fine ew {fine.ew0.dtype}, "
        f"V-cycle diag {hier.levels[0].diag.dtype}, V-cycle ew "
        f"{hier.levels[0].ew0.dtype}, coarse "
        f"{(hier.coarse_minv if hier.coarse_minv.size else hier.coarse_chol).dtype}, "
        f"velocity {velocity[0].dtype}")
    ndof = int(jnp.sum(fine.solvable))

    c0, t0 = counter.count, time.perf_counter()
    res = jax.block_until_ready(free_surface.project(setup, velocity, config=config))
    log(f"  first project (compile + run) {time.perf_counter() - t0:.3f} s, "
        f"{counter.count - c0} compiles")
    c0 = counter.count
    res, times = timed(free_surface.project, setup, velocity, config=config)
    log(f"  warm project seconds {times}, {counter.count - c0} compiles")
    log(f"  CG iterations {int(res.cg.iterations)}, recurrence residual "
        f"{float(res.cg.relative_residual):.3e}, converged {bool(res.cg.converged)}")
    log(f"  divergence audit: max {float(res.max_divergence):.3e}, "
        f"avg {float(res.avg_divergence):.3e}, "
        f"accumulated {float(res.accumulated_divergence):.3e}")
    if not bool(res.cg.converged):
        failures.append("phase 1 CG did not converge")

    rhs = jax.block_until_ready(window_rhs(setup, velocity))
    zeros = jnp.zeros_like(rhs)
    compiled = mgpcg._solve.lower(
        setup.problem, rhs, zeros, config, False, None
    ).compile()
    c0 = counter.count
    sol = jax.block_until_ready(mgpcg.solve(setup.problem, rhs, config=config))
    sol, times = timed(mgpcg.solve, setup.problem, rhs, config=config)
    log(f"  warm mgpcg.solve seconds {times}, {counter.count - c0} compiles, "
        f"{ndof} DOFs, {ndof / min(times):.4e} DOF/s, "
        f"{int(sol.iterations)} iterations")
    log(f"  solve memory_analysis: {compiled.memory_analysis()}")
    stats = jax.devices()[0].memory_stats() or {}
    log(f"  peak_bytes_in_use {stats.get('peak_bytes_in_use')}, "
        f"bytes_limit {stats.get('bytes_limit')}")
    state.update(setup=setup, rhs=rhs, sol=sol, config=config)


def fp32_residual_floor(x: np.ndarray, b: np.ndarray, c) -> float:
    """u32 * || |A| |x| || / ||b||: an upper bound on the relative residual
    that rounding x to float32 alone leaves, since |A dx| <= |A| |dx| and
    |dx| <= u32 |x| (u32 = 2^-24, the unit roundoff)."""
    from geometricmultigridpressuresolver_tpu.ops import host_reference as ref

    abs_a = c._replace(ew=tuple(-w for w in c.ew))
    num = np.linalg.norm(ref.apply_poisson(np.abs(x), abs_a))
    return float(2.0 ** -24 * num / np.linalg.norm(b))


def phase_true_residual(state: dict, failures: list) -> None:
    """Phase 2: ||b - A x|| / ||b|| recomputed in float64 on the host, for
    the float32 solve of phase 1 and for a float64 outer CG over the same
    float32 V-cycle."""
    import jax
    import jax.numpy as jnp

    from geometricmultigridpressuresolver_tpu.models import free_surface
    from geometricmultigridpressuresolver_tpu.ops import host_reference as ref
    from geometricmultigridpressuresolver_tpu.solver import mgpcg

    fine = ref.host_level(state["setup"].problem.fine)
    x = np.asarray(state["sol"].x).astype(np.float64)
    b = np.asarray(state["rhs"]).astype(np.float64)
    true_rel = ref.relative_residual(x, b, fine)
    floor = fp32_residual_floor(x, b, fine)
    log(f"  float32 CG: recurrence residual "
        f"{float(state['sol'].relative_residual):.3e}, host float64 true "
        f"residual {true_rel:.3e}, float32 rounding floor {floor:.3e}")
    log("  limit: 10x tol for CG's own error (it stops on a float32 "
        "recurrence that drifts from the true residual), plus the rounding "
        "floor, which bounds ||A (x - fl32(x))|| / ||b||")
    check("float32 CG true relative residual", true_rel,
          TRUE_RESIDUAL_LIMIT + floor, failures)

    config = fp32_config(solve_dtype=jnp.float64)
    phi, velocity, weights = splash(N_MAIN)
    setup = free_surface.build_setup(phi, weights, config=config)
    rhs = window_rhs(setup, tuple(v.astype(jnp.float64) for v in velocity))
    sol = jax.block_until_ready(mgpcg.solve(setup.problem, rhs, config=config))
    sol, times = timed(mgpcg.solve, setup.problem, rhs, config=config)
    true64 = ref.relative_residual(
        np.asarray(sol.x), np.asarray(rhs), ref.host_level(setup.problem.fine)
    )
    log(f"  float64 CG over the float32 V-cycle: {int(sol.iterations)} "
        f"iterations, warm solve seconds {times}, recurrence "
        f"{float(sol.relative_residual):.3e}, true residual {true64:.3e}")
    check("float64 CG true relative residual", true64, TRUE_RESIDUAL_LIMIT, failures)


def phase_operators(state: dict, failures: list) -> None:
    """Phase 3: fp32 operators on the card vs float64 host reference."""
    import jax
    import jax.numpy as jnp

    from geometricmultigridpressuresolver_tpu.ops import host_reference as ref
    from geometricmultigridpressuresolver_tpu.ops import stencil, transfer
    from geometricmultigridpressuresolver_tpu.solver import mg as mg_mod

    setup, config = state["setup"], state["config"]
    hier = setup.problem.hier
    c_dev, c_dev1 = hier.levels[0], hier.levels[1]
    c = ref.host_level(c_dev)
    b_dev = state["rhs"]
    b = np.asarray(b_dev).astype(np.float64)
    x_dev = state["sol"].x
    x = np.asarray(x_dev).astype(np.float64)
    to_np = lambda a: np.asarray(a).astype(np.float64)  # noqa: E731

    for name, lv in (("CG operator", setup.problem.fine), ("V-cycle level 0", c_dev)):
        got = jax.jit(stencil.apply_poisson)(x_dev, lv)
        want = ref.apply_poisson(x, ref.host_level(lv))
        check(f"apply_poisson ({name})", rel_max_diff(got, want),
              OPERATOR_LIMIT, failures)
    smooth = jax.jit(mg_mod._smooth_level, static_argnames=("config", "forward"))
    fwd_dev = smooth(jnp.zeros_like(b_dev), b_dev, c_dev, config=config, forward=True)
    fwd = ref.smooth_block(np.zeros_like(b), b, c, forward=True)
    check("smoothing block forward", rel_max_diff(fwd_dev, fwd),
          OPERATOR_LIMIT, failures)
    bwd_dev = smooth(fwd_dev, b_dev, c_dev, config=config, forward=False)
    bwd = ref.smooth_block(to_np(fwd_dev), b, c, forward=False)
    check("smoothing block backward", rel_max_diff(bwd_dev, bwd),
          OPERATOR_LIMIT, failures)

    # The downstroke's residual: after one smoothing block from zero (at
    # the converged x it would be all cancellation).
    r_dev = jax.jit(stencil.residual)(fwd_dev, b_dev, c_dev)
    r = ref.residual(to_np(fwd_dev), b, c)
    check("residual", rel_max_diff(r_dev, r), OPERATOR_LIMIT, failures)

    rc_dev = jax.jit(transfer.restrict)(r_dev, c_dev1.solvable)
    rc = ref.restrict(r, np.asarray(c_dev1.solvable))
    check("restrict", rel_max_diff(rc_dev, rc), OPERATOR_LIMIT, failures)
    p_dev = jax.jit(transfer.prolong_add)(fwd_dev, rc_dev, c_dev.solvable)
    p = ref.prolong_add(to_np(fwd_dev), to_np(rc_dev), c.solvable)
    check("prolong_add", rel_max_diff(p_dev, p), OPERATOR_LIMIT, failures)

    cc_dev = hier.levels[-1]
    cc = ref.host_level(cc_dev)
    rng = np.random.default_rng(0)
    bc = np.where(cc.solvable, rng.standard_normal(cc.diag.shape), 0.0)
    xc = to_np(jax.jit(mg_mod.coarse_solve)(hier, jnp.asarray(bc, jnp.float32)))
    kind = "Cholesky" if hier.coarse_chol.size else "dense inverse"
    log(f"  coarse system: {int(cc.solvable.sum())} DOFs, {kind}, "
        f"shape {cc_dev.shape}")
    check("coarse_solve ||Ax-b||/||b||", ref.relative_residual(xc, bc, cc),
          COARSE_SOLVE_LIMIT, failures)


def phase_assembled(state: dict, failures: list) -> None:
    """Phase 4: project at 128^3 vs the scipy assembled projection."""
    import jax
    import jax.numpy as jnp

    from geometricmultigridpressuresolver_tpu.models import assembled, free_surface

    config = fp32_config()
    phi, velocity, weights = splash(N_SMALL)
    setup = free_surface.build_setup(phi, weights, config=config)
    res = jax.block_until_ready(free_surface.project(setup, velocity, config=config))
    t0 = time.perf_counter()
    p_ref, _, div_ref = assembled.project_assembled(
        phi, weights, velocity, tolerance=1e-10, max_iterations=20000
    )
    log(f"  scipy assembled solve (float64, tol 1e-10) "
        f"{time.perf_counter() - t0:.1f} s")
    check("pressure relative Linf vs scipy", rel_max_diff(res.pressure, p_ref),
          ASSEMBLED_PRESSURE_LIMIT, failures)
    b = free_surface.negative_divergence(
        setup.material == free_surface.LIQUID, velocity, setup.weights
    )
    b_norm = float(jnp.linalg.norm(b.astype(jnp.float64)))
    # The post-projection divergence is the solve's residual on the base
    # grid: ||r||_inf <= ||r||_2 <= tol ||b||_2, with 10x for float32.
    log(f"  max divergence: MGPCG {float(res.max_divergence):.3e}, "
        f"scipy {div_ref:.3e}, ||b||_2 {b_norm:.3e}")
    check("MGPCG max divergence / ||b||_2", float(res.max_divergence) / b_norm,
          TRUE_RESIDUAL_LIMIT, failures)


def phase_symmetry(state: dict, failures: list) -> None:
    """Phase 5: six-operator symmetry at 64^3 in float64 on the card."""
    from geometricmultigridpressuresolver_tpu import diagnostics

    out = diagnostics.run_symmetry_test(grid_size=N_SYMMETRY)
    for name, value in out.items():
        check(f"symmetry {name}", value, SYMMETRY_LIMIT, failures)


def phase_frames(state: dict, failures: list) -> None:
    """Phase 6: run_fused at 128^3, a 4-frame warm-up chunk then 4 frames."""
    from geometricmultigridpressuresolver_tpu.models import simulate

    config = fp32_config()
    phi, velocity, weights = splash(N_SMALL)
    marks = [time.perf_counter()]
    _, _, _, stats = simulate.run_fused(
        phi, velocity, weights, num_frames=8, config=config, chunk=4,
        on_chunk=lambda done, s: marks.append(time.perf_counter()),
    )
    if len(marks) == 3:
        log(f"  warm-up chunk (compile + 4 frames) {marks[1] - marks[0]:.3f} s; "
            f"steady {(marks[2] - marks[1]) / 4:.4f} s/frame")
    else:
        # run_fused re-runs a chunk per frame when its frozen window no
        # longer fits; the frames are still right, only not timed here.
        log(f"  {len(marks) - 1} of 2 chunks stayed fused; not timed")
    for k, (it, rel, div) in enumerate(zip(
        stats["iterations"], stats["relative_residual"], stats["max_divergence"]
    )):
        log(f"  frame {k + 1}: {int(it)} iterations, recurrence residual "
            f"{rel:.3e}, max divergence {div:.3e}")
    if not np.all(np.isfinite(stats["max_divergence"])):
        failures.append("frame loop divergence not finite")
    if np.any(stats["relative_residual"] > TOLERANCE):
        failures.append("a frame's solve did not converge")


def smoother_bytes_per_cell(c) -> tuple[int, int]:
    """(one fused read + write of the smoothing block, the plain schedule)
    in bytes per cell, from the level's dtypes.  Fused: x, b, inv_diag,
    diag, three edge weights and the band in, x out.  Plain: each of the
    2 * 3 band passes reads the same and writes x; each of the two colour
    passes reads all but the band and writes x."""
    field = c.diag.dtype.itemsize
    coeff = (2 * field + 3 * c.ew0.dtype.itemsize)  # diag, inv_diag, ew0..2
    band = c.band.dtype.itemsize
    fused = 2 * field + coeff + band + field
    colour = 2 * field + coeff + field
    return fused, 6 * fused + 2 * colour


def phase_stages(state: dict, failures: list) -> None:
    """Phase 7: per-level V-cycle stages and the CG sub-steps at 256^3."""
    from geometricmultigridpressuresolver_tpu.utils import profiling

    setup, config, rhs = state["setup"], state["config"], state["rhs"]
    hier = setup.problem.hier
    totals = {}
    for mode in ("slice", "mm"):
        cfg = fp32_config(transfer_mode=mode)
        times = profiling.vcycle_stage_times(hier, rhs, cfg, warmup=1, reps=3)
        log(f"  V-cycle stages, transfer_mode={mode} (avg ms per call):")
        for name in sorted(times.seconds):
            log(f"    {name:<32} {1e3 * times.seconds[name] / times.calls[name]:.4f}")
        totals[mode] = sum(
            s / times.calls[k] for k, s in times.seconds.items()
            if "restrict" in k or "prolong" in k
        )
        if mode == "slice":
            fine = "L0 smooth (down)"
            fine_ms = 1e3 * times.seconds[fine] / times.calls[fine]
    log(f"  transfers per V-cycle: slice {1e3 * totals['slice']:.4f} ms, "
        f"mm {1e3 * totals['mm']:.4f} ms")
    c = hier.levels[0]
    cells = int(np.prod(c.shape))
    fused_b, plain_b = smoother_bytes_per_cell(c)
    t_fused = cells * fused_b / HBM_BYTES_PER_S
    t_plain = cells * plain_b / HBM_BYTES_PER_S
    log(f"  fine smoothing block {c.shape}: {fused_b} B/cell fused "
        f"({cells * fused_b / 1e9:.3f} GB, floor {1e3 * t_fused:.4f} ms), "
        f"{plain_b} B/cell plain 8-pass ({cells * plain_b / 1e9:.3f} GB, "
        f"floor {1e3 * t_plain:.4f} ms)")
    log(f"  measured {fine_ms:.4f} ms = {fine_ms / (1e3 * t_fused):.2f}x the "
        f"fused floor, {fine_ms / (1e3 * t_plain):.2f}x the plain floor "
        f"(3.35 TB/s, card {state['card']})")
    for _ in range(2):  # the first run compiles each sub-step
        _, times = profiling.instrumented_solve(
            setup.problem, rhs, config=config, print_stats=False
        )
    log("  CG sub-steps, warm (avg ms per call):")
    for name in sorted(times.seconds):
        log(f"    {name:<32} {1e3 * times.seconds[name] / times.calls[name]:.4f} "
            f"x{times.calls[name]}")


def four_card_check(n: int, devices, config=None) -> dict:
    """Sharded build_setup + project of the n^3 splash on a mesh of four
    `devices`, against the single-device projection of the same scene."""
    import jax

    from geometricmultigridpressuresolver_tpu.models import free_surface
    from geometricmultigridpressuresolver_tpu.parallel import make_mesh, shard_velocity

    config = config or fp32_config()
    mesh = make_mesh(4, list(devices))
    phi, velocity, weights = splash(n)
    single = free_surface.build_setup(phi, weights, config=config)
    base = jax.block_until_ready(free_surface.project(single, velocity, config=config))
    sharded = free_surface.build_setup(phi, weights, config=config, mesh=mesh)
    fine_sh = sharded.problem.fine.solvable.sharding
    dist = jax.block_until_ready(
        free_surface.project(sharded, shard_velocity(velocity, mesh), config=config)
    )
    return {
        "mesh": tuple(mesh.devices.shape),
        "fine_devices": len(fine_sh.device_set),
        "fine_replicated": bool(fine_sh.is_fully_replicated),
        "pressure_rel_linf": rel_max_diff(
            dist.pressure, np.asarray(base.pressure, np.float64)
        ),
        "iterations": (int(base.cg.iterations), int(dist.cg.iterations)),
        "max_divergence": (float(base.max_divergence), float(dist.max_divergence)),
    }


def phase_four_cards(state: dict, failures: list) -> None:
    import jax

    out = four_card_check(N_MAIN, jax.devices()[:4])
    log(f"  mesh {out['mesh']}, fine level on {out['fine_devices']} devices, "
        f"replicated {out['fine_replicated']}")
    log(f"  iterations single/sharded {out['iterations']}, "
        f"max divergence {out['max_divergence']}")
    if out["fine_devices"] != 4 or out["fine_replicated"]:
        failures.append("fine level not block-partitioned over 4 devices")
    check("pressure relative Linf, 4 cards vs 1", out["pressure_rel_linf"],
          FOUR_CARD_PRESSURE_LIMIT, failures)


PHASES = (
    ("1 main path 256^3", phase_main, ()),
    ("2 true residual", phase_true_residual, ("setup",)),
    ("3 operators vs float64 reference", phase_operators, ("setup",)),
    ("4 projection vs scipy 128^3", phase_assembled, ()),
    ("5 float64 symmetry 64^3", phase_symmetry, ()),
    ("6 fused frame loop 128^3", phase_frames, ()),
    ("7 per-stage breakdown 256^3", phase_stages, ("setup",)),
)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--four-cards", action="store_true",
                        help="run only the four-card sharded check")
    args = parser.parse_args(argv)

    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu":
        print(f"chip_smoke: needs a GPU; JAX found {devices[0].platform}",
              file=sys.stderr)
        return 2
    need = 4 if args.four_cards else 1
    if len(devices) < need:
        print(f"chip_smoke: needs {need} GPUs, JAX found {len(devices)}",
              file=sys.stderr)
        return 2
    # Phase 5 runs float64 on the card; every other phase pins its dtypes.
    jax.config.update("jax_enable_x64", True)
    from geometricmultigridpressuresolver_tpu.utils import runtime

    log(f"compile cache {runtime.enable_compile_cache()}")
    card = runtime.card_line()
    log(f"device {devices[0].device_kind}, count {len(devices)}, "
        f"platform {devices[0].platform}")
    log(f"nvidia-smi: {card}")

    state = {"compiles": CompileCounter(), "card": card.splitlines()[0]}
    phases = (
        (("8 four cards 256^3", phase_four_cards, ()),) if args.four_cards else PHASES
    )
    failed = []
    t_all = time.perf_counter()
    for name, fn, needs in phases:
        if any(k not in state for k in needs):
            log(f"phase {name}: FAILED (an earlier phase it needs failed)")
            failed.append(name)
            continue
        log(f"phase {name}")
        failures: list = []
        t0 = time.perf_counter()
        try:
            fn(state, failures)
        except Exception:  # report the phase, run the rest, exit non-zero
            traceback.print_exc()
            failures.append("exception")
        dt = time.perf_counter() - t0
        if failures:
            log(f"phase {name}: FAILED in {dt:.1f} s: {failures}")
            failed.append(name)
        else:
            log(f"phase {name}: ok in {dt:.1f} s")
    log(f"total {time.perf_counter() - t_all:.1f} s")
    if failed:
        log(f"FAILED phases: {failed}")
        return 1
    print(result_line(devices[0].platform, devices[0].device_kind,
                      len(devices)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

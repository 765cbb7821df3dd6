"""Minimal incompressible free-surface simulation driver.

The reference's end-to-end oracle is `Scenes/flipSplash.hip`: a FLIP splash
simulation with the pressure node in the loop, exercising per-frame label
rebuilds, warm-started solves, and the post-projection divergence audit
(SURVEY.md section 4.3).  This module is that scene without Houdini: a
semi-Lagrangian advect -> gravity -> MGPCG-project loop over the SDF and
MAC velocity.  It is intentionally simple (first-order advection, no
particles) -- its job is to drive the pressure pipeline the way a real
fluid solver does, not to be a production FLIP.

Every step rebuilds the projection setup (the liquid topology changes
frame to frame, exactly like the reference's per-cook label rebuild) and
warm-starts CG from the previous pressure (reference `useOldPressure`,
Source/HDK_GeometricFreeSurfacePressureSolver.cpp:408-418, 945-997).
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Sequence

import jax
import jax.numpy as jnp
import numpy as np
from jax.scipy.ndimage import map_coordinates

from geometricmultigridpressuresolver_tpu.config import SolverConfig
from geometricmultigridpressuresolver_tpu.models import free_surface


def _cell_center_velocity(velocity: Sequence[jax.Array]) -> tuple:
    """Average MAC faces to cell centers, per component."""
    out = []
    for axis in range(3):
        v = velocity[axis]
        lo = [slice(None)] * 3
        hi = [slice(None)] * 3
        lo[axis] = slice(0, -1)
        hi[axis] = slice(1, None)
        out.append(0.5 * (v[tuple(lo)] + v[tuple(hi)]))
    return tuple(out)


def _sample(field: jax.Array, idx: Sequence[jax.Array]) -> jax.Array:
    """Trilinear sample at (fractional) index coordinates, edge-clamped."""
    return map_coordinates(field, list(idx), order=1, mode="nearest")


def _index_grid(shape, axis: int | None):
    """Index coordinates of cell centers (axis=None) or face centers."""
    coords = []
    for a in range(3):
        n = shape[a] + (1 if a == axis else 0)
        # Cell center i sits at index i; face i along its own axis at i-0.5.
        offset = -0.5 if a == axis else 0.0
        coords.append(jnp.arange(n, dtype=jnp.float32) + offset)
    return jnp.meshgrid(*coords, indexing="ij")


@functools.partial(jax.jit, static_argnames=("dt", "dx"))
def advect_scalar(field: jax.Array, velocity, dt: float, dx: float) -> jax.Array:
    """Semi-Lagrangian advection of a cell-centered field."""
    vc = _cell_center_velocity(velocity)
    idx = _index_grid(field.shape, None)
    back = [idx[a] - (dt / dx) * vc[a] for a in range(3)]
    return _sample(field, back)


def _edge_shift(f: jax.Array, axis: int, up: bool) -> jax.Array:
    """Edge-replicated unit shift (the stencil analogue of map_coordinates'
    mode="nearest" clamping)."""
    n = f.shape[axis]
    main = [slice(None)] * 3
    edge = [slice(None)] * 3
    if up:  # out[i] = f[i+1], clamped at the top
        main[axis] = slice(1, None)
        edge[axis] = slice(n - 1, n)
        return jnp.concatenate([f[tuple(main)], f[tuple(edge)]], axis=axis)
    main[axis] = slice(0, n - 1)  # out[i] = f[i-1], clamped at the bottom
    edge[axis] = slice(0, 1)
    return jnp.concatenate([f[tuple(edge)], f[tuple(main)]], axis=axis)


def _upwind_substep(f, vel_at_points, c: float):
    """One first-order upwind Euler substep of df/dt = -v.grad(f).

    `c` = dt_sub/dx.  All terms are shifts + selects -- no gathers.  Per-axis upwinding from the unsplit field (first-order
    consistent)."""
    out = f
    for a in range(3):
        vp = vel_at_points[a]
        fwd = _edge_shift(f, a, True) - f   # f[i+1] - f[i]
        bwd = f - _edge_shift(f, a, False)  # f[i] - f[i-1]
        out = out - c * (
            jnp.maximum(vp, 0) * bwd + jnp.minimum(vp, 0) * fwd
        )
    return out


def _face_velocity(velocity, axis: int) -> tuple:
    """Full velocity sampled at `axis`-face centers, by pure 2-point
    averaging (exactly what trilinear sampling reduces to at on-grid face
    positions): component `axis` is the face array itself; component j is
    the cell-centered average of u_j shifted onto the faces."""
    vc = _cell_center_velocity(velocity)
    out = []
    for j in range(3):
        if j == axis:
            out.append(velocity[axis])
            continue
        v = vc[j]
        pad = [(0, 0)] * 3
        pad[axis] = (1, 1)
        vp = jnp.pad(v, pad, mode="edge")
        lo = [slice(None)] * 3
        hi = [slice(None)] * 3
        lo[axis] = slice(0, -1)
        hi[axis] = slice(1, None)
        out.append(0.5 * (vp[tuple(lo)] + vp[tuple(hi)]))
    return tuple(out)


@functools.partial(jax.jit, static_argnames=("dt", "dx", "substeps"))
def advect_scalar_upwind(
    field: jax.Array, velocity, dt: float, dx: float, substeps: int = 4
) -> jax.Array:
    """Stencil (upwind) advection of a cell-centered field.

    Gather-free alternative to `advect_scalar` (semi-Lagrangian
    map_coordinates is 8 arbitrary-index gathers per field).  First-order
    upwind is the same formal order with pure shift/select arithmetic;
    `substeps` sub-Euler steps keep CFL <= 1 per substep (stable for
    dt.|v|max/dx <= substeps).
    """
    vc = _cell_center_velocity(velocity)
    c = (dt / substeps) / dx
    for _ in range(substeps):
        field = _upwind_substep(field, vc, c)
    return field


@functools.partial(jax.jit, static_argnames=("dt", "dx", "substeps"))
def advect_velocity_upwind(velocity, dt: float, dx: float, substeps: int = 4):
    """Stencil (upwind) self-advection of the MAC velocity (see
    advect_scalar_upwind).  The advecting velocity is frozen over the
    step, like `advect_velocity`'s backtrace field."""
    c = (dt / substeps) / dx
    out = []
    for axis in range(3):
        vel_at_face = _face_velocity(velocity, axis)
        f = velocity[axis]
        for _ in range(substeps):
            f = _upwind_substep(f, vel_at_face, c)
        out.append(f)
    return tuple(out)


@functools.partial(jax.jit, static_argnames=("dt", "dx"))
def advect_velocity(velocity, dt: float, dx: float) -> tuple:
    """Semi-Lagrangian advection of each MAC component."""
    vc_cell = _cell_center_velocity(velocity)
    out = []
    for axis in range(3):
        idx = _index_grid(vc_cell[0].shape, axis)
        # Full velocity at this component's face positions.
        vel_at_face = [
            velocity[a] if a == axis
            else _sample(vc_cell[a], [i for i in idx])
            for a in range(3)
        ]
        back = [idx[a] - (dt / dx) * vel_at_face[a] for a in range(3)]
        # `back` is in cell space (face i at coordinate i - 0.5 along its
        # own axis); the face ARRAY stores face i at index i, so shift by
        # +0.5 along the component's own axis before sampling.
        back[axis] = back[axis] + 0.5
        out.append(_sample(velocity[axis], back))
    return tuple(out)


def _advect(liquid_phi, velocity, dt: float, dx: float, config: SolverConfig):
    """Scheme dispatch: reference-flavored semi-Lagrangian backtrace or the
    upwind stencil (config.advection)."""
    if config.advection == "upwind":
        new_phi = advect_scalar_upwind(
            liquid_phi, velocity, dt, dx, config.advect_substeps
        )
        new_vel = advect_velocity_upwind(
            velocity, dt, dx, config.advect_substeps
        )
        return new_phi, new_vel
    return (
        advect_scalar(liquid_phi, velocity, dt, dx),
        advect_velocity(velocity, dt, dx),
    )


class FrameResult(NamedTuple):
    liquid_phi: jax.Array
    velocity: tuple
    pressure: jax.Array
    iterations: int
    relative_residual: float
    max_divergence: float
    setup: free_surface.ProjectionSetup  # pass as next frame's reuse_setup


def step(
    liquid_phi: jax.Array,
    velocity: Sequence[jax.Array],
    cut_cell_weights: Sequence[jax.Array],
    dt: float,
    gravity: float = -9.8,
    old_pressure: jax.Array | None = None,
    solid_phi: jax.Array | None = None,
    config: SolverConfig | None = None,
    reuse_setup: free_surface.ProjectionSetup | None = None,
) -> FrameResult:
    """One frame: advect, apply gravity, rebuild setup, project.

    `reuse_setup` (the previous frame's setup) keeps the multigrid window
    SHAPE sticky across frames, so the whole frame reuses compiled
    programs while the liquid moves -- without it, every bounding-box
    change recompiles the whole solve program.
    """
    # Default resolved at CALL time (not import time), so late
    # jax_enable_x64 changes are honored by the default config.
    if config is None:
        config = SolverConfig()
    dx = 1.0 / max(liquid_phi.shape)
    velocity = tuple(jnp.asarray(v, dtype=config.solve_dtype) for v in velocity)
    liquid_phi = jnp.asarray(liquid_phi, dtype=config.solve_dtype)

    new_phi, new_vel = _advect(liquid_phi, velocity, dt, dx, config)
    new_vel = list(new_vel)
    new_vel[1] = new_vel[1] + config.solve_dtype(gravity * dt)

    setup = free_surface.build_setup(
        new_phi, cut_cell_weights, solid_phi=solid_phi, config=config,
        reuse_from=reuse_setup,
    )
    # Donation: the advected velocity is dead after the projection (the
    # loop continues from result.velocity), so its buffers are recycled
    # for the output -- one full velocity field less of steady-state
    # device memory.
    # (old_pressure is NOT donated: run() returns every frame's pressure
    # while also warm-starting from it.)
    result = free_surface.project(
        setup, tuple(new_vel), old_pressure=old_pressure, config=config,
        donate=True,
    )
    return FrameResult(
        liquid_phi=new_phi,
        velocity=result.velocity,
        pressure=result.pressure,
        iterations=int(result.cg.iterations),
        relative_residual=float(result.cg.relative_residual),
        max_divergence=float(result.max_divergence),
        setup=setup,
    )


def main(argv=None):
    """CLI driver: the flipSplash loop as a command.

    The reference ships `Scenes/flipSplash.hip` as its end-to-end demo; a
    standalone framework needs a runnable equivalent:

        gmg-tpu-simulate --n 128 --frames 24 --checkpoint-dir out/ckpt \\
                         --checkpoint-every 8 [--resume out/ckpt]
    """
    import argparse
    import time

    p = argparse.ArgumentParser(description=main.__doc__)
    p.add_argument("--n", type=int, default=64, help="grid edge")
    p.add_argument("--frames", type=int, default=8)
    p.add_argument("--dt", type=float, default=1.0 / 120.0)
    p.add_argument("--gravity", type=float, default=-9.8)
    p.add_argument("--tolerance", type=float, default=1e-5)
    p.add_argument("--fp32", action="store_true",
                   help="solve in float32 (bfloat16 MG edge weights)")
    p.add_argument("--checkpoint-dir", default=None)
    p.add_argument("--checkpoint-every", type=int, default=0)
    p.add_argument("--resume", default=None,
                   help="checkpoint directory to resume from")
    args = p.parse_args(argv)

    import jax

    from geometricmultigridpressuresolver_tpu.models import sdf

    kwargs = {"tolerance": args.tolerance}
    if args.fp32:
        kwargs.update(solve_dtype=jnp.float32, mg_dtype=jnp.float32,
                      mg_ew_dtype=jnp.bfloat16)
    config = SolverConfig(**kwargs)

    shape = (args.n,) * 3
    weights = sdf.open_box_weights(shape, xp=jnp)
    start_frame, old_pressure = 0, None
    if args.resume:
        start_frame, phi, velocity, old_pressure = load_state(args.resume)
        phi = jnp.asarray(phi, dtype=config.solve_dtype)
        velocity = tuple(jnp.asarray(v, config.solve_dtype) for v in velocity)
        if old_pressure is not None:
            old_pressure = jnp.asarray(old_pressure, config.solve_dtype)
        print(f"resumed frame {start_frame} from {args.resume}", flush=True)
    else:
        phi, velocity = sdf.splash_scene(shape, xp=jnp)

    def on_frame(k, fr):
        print(
            f"frame {k + 1}: iters={fr.iterations} "
            f"rel={fr.relative_residual:.2e} max|div|={fr.max_divergence:.2e} "
            f"({time.time() - t0:.1f}s)",
            flush=True,
        )

    t0 = time.time()
    frames = run(
        phi, velocity, weights, num_frames=args.frames, dt=args.dt,
        gravity=args.gravity, config=config, on_frame=on_frame,
        start_frame=start_frame, old_pressure=old_pressure,
        checkpoint_dir=args.checkpoint_dir,
        checkpoint_every=args.checkpoint_every,
    )
    jax.block_until_ready(frames[-1].pressure)
    print(f"{len(frames)} frames in {time.time() - t0:.1f}s "
          f"on {jax.devices()[0]}", flush=True)
    return 0


def save_state(directory, frame: int, liquid_phi, velocity, pressure=None) -> None:
    """Checkpoint the simulation state in the native tiled format (io.py).

    The reference has no checkpointing at all (Houdini owns sim state;
    SURVEY.md section 5); a standalone framework needs one.  Constant-tile
    compression makes the far-field SDF and still-water regions nearly
    free on disk.  Resume with `load_state` + `run(start_frame=...)`.
    """
    import json as _json
    from pathlib import Path

    import numpy as np

    from geometricmultigridpressuresolver_tpu import io as gmg_io

    fields = {
        "liquid_phi": np.asarray(liquid_phi),
        "velocity_u": np.asarray(velocity[0]),
        "velocity_v": np.asarray(velocity[1]),
        "velocity_w": np.asarray(velocity[2]),
    }
    if pressure is not None:
        fields["pressure"] = np.asarray(pressure)
    gmg_io.save_scene(directory, **fields)
    (Path(directory) / "state.json").write_text(
        _json.dumps({"frame": int(frame), "format": 1})
    )


def load_state(directory):
    """Load a `save_state` checkpoint -> (frame, liquid_phi, velocity,
    pressure-or-None)."""
    import json as _json
    from pathlib import Path

    from geometricmultigridpressuresolver_tpu import io as gmg_io

    meta = _json.loads((Path(directory) / "state.json").read_text())
    fields = gmg_io.load_scene(directory)
    velocity = (
        fields["velocity_u"], fields["velocity_v"], fields["velocity_w"]
    )
    return (
        int(meta["frame"]), fields["liquid_phi"], velocity,
        fields.get("pressure"),
    )


def _frame_traced(
    phi,
    velocity,
    pressure,
    cut_cell_weights,
    solid_phi,
    config: SolverConfig,
    geom,
    dt: float,
    gravity: float,
):
    """One FULL frame as pure traced computation: advect -> gravity ->
    label/hierarchy rebuild in a frozen window -> on-device coarsest direct
    assembly -> warm-started MGPCG projection -> audit.

    No host interaction anywhere, so `lax.scan` can fuse K frames into one
    compiled program (`run_fused`).  `geom` freezes the data-dependent
    host decisions of build_setup for the chunk: (base_pads,
    expanded_shape, static_start, target_levels, nd_pad, padding), all
    Python constants captured at trace time.

    Returns (new_phi, new_velocity, new_pressure, stats) where stats =
    (iterations, relative_residual, max_divergence, fits, caps_ok, ndof) --
    the last three are the safety outputs run_fused checks per chunk: the
    active region still inside the frozen window, no hierarchy level lost
    all its DOFs (the host path would CAP there,
    solver/mg._finish_hierarchy), and the coarse DOF count within the
    frozen bucket.
    """
    from geometricmultigridpressuresolver_tpu.solver import mg as mg_mod
    from geometricmultigridpressuresolver_tpu.solver import mgpcg

    base_pads, expanded_shape, static_start, target_levels, nd_pad, padding = geom
    sd = config.solve_dtype
    dx = 1.0 / max(phi.shape)

    new_phi, new_vel = _advect(phi, velocity, dt, dx, config)
    new_vel = list(new_vel)
    new_vel[1] = new_vel[1] + sd(gravity * dt)
    new_vel = tuple(new_vel)

    # Steps 1-4 (labels, weights, window expansion) -- same traced pieces
    # build_setup runs, with the window decisions frozen by `geom`.
    material, _, _, mg_labels, trimmed, mg_weights, projections = (
        free_surface._setup_base_fields(
            new_phi, cut_cell_weights, solid_phi, config.theta_clamp, sd,
            config.dirichlet_band, want_compact=config.compact_domain,
            want_derived=False,
        )
    )
    window_labels = trimmed if config.compact_domain else mg_labels
    labels, exp_weights = free_surface._expand_window_fields(
        window_labels, mg_weights, None, base_pads, expanded_shape,
        static_start=static_start,
    )

    # Hierarchy + the on-device coarsest direct solve (the one piece the
    # host path assembles with scipy; mg._coarse_system_traced keeps it
    # inside the program).
    mg_dtype, fine_dtype, fine_full = mgpcg.fine_plan(config)
    levels, flags, _, fine = mg_mod._build_levels_traced(
        labels, tuple(exp_weights), target_levels, config.boundary_width,
        mg_dtype, config.mg_ew_dtype, fine_dtype, fine_full,
    )
    dofs, minv, ndof_c = mg_mod._coarse_system_traced(levels[-1], nd_pad)
    hier = mg_mod.MGHierarchy(
        levels=levels, coarse_dofs=dofs, coarse_minv=minv,
        coarse_chol=jnp.zeros((0, 0), dtype=minv.dtype),
    )
    problem = mgpcg._finish_problem(hier, fine, fine_full)

    setup = free_surface.ProjectionSetup(
        problem=problem,
        material=material,
        weights=tuple(cut_cell_weights),
        liquid_phi=new_phi,
        window_start=jnp.asarray(static_start, dtype=jnp.int32),
        expanded_shape=expanded_shape,
        base_pads=base_pads,
        padding=padding,
        mg_levels=target_levels,
        window_start_static=static_start,
    )
    result = free_surface._project_impl_fn(
        setup, new_vel, new_vel, pressure, config,
        has_solid_vel=False, has_x0=config.use_old_pressure,
        base_pads=base_pads, expanded_shape=expanded_shape,
        static_start=static_start,
    )

    # Safety outputs (checked on the host once per CHUNK, not per frame).
    fits = jnp.bool_(True)
    if projections is not None:
        for a in range(3):
            off = int(static_start[a]) - base_pads[a][0]
            proj = projections[a]
            lo_bad = proj[: max(0, off)].any() if off > 0 else jnp.bool_(False)
            hi0 = min(off + expanded_shape[a], proj.shape[0])
            hi_bad = proj[max(hi0, 0):].any()
            fits = fits & ~lo_bad & ~hi_bad
    caps_ok = jnp.all(jnp.stack(flags)) if flags else jnp.bool_(True)
    stats = (
        result.cg.iterations,
        result.cg.relative_residual,
        result.max_divergence,
        fits,
        caps_ok,
        ndof_c,
    )
    return new_phi, result.velocity, result.pressure, stats


def run_fused(
    liquid_phi,
    velocity,
    cut_cell_weights,
    num_frames: int,
    dt: float = 1.0 / 120.0,
    gravity: float = -9.8,
    solid_phi=None,
    config: SolverConfig | None = None,
    chunk: int = 8,
    old_pressure=None,
    on_chunk=None,
):
    """The flipSplash loop with `chunk` frames per compiled device program.

    `run()` dispatches one program per frame plus host setup glue, and the
    device idles while the host runs that glue.  This fuses K = `chunk`
    complete frames -- advection, gravity, label/hierarchy
    rebuild, ON-DEVICE coarsest direct assembly, warm-started MGPCG,
    writeback, divergence audit -- into one `lax.scan` program with zero
    per-frame host interaction: steady-state frame cost becomes device
    work only.  The reference cooks one frame per Houdini cycle by design;
    frame batching is this build's own amortization (SURVEY.md section 7).

    Frame 0's geometry (window, levels, coarse bucket) is built on the
    host (`build_setup`) and frozen per chunk; each chunk's traced safety
    stats (window fit, level capping, coarse-bucket overflow) are checked
    afterwards, and a violated chunk is discarded and re-run through the
    per-frame `run()` path with fresh geometry -- correctness never
    depends on the frozen-geometry guess.

    Returns (final_phi, final_velocity, final_pressure, stats) with stats
    a dict of per-frame arrays (iterations, relative_residual,
    max_divergence).  Per-frame field snapshots are deliberately NOT
    returned (K resident grids would defeat the memory ledger); use
    `run()` when every frame's fields are needed.
    """
    # Default resolved at CALL time (not import time), so late
    # jax_enable_x64 changes are honored by the default config.
    if config is None:
        config = SolverConfig()
    sd = config.solve_dtype
    phi = jnp.asarray(liquid_phi, dtype=sd)
    vel = tuple(jnp.asarray(v, dtype=sd) for v in velocity)
    weights = tuple(jnp.asarray(w, dtype=sd) for w in cut_cell_weights)
    if solid_phi is not None:
        solid_phi = jnp.asarray(solid_phi, dtype=sd)
    pressure = (
        jnp.zeros(phi.shape, dtype=sd)
        if old_pressure is None
        else jnp.asarray(old_pressure, dtype=sd)
    )

    stats_frames: list[tuple] = []

    def _geometry(cur_phi, reuse=None):
        setup = free_surface.build_setup(
            cur_phi, weights, solid_phi=solid_phi, config=config,
            reuse_from=reuse,
        )
        nd_pad = setup.problem.hier.coarse_minv.shape[0]
        if nd_pad == 0:
            nd_pad = setup.problem.hier.coarse_chol.shape[0]
        # Headroom: liquid motion grows the coarse system across the chunk;
        # one extra bucket absorbs it (overflow is detected regardless).
        nd_pad = max(256, nd_pad + 256)
        geom = (
            setup.base_pads,
            setup.expanded_shape,
            tuple(int(s) for s in np.asarray(setup.window_start)),
            len(setup.problem.hier.levels),
            nd_pad,
            setup.padding,
        )
        return setup, geom

    _, geom = _geometry(phi)

    def _chunk_fn(phi, u, v, w, pressure, weights, solid_phi):
        def body(carry, _):
            phi, u, v, w, pressure = carry
            new_phi, new_vel, new_pressure, stats = _frame_traced(
                phi, (u, v, w), pressure, weights, solid_phi, config, geom,
                dt, gravity,
            )
            return (new_phi, *new_vel, new_pressure), stats

        return jax.lax.scan(
            body, (phi, u, v, w, pressure), None, length=chunk
        )

    chunk_jit = jax.jit(_chunk_fn)

    done = 0
    while done < num_frames:
        k = min(chunk, num_frames - done)
        if k < chunk:
            # Tail shorter than the chunk: the per-frame path avoids
            # compiling a second (length-k) scan program.
            frames = run(
                phi, vel, weights, num_frames=k, dt=dt, gravity=gravity,
                solid_phi=solid_phi, config=config, old_pressure=pressure,
            )
            for fr in frames:
                stats_frames.append(
                    (fr.iterations, fr.relative_residual, fr.max_divergence)
                )
            phi, vel, pressure = (
                frames[-1].liquid_phi, frames[-1].velocity,
                frames[-1].pressure,
            )
            done += k
            continue

        prev = (phi, vel, pressure)
        carry, stats = chunk_jit(phi, *vel, pressure, weights, solid_phi)
        iters, rel, maxdiv, fits, caps_ok, ndof_c = jax.device_get(stats)
        ok = (
            bool(fits.all())
            and bool(caps_ok.all())
            and int(ndof_c.max()) <= geom[4]
        )
        if not ok:
            # The frozen geometry no longer matches the liquid: discard the
            # chunk and recompute those frames on the per-frame path (which
            # rebuilds geometry every frame), then refreeze.
            phi, vel, pressure = prev
            frames = run(
                phi, vel, weights, num_frames=k, dt=dt, gravity=gravity,
                solid_phi=solid_phi, config=config, old_pressure=pressure,
            )
            for fr in frames:
                stats_frames.append(
                    (fr.iterations, fr.relative_residual, fr.max_divergence)
                )
            phi, vel, pressure = (
                frames[-1].liquid_phi, frames[-1].velocity,
                frames[-1].pressure,
            )
            _, geom = _geometry(phi)
            done += k
            continue

        phi, u, v, w, pressure = carry
        vel = (u, v, w)
        for i in range(k):
            stats_frames.append(
                (int(iters[i]), float(rel[i]), float(maxdiv[i]))
            )
        done += k
        if on_chunk is not None:
            on_chunk(done, stats_frames[-k:])

    stats_out = {
        "iterations": np.asarray([s[0] for s in stats_frames]),
        "relative_residual": np.asarray([s[1] for s in stats_frames]),
        "max_divergence": np.asarray([s[2] for s in stats_frames]),
    }
    return phi, vel, pressure, stats_out


def run(
    liquid_phi,
    velocity,
    cut_cell_weights,
    num_frames: int,
    dt: float = 1.0 / 120.0,
    gravity: float = -9.8,
    solid_phi=None,
    config: SolverConfig | None = None,
    on_frame=None,
    start_frame: int = 0,
    old_pressure=None,
    checkpoint_dir=None,
    checkpoint_every: int = 0,
) -> list[FrameResult]:
    """Run `num_frames` steps, warm-starting each solve from the last
    pressure; returns per-frame results (the flipSplash loop).

    Resume support: `start_frame`/`old_pressure` continue from a
    `load_state` checkpoint; `checkpoint_dir` + `checkpoint_every` write
    one every N frames (`save_state`).
    """
    # Default resolved at CALL time (not import time), so late
    # jax_enable_x64 changes are honored by the default config.
    if config is None:
        config = SolverConfig()
    frames = []
    pressure = old_pressure
    setup = None
    for k in range(start_frame, start_frame + num_frames):
        fr = step(
            liquid_phi, velocity, cut_cell_weights, dt, gravity,
            old_pressure=pressure, solid_phi=solid_phi, config=config,
            reuse_setup=setup,
        )
        setup = fr.setup
        # Retain only the latest setup (needed for reuse): keeping one per
        # frame would accumulate the full multigrid hierarchy in HBM.
        frames.append(fr._replace(setup=None))
        liquid_phi, velocity, pressure = fr.liquid_phi, fr.velocity, fr.pressure
        if checkpoint_dir is not None and checkpoint_every and (
            (k + 1 - start_frame) % checkpoint_every == 0
        ):
            save_state(checkpoint_dir, k + 1, liquid_phi, velocity, pressure)
        if on_frame is not None:
            on_frame(k, fr)
    return frames


if __name__ == "__main__":
    import sys

    sys.exit(main())

"""Steady-state frame cost: per-frame `run()` vs fused `run_fused()`.

`run()` dispatches each frame as its own set of programs with host setup
glue in between; `run_fused` scans K frames into ONE program, so the
steady frame cost is device work (solve + advection + on-device setup
rebuild).  Both advection schemes are timed.  Needs a GPU.

Usage: python benchmarks/frames_bench.py [n] [frames] [chunk]
(defaults 128, 16, 8; prints one JSON line)
"""

from __future__ import annotations

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def log(*args):
    print(*args, file=sys.stderr, flush=True)


def main() -> None:
    import jax
    import jax.numpy as jnp

    from geometricmultigridpressuresolver_tpu.config import SolverConfig
    from geometricmultigridpressuresolver_tpu.models import sdf, simulate
    from geometricmultigridpressuresolver_tpu.utils import runtime

    runtime.require_gpu("frames_bench")
    runtime.enable_compile_cache()
    log(runtime.describe_device())

    n = int(sys.argv[1]) if len(sys.argv) > 1 else 128
    frames = int(sys.argv[2]) if len(sys.argv) > 2 else 16
    chunk = int(sys.argv[3]) if len(sys.argv) > 3 else 8

    config = SolverConfig(
        solve_dtype=jnp.float32, mg_dtype=jnp.float32,
        mg_ew_dtype=jnp.bfloat16, tolerance=1e-5, max_iterations=200,
    )

    @jax.jit
    def _scene():
        liquid_phi, velocity = sdf.splash_scene((n, n, n), xp=jnp)
        weights = sdf.open_box_weights((n, n, n), xp=jnp)
        velocity = tuple(jnp.asarray(v, dtype=jnp.float32) for v in velocity)
        return liquid_phi, velocity, weights

    phi, velocity, weights = jax.block_until_ready(_scene())
    dt = 1.0 / 120.0

    # Per-frame baseline (3 frames is enough to see the steady cost).
    t0 = time.time()
    simulate.run(phi, velocity, weights, num_frames=1, dt=dt, config=config)
    t_first = time.time() - t0
    t0 = time.time()
    base_frames = simulate.run(
        phi, velocity, weights, num_frames=3, dt=dt, config=config
    )
    per_frame_s = (time.time() - t0) / 3
    log(
        f"run(): first frame {t_first:.1f}s, steady {per_frame_s:.2f} s/frame "
        f"(iters {[f.iterations for f in base_frames]})"
    )

    # Fused: one warmup call compiles the chunk program; the timed call
    # reuses it (in-process jit cache).
    t0 = time.time()
    simulate.run_fused(
        phi, velocity, weights, num_frames=chunk, dt=dt, config=config,
        chunk=chunk,
    )
    t_warm = time.time() - t0
    log(f"run_fused warmup ({chunk} frames incl. compile): {t_warm:.1f}s")

    t0 = time.time()
    f_phi, f_vel, f_pressure, stats = simulate.run_fused(
        phi, velocity, weights, num_frames=frames, dt=dt, config=config,
        chunk=chunk,
    )
    jax.block_until_ready(f_pressure)
    fused_per_frame = (time.time() - t0) / frames
    log(
        f"run_fused steady (semi-Lagrangian): {fused_per_frame:.3f} s/frame "
        f"over {frames} frames (iters {list(stats['iterations'])})"
    )

    # The gather-free advection scheme (config.advection="upwind"): the
    # semi-Lagrangian backtrace is 8 arbitrary-index gathers per field,
    # upwind is shift/select stencil arithmetic.
    import dataclasses

    config_up = dataclasses.replace(config, advection="upwind")
    simulate.run_fused(
        phi, velocity, weights, num_frames=chunk, dt=dt, config=config_up,
        chunk=chunk,
    )
    t0 = time.time()
    u_phi, u_vel, u_pressure, ustats = simulate.run_fused(
        phi, velocity, weights, num_frames=frames, dt=dt, config=config_up,
        chunk=chunk,
    )
    jax.block_until_ready(u_pressure)
    upwind_per_frame = (time.time() - t0) / frames
    log(
        f"run_fused steady (upwind): {upwind_per_frame:.3f} s/frame "
        f"(iters {list(ustats['iterations'])})"
    )

    print(
        json.dumps(
            {
                "metric": f"{n}^3 simulation steady frame cost",
                "per_frame_s": round(per_frame_s, 3),
                "fused_per_frame_s": round(fused_per_frame, 3),
                "fused_upwind_per_frame_s": round(upwind_per_frame, 3),
                "speedup": round(per_frame_s / fused_per_frame, 2),
                "fused_fps": round(1.0 / fused_per_frame, 2),
                "upwind_fps": round(1.0 / upwind_per_frame, 2),
                "iters": [int(i) for i in stats["iterations"]],
                "upwind_iters": [int(i) for i in ustats["iterations"]],
                "max_divergence": float(max(stats["max_divergence"])),
            }
        )
    )


if __name__ == "__main__":
    main()

"""Tracing / profiling: per-stage timings and an instrumented solve.

The reference has two observability mechanisms (SURVEY.md section 5):
`UT_StopWatch` wall-clock prints around every V-cycle stage and CG sub-step,
enabled by a `doPrintStats` flag
(Source/HDK_GeometricMultigridPoissonSolver.cpp:436-877,
Source/HDK_GeometricCGPoissonSolver.h:46-195), and Houdini performance
monitor events naming each pipeline phase
(Source/HDK_GeometricFreeSurfacePressureSolver.cpp:264-668).

Equivalents here, keeping the same stage taxonomy:

  * `StageTimer`    -- named wall-clock stages with device synchronization
                       (the UT_StopWatch / UT_PerfMonAutoSolveEvent analogue);
  * `instrumented_solve` -- an eager PCG loop with each sub-step (mat-vec,
                       dots, axpy, preconditioner) jitted separately and
                       timed, printing per-iteration residuals like the
                       reference's `doPrintStats` path;
  * `vcycle_stage_times` -- per-level smoother / residual+restrict /
                       coarse-solve / prolong timings for one V-cycle;
  * `trace`         -- context manager around `jax.profiler` for XLA-level
                       traces (the deep-dive tool the reference lacks).

The production solve (`solver.mgpcg.solve`) stays a single fused XLA
computation; instrumentation runs the same jitted stage functions outside
`lax.while_loop`, so stage timings reflect real kernel costs (plus dispatch
overhead, reported separately via the `overhead` field).
"""

from __future__ import annotations

import contextlib
import functools
import time
from dataclasses import dataclass, field
from typing import Callable

import jax
import jax.numpy as jnp

from geometricmultigridpressuresolver_tpu.config import SolverConfig
from geometricmultigridpressuresolver_tpu.ops import blas, stencil, transfer
from geometricmultigridpressuresolver_tpu.solver import mg as mg_mod
from geometricmultigridpressuresolver_tpu.solver import mgpcg


@dataclass
class StageTimes:
    """Accumulated wall-clock seconds and call counts per named stage."""

    seconds: dict = field(default_factory=dict)
    calls: dict = field(default_factory=dict)

    def add(self, name: str, dt: float) -> None:
        self.seconds[name] = self.seconds.get(name, 0.0) + dt
        self.calls[name] = self.calls.get(name, 0) + 1

    def report(self) -> str:
        total = sum(self.seconds.values())
        lines = [f"{'stage':<40}{'calls':>7}{'total s':>12}{'avg ms':>12}"]
        for name, s in sorted(self.seconds.items(), key=lambda kv: -kv[1]):
            n = self.calls[name]
            lines.append(f"{name:<40}{n:>7}{s:>12.4f}{1e3 * s / n:>12.3f}")
        lines.append(f"{'TOTAL':<40}{'':>7}{total:>12.4f}")
        return "\n".join(lines)


class StageTimer:
    """Wall-clock stage timing with device synchronization.

    Usage::

        timer = StageTimer()
        with timer.stage("matvec"):
            out = apply_a(x)          # timed; block_until_ready on exit
        print(timer.times.report())
    """

    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self.times = StageTimes()
        self._last_out = None

    @contextlib.contextmanager
    def stage(self, name: str):
        if not self.enabled:
            yield self
            return
        t0 = time.perf_counter()
        yield self
        if self._last_out is not None:
            jax.block_until_ready(self._last_out)
            self._last_out = None
        self.times.add(name, time.perf_counter() - t0)

    def sync(self, out):
        """Register `out` to be block_until_ready'd when the stage exits."""
        self._last_out = out
        return out


@contextlib.contextmanager
def trace(log_dir: str):
    """XLA-level profiler trace (view with TensorBoard / xprof)."""
    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


@jax.jit
def _matvec(fine, p):
    return stencil.apply_poisson(p, fine)


@functools.partial(jax.jit, static_argnames=("config",))
def _precondition(prob, r, config):
    if config.use_mg_preconditioner:
        z = mg_mod.v_cycle(
            prob.hier,
            jnp.zeros_like(r, dtype=config.mg_dtype_resolved),
            r,
            config,
            use_initial_guess=False,
        )
        return z.astype(r.dtype)
    return prob.fine.inv_diag * r


@jax.jit
def _dot(solvable, x, y):
    return blas.dot(x, y, solvable)


@jax.jit
def _norm2(solvable, x):
    return blas.squared_l2_norm(x, solvable)


@jax.jit
def _update_x_r(solvable, x, r, p, ap, alpha):
    return x + alpha * p, jnp.where(solvable, r - alpha * ap, r)


@jax.jit
def _update_p(z, p, beta):
    return z + beta * p


def _jit_stages(problem: mgpcg.PoissonProblem, config: SolverConfig):
    """Separately jitted CG sub-steps (the reference's timed functor pack).

    The stage programs live at module level, so a second instrumented
    solve of the same shapes reuses their executables.  The problem pytree
    is passed as a jit ARGUMENT (closing over it would embed the
    coefficient grids in the program as constants).
    """
    solvable = problem.fine.solvable
    return (
        lambda p: _matvec(problem.fine, p),
        lambda r: _precondition(problem, r, config),
        lambda x, y: _dot(solvable, x, y),
        lambda x: _norm2(solvable, x),
        lambda x, r, p, ap, alpha: _update_x_r(solvable, x, r, p, ap, alpha),
        _update_p,
    )


def instrumented_solve(
    problem: mgpcg.PoissonProblem,
    rhs: jax.Array,
    x0: jax.Array | None = None,
    config: SolverConfig | None = None,
    print_stats: bool = True,
    printer: Callable[[str], None] = print,
) -> tuple[jax.Array, StageTimes]:
    """Eager PCG with per-sub-step timing and per-iteration residual prints.

    The observability path of the reference's CG driver
    (Source/HDK_GeometricCGPoissonSolver.h:46-195): every mat-vec, dot,
    axpy, and preconditioner application is timed; the relative residual is
    printed each iteration with fixed precision.  Numerically identical to
    `solver.mgpcg.solve` (same jitted stage functions, same update order).

    Returns (solution, stage_times).
    """
    # Default resolved at CALL time (not import time), so late
    # jax_enable_x64 changes are honored by the default config.
    if config is None:
        config = SolverConfig()
    dtype = config.solve_dtype
    b = rhs.astype(dtype)
    x = jnp.zeros_like(b) if x0 is None else x0.astype(dtype)
    solvable = problem.fine.solvable

    matvec, precondition, dot, norm2, update_x_r, update_p = _jit_stages(
        problem, config
    )
    timer = StageTimer()

    with timer.stage("norm(b)"):
        b_norm2 = float(timer.sync(norm2(b)))
    if b_norm2 == 0.0:
        if print_stats:
            printer("zero RHS: returning zero solution")
        return jnp.zeros_like(b), timer.times
    threshold = config.tolerance**2 * b_norm2

    with timer.stage("initial residual"):
        r = timer.sync(jnp.where(solvable, b - matvec(x), jnp.zeros_like(b)))
    with timer.stage("preconditioner"):
        z = timer.sync(precondition(r))
    with timer.stage("dot"):
        rho = float(timer.sync(dot(r, z)))
    with timer.stage("norm(r)"):
        rr = float(timer.sync(norm2(r)))
    p = z

    iteration = 0
    while rr > threshold and iteration < config.max_iterations:
        with timer.stage("matvec"):
            ap = timer.sync(matvec(p))
        with timer.stage("dot"):
            denom = float(timer.sync(dot(p, ap)))
        alpha = rho / denom if denom != 0 else 0.0
        with timer.stage("axpy"):
            x, r = update_x_r(x, r, p, ap, jnp.asarray(alpha, dtype=dtype))
            timer.sync(r)
        with timer.stage("preconditioner"):
            z = timer.sync(precondition(r))
        with timer.stage("dot"):
            rho_new = float(timer.sync(dot(r, z)))
        beta = rho_new / rho if rho != 0 else 0.0
        with timer.stage("axpy"):
            p = timer.sync(update_p(z, p, jnp.asarray(beta, dtype=dtype)))
        with timer.stage("norm(r)"):
            rr = float(timer.sync(norm2(r)))
        rho = rho_new
        iteration += 1
        if print_stats:
            printer(
                f"iteration: {iteration}, residual: {(rr / b_norm2) ** 0.5:.10f}"
            )

    if print_stats:
        printer(
            f"iterations: {iteration}, relative residual: "
            f"{(rr / b_norm2) ** 0.5:.10e}"
        )
        printer(timer.times.report())
    return x, timer.times


def vcycle_stage_times(
    hier: mg_mod.MGHierarchy,
    b: jax.Array,
    config: SolverConfig | None = None,
    warmup: int = 1,
    reps: int = 3,
) -> StageTimes:
    """Per-stage timings of one V-cycle, per level.

    The reference's per-stage stopwatch prints in applyVCycle
    (Source/HDK_GeometricMultigridPoissonSolver.cpp:436-877): boundary+
    interior smoother, residual+restrict, coarse direct solve, prolong+
    smooth, each per level.  Stage functions are jitted separately and the
    data flow of a real V-cycle is replayed `reps` times.
    """
    # Default resolved at CALL time (not import time), so late
    # jax_enable_x64 changes are honored by the default config.
    if config is None:
        config = SolverConfig()
    nlev = hier.num_levels
    dtype = hier.levels[0].diag.dtype
    if config.transfer_mode == "mm":
        restrict, prolong_add = transfer.restrict_mm, transfer.prolong_add_mm
    else:
        restrict, prolong_add = transfer.restrict, transfer.prolong_add

    smooth = jax.jit(
        mg_mod._smooth_level, static_argnames=("config", "forward")
    )

    @jax.jit
    def res_restrict(x, rhs, level_coeffs, coarse_solvable):
        r = stencil.residual(x, rhs, level_coeffs)
        return restrict(r, coarse_solvable)

    coarse = jax.jit(mg_mod.coarse_solve)
    prolong = jax.jit(prolong_add)

    times = StageTimes()
    for rep in range(warmup + reps):
        timer = StageTimer()
        rhs = [b.astype(dtype)] + [None] * (nlev - 1)
        sols = [None] * nlev
        for level in range(nlev - 1):
            c = hier.levels[level]
            xl = jnp.zeros(c.shape, dtype=dtype)
            with timer.stage(f"L{level} smooth (down)"):
                xl = timer.sync(
                    smooth(xl, rhs[level], c, config=config, forward=True)
                )
            sols[level] = xl
            with timer.stage(f"L{level} residual+restrict"):
                rhs[level + 1] = timer.sync(
                    res_restrict(xl, rhs[level], c, hier.levels[level + 1].solvable)
                )
        with timer.stage(f"L{nlev - 1} coarse direct solve"):
            sols[nlev - 1] = timer.sync(coarse(hier, rhs[nlev - 1]))
        for level in range(nlev - 2, -1, -1):
            c = hier.levels[level]
            with timer.stage(f"L{level} prolong"):
                xl = timer.sync(
                    prolong(sols[level], sols[level + 1], c.solvable)
                )
            with timer.stage(f"L{level} smooth (up)"):
                sols[level] = timer.sync(
                    smooth(xl, rhs[level], c, config=config, forward=False)
                )
        if rep >= warmup:
            for name, s in timer.times.seconds.items():
                times.add(name, s)
    return times

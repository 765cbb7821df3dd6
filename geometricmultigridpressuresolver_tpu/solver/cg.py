"""Matrix-free preconditioned conjugate gradient (JAX).

Equivalent of the reference's grid-form PCG
`solveGeometricConjugateGradient` (Source/HDK_GeometricCGPoissonSolver.h:18-207):
textbook PCG over grid "vectors" with injected functors for A*x and the
preconditioner, convergence test ||r||^2 < tol^2 * ||b||^2 (h:58-64),
zero-RHS and already-converged early-outs (h:36-64), and an optional
null-space projection for all-Neumann problems
(reference Source/HDK_Utilities.h:197-297).

The dynamic iteration count runs under `jax.lax.while_loop`, so the whole
solve jits into a single XLA computation; reductions use a fixed tree and
are deterministic run-to-run.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp

from geometricmultigridpressuresolver_tpu.ops import blas


class CGResult(NamedTuple):
    x: jax.Array
    iterations: jax.Array       # int32
    relative_residual: jax.Array  # ||r|| / ||b|| at exit (drifted recurrence)
    converged: jax.Array        # bool
    # Per-iteration relative residual trace, opt-in via record_residuals
    # (the reference prints this line every iteration,
    # Source/HDK_GeometricCGPoissonSolver.h:159).  When enabled: a fixed
    # (max_iterations + 1,) device buffer, entry i = ||r_i|| / ||b||,
    # entries past the exit iteration NaN.  None when not recording (the
    # default), so the production pytree carries no extra leaf.
    residual_history: jax.Array | None = None


def _interrupt_flag(interrupt_check, iteration):
    """Evaluate the cooperative-interruption callback on the host.

    The reference checks `UT_Interrupt` inside every operator loop
    (Source/HDK_GeometricMultigridOperators.h:293); under jit the natural
    granularity is once per CG iteration: an ordered host callback sets a
    flag in the loop state, and the while-loop condition consumes it (side
    effects are not allowed in `cond`, so the check lives in the body).
    Opt-in -- the host round trip stalls the device once per iteration.
    """
    from jax.experimental import io_callback

    return io_callback(
        lambda it: bool(interrupt_check(int(it))),
        jax.ShapeDtypeStruct((), jnp.bool_),
        iteration,
        ordered=True,
    )


class _State(NamedTuple):
    x: jax.Array
    r: jax.Array
    p: jax.Array
    rho: jax.Array
    rr: jax.Array
    iteration: jax.Array
    interrupted: jax.Array
    history: jax.Array  # (max_iterations + 1,) squared norms, or (0,)


def _history_init(rr0, max_iterations: int, record: bool, dtype):
    """Fixed-length ||r||^2 trace buffer; (0,)-shaped when not recording."""
    if not record:
        return jnp.zeros((0,), dtype=dtype)
    h = jnp.full((max_iterations + 1,), jnp.nan, dtype=dtype)
    return h.at[0].set(rr0)


def _history_finish(history, b_norm2, record: bool):
    """Squared-norm trace -> relative-residual trace (None if disabled)."""
    if not record:
        return None
    safe = jnp.where(b_norm2 == 0, jnp.ones_like(b_norm2), b_norm2)
    return jnp.sqrt(history / safe)


def solve_pcg(
    apply_a: Callable[[jax.Array], jax.Array],
    apply_preconditioner: Callable[[jax.Array], jax.Array],
    b: jax.Array,
    solvable: jax.Array,
    x0: jax.Array | None = None,
    tolerance: float = 1e-5,
    max_iterations: int = 2500,
    project_null_space: bool = False,
    interrupt_check: Callable[[int], bool] | None = None,
    record_residuals: bool = False,
) -> CGResult:
    """PCG solve of A x = b over the solvable set.  Pure and jittable.

    `interrupt_check(iteration) -> bool` optionally enables cooperative
    cancellation (reference UT_Interrupt): checked on the host once per
    iteration; returning True stops the loop after the current iteration
    with the best solution so far (`converged` stays False).

    `record_residuals` fills CGResult.residual_history (see CGResult).
    """
    dtype = b.dtype
    x = jnp.zeros_like(b) if x0 is None else x0.astype(dtype)

    def project(v):
        return blas.project_null_space(v, solvable) if project_null_space else v

    b = project(b)
    b_norm2 = blas.squared_l2_norm(b, solvable)
    threshold = dtype.type(tolerance) ** 2 * b_norm2

    r = project(jnp.where(solvable, b - apply_a(x), jnp.zeros_like(b)))
    z = project(apply_preconditioner(r))
    rho0 = blas.dot(r, z, solvable)
    rr0 = blas.squared_l2_norm(r, solvable)

    def cond(s: _State):
        return (
            (s.rr > threshold)
            & (s.iteration < max_iterations)
            & jnp.logical_not(s.interrupted)
        )

    def body(s: _State) -> _State:
        ap = apply_a(s.p)
        denom = blas.dot(s.p, ap, solvable)
        alpha = s.rho / jnp.where(denom == 0, jnp.ones_like(denom), denom)
        x = s.x + alpha * s.p
        r = project(s.r - alpha * ap)
        z = project(apply_preconditioner(r))
        rho_new = blas.dot(r, z, solvable)
        beta = rho_new / jnp.where(s.rho == 0, jnp.ones_like(s.rho), s.rho)
        p = z + beta * s.p
        rr = blas.squared_l2_norm(r, solvable)
        interrupted = (
            _interrupt_flag(interrupt_check, s.iteration + 1)
            if interrupt_check is not None
            else s.interrupted
        )
        history = (
            s.history.at[s.iteration + 1].set(rr)
            if record_residuals
            else s.history
        )
        return _State(x, r, p, rho_new, rr, s.iteration + 1, interrupted, history)

    init = _State(
        x, r, z, rho0, rr0, jnp.int32(0), jnp.bool_(False),
        _history_init(rr0, max_iterations, record_residuals, dtype),
    )
    final = jax.lax.while_loop(cond, body, init)

    # Zero-RHS early-out (reference HDK_GeometricCGPoissonSolver.h:36-40):
    # with ||b|| = 0 the threshold is 0 and the loop never converges by the
    # residual test alone, so select the trivial solution explicitly.
    zero_rhs = b_norm2 == 0
    x_out = jnp.where(zero_rhs, jnp.zeros_like(final.x), final.x)
    safe_bnorm = jnp.where(zero_rhs, jnp.ones_like(b_norm2), b_norm2)
    rel = jnp.sqrt(final.rr / safe_bnorm)
    rel = jnp.where(zero_rhs, jnp.zeros_like(rel), rel)
    converged = zero_rhs | (final.rr <= threshold)
    iterations = jnp.where(zero_rhs, jnp.int32(0), final.iteration)
    return CGResult(
        x_out, iterations, rel, converged,
        _history_finish(final.history, b_norm2, record_residuals),
    )


def recomputed_residual_norms(apply_a, x, b, solvable):
    """Recompute ||b - Ax|| diagnostics (reference prints 'recomputed' vs
    'drifted' residuals, Source/HDK_GeometricCGPoissonSolver.h:198-206).

    Returns (relative_l2, l_infinity).
    """
    r = jnp.where(solvable, b - apply_a(x), jnp.zeros_like(b))
    b_norm = blas.l2_norm(b, solvable)
    safe = jnp.where(b_norm == 0, jnp.ones_like(b_norm), b_norm)
    return blas.l2_norm(r, solvable) / safe, blas.inf_norm(r, solvable)

"""Observability: debug solves, residual histories, profiling hooks.

The reference's observability is printf gated by compile-time flags
(``DEBUG_MODE``/``GATO_PRINTING``, gato_defines.h:24-29) plus matrix dump
helpers (gato_utils.cuh:289-404, gato_schur.cuh:915-939,985-1008) and
cudaEvent spans under ``GATO_TIMING`` (gato_schur.cuh:907-913,972-982).
Here the equivalents are runtime functions returning data:

  * :func:`solve_debug` — a full solve that also returns the condensed system
    (S, Pinv, gamma, Qinv, Rinv), the per-iteration PCG residual history, and
    the true unpreconditioned residual of the returned solution.
  * :func:`residual_history` — PCG trace on an already-condensed system.
  * :func:`trace` — context manager around ``jax.profiler`` for device-level
    traces (the cudaEvent analog; view with TensorBoard/XProf).
  * module ``logging`` via the standard library (logger name "gato_tpu").
"""

from __future__ import annotations

import contextlib
import logging
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

from . import assemble, recover
from .blocktri import btd_matvec
from .formats import KKTBlocks
from .problem import ProblemSpec, SolverOptions
from .solver import SolveResult

logger = logging.getLogger("gato_tpu")


class DebugResult(NamedTuple):
    result: SolveResult
    system: assemble.SchurSystem   # S, Pinv, gamma, Qinv, Rinv
    eta_history: jnp.ndarray       # (max_iters+1,) |r.Pinv.r| per iteration
                                   # (padded with the final value after exit)
    final_residual_norm: jnp.ndarray  # ||gamma - S lam||_2 (true residual)


def residual_history(S, Pinv, gamma, lam0=None, *, exit_tol=1e-6,
                     max_iters=100, poly_degree=1):
    """PCG with a recorded eta trace.  Fixed-length scan (masked after
    convergence) so the history shape is static under jit.  ``poly_degree``
    composes the preconditioner exactly as pcg.pcg does, so the trace (and
    the derived iteration count) matches solve() at any degree."""
    from .pcg import _dot  # HIGHEST-precision dot: keeps the eta trace (and
    # the derived iteration count) bit-aligned with pcg.pcg on accelerators,
    # where a default-precision vdot could diverge from solve()'s.

    def apply_P(rv):
        y = btd_matvec(Pinv, rv)
        for _ in range(poly_degree - 1):
            y = y + btd_matvec(Pinv, rv - btd_matvec(S, y))
        return y

    if lam0 is None:
        lam0 = jnp.zeros_like(gamma)
    r = gamma - btd_matvec(S, lam0)
    r_tilde = apply_P(r)
    p = r_tilde
    eta = _dot(r, r_tilde)

    def step(st, _):
        lam, r, p, eta, converged = st
        live = ~converged
        upsilon = btd_matvec(S, p)
        nu = _dot(p, upsilon)
        alpha = jnp.where(nu != 0, eta / nu, 0.0)
        lam_n = lam + alpha * p
        r_n = r - alpha * upsilon
        r_tilde = apply_P(r_n)
        eta_new = _dot(r_n, r_tilde)
        conv_now = jnp.abs(eta_new) < exit_tol
        beta = jnp.where(eta != 0, eta_new / eta, 0.0)
        p_n = r_tilde + beta * p
        st = (
            jnp.where(live, lam_n, lam),
            jnp.where(live, r_n, r),
            jnp.where(live, p_n, p),
            jnp.where(live, eta_new, eta),
            converged | conv_now,
        )
        return st, jnp.abs(st[3])

    (lam, r, p, eta_f, conv), hist = jax.lax.scan(
        step, (lam0, r, p, eta, jnp.zeros((), bool)), None,
        length=int(max_iters),
    )
    return lam, jnp.concatenate([jnp.abs(eta)[None], hist]), conv


def solve_debug(
    spec: ProblemSpec,
    blocks: KKTBlocks,
    options: SolverOptions = SolverOptions(),
    lam0: Optional[jnp.ndarray] = None,
) -> DebugResult:
    """Instrumented solve: everything the reference's GATO_PRINTING dumps
    (dense S, Pinv, gamma — gato_schur.cuh:985-1008) plus residual history,
    returned as arrays instead of printed."""
    dtype = jnp.dtype(options.dtype)
    b = KKTBlocks(*(jnp.asarray(a, dtype=dtype) for a in blocks))
    K, s = b.Q.shape[0], b.Q.shape[1]
    if lam0 is None or not options.warm_start:
        lam0 = jnp.zeros((K, s), dtype=dtype)
    else:
        lam0 = jnp.asarray(lam0, dtype=dtype).reshape(K, s)

    sys = assemble.condense(b.Q, b.R, b.A, b.B, b.q, b.r, b.c,
                            jnp.asarray(options.rho, dtype),
                            options.preconditioner)
    lam, hist, conv = residual_history(
        sys.S, sys.Pinv, sys.gamma, lam0,
        exit_tol=options.exit_tol, max_iters=options.max_iters,
        poly_degree=options.precond_poly_degree,
    )
    below = hist[1:] < options.exit_tol
    iters = jnp.where(
        jnp.any(below), jnp.argmax(below), jnp.asarray(options.max_iters)
    ).astype(jnp.int32)
    dz_x, dz_u = recover.recover_dz(sys.Qinv, sys.Rinv, b.A, b.B, b.q, b.r, lam)
    true_res = jnp.linalg.norm(sys.gamma - btd_matvec(sys.S, lam))
    result = SolveResult(lam=lam, dz_x=dz_x, dz_u=dz_u, iters=iters,
                         converged=conv, eta=hist[-1])
    logger.debug(
        "solve_debug %s: iters=%s converged=%s true_residual=%s",
        spec, iters, conv, true_res,
    )
    return DebugResult(result=result, system=sys, eta_history=hist,
                       final_residual_norm=true_res)


@contextlib.contextmanager
def trace(log_dir: str = "gato_trace"):
    """Device-level profiler span (the cudaEvent/GATO_TIMING analog).

    Usage::

        with gato_tpu.debug.trace("traces/solve"):
            solve(...)
        # then: tensorboard --logdir traces/solve
    """
    jax.profiler.start_trace(log_dir)
    try:
        yield log_dir
    finally:
        jax.profiler.stop_trace()
        logger.info("profiler trace written to %s", log_dir)

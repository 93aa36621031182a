"""Preconditioned conjugate gradient on the block-tridiagonal Schur system.

The reference runs PCG as a single cooperative CUDA kernel with grid-wide
barriers between phases and atomicAdd all-reduces for the dot products
(``parallelPCG``/``parallelPCG_fixed``, gato_pcg.cuh:17-470).  Both kernel
variants (shared-mem-resident vs HBM-restreamed) collapse here into one
``lax.while_loop`` over whole-trajectory arrays: XLA's dataflow supplies every
barrier and ``jnp.vdot`` is the all-reduce.  kernels/pcg_triton.py runs the
same iteration as one Pallas program per problem.

Algorithm (identical to gato_pcg.cuh:272-439, modulo the global sign flip
documented in assemble.py):

    r_0 = gamma - S lambda_0        (lambda_0 = 0 unless warm started; the
                                     reference zeroes lambda unconditionally,
                                     gato_pcg.cuh:296-304 — warm start works here)
    r~ = Pinv r;  p = r~;  eta = r . r~
    repeat up to max_iters:
        upsilon = S p
        nu    = p . upsilon
        alpha = eta / nu
        lambda += alpha p;  r -= alpha upsilon
        r~ = Pinv r;  eta_new = r . r~
        exit if |eta_new| < exit_tol        <- preconditioned residual dot,
                                               not a norm (gato_pcg.cuh:404)
        beta = eta_new / eta;  p = r~ + beta p;  eta = eta_new

Iteration count semantics match the reference exactly: the count is the 0-based
loop index at which the exit test fired, or ``max_iters`` if it never did
(gato_pcg.cuh:311-313, 404-411).

Robustness deviation (documented): when ``nu == 0`` (e.g. gamma == 0 so p == 0)
the reference produces 0/0 = NaN; here alpha is forced to 0, so a zero rhs
converges to lambda = 0 in one iteration.

All state updates are masked by the convergence flag, so this function is
``vmap``-safe: under vmap the loop runs until every problem in the batch has
converged, and already-converged problems stop changing (the reference has no
batch mode at all).
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import jax
import jax.numpy as jnp

from .blocktri import btd_matvec


class PCGResult(NamedTuple):
    lam: jnp.ndarray        # (K, s)  solution
    iters: jnp.ndarray      # ()      int32, reference counting semantics
    converged: jnp.ndarray  # ()      bool
    eta: jnp.ndarray        # ()      final |r . Pinv r|


def _dot(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    return jnp.vdot(a, b, precision=jax.lax.Precision.HIGHEST)


def pcg(
    S: jnp.ndarray,
    Pinv: jnp.ndarray,
    gamma: jnp.ndarray,
    lam0: Optional[jnp.ndarray] = None,
    *,
    exit_tol: jnp.ndarray | float = 1e-6,
    max_iters: jnp.ndarray | int = 100,
    matvec: Callable[[jnp.ndarray, jnp.ndarray], jnp.ndarray] = btd_matvec,
    dot: Callable[[jnp.ndarray, jnp.ndarray], jnp.ndarray] = _dot,
    poly_degree: int = 1,
) -> PCGResult:
    """Solve S lam = gamma.  ``exit_tol`` and ``max_iters`` are runtime values
    (no retrace when they change).

    ``matvec``/``dot`` are injection points for distributed execution: the
    knot-sharded path (parallel/sharded.py) passes a ppermute-halo matvec and a
    psum-reducing dot, turning this same loop into a multi-device solver —
    the analog of the reference's cooperative-kernel barriers and atomicAdd
    all-reduces.

    ``poly_degree`` composes the preconditioner polynomially (see
    SolverOptions.precond_poly_degree):  M_d r = P sum_{i<d} (I - S P)^i r,
    evaluated in Horner form — y_1 = P r; y_{j+1} = y_j + P (r - S y_j).
    Degree 1 is the reference's plain application (gato_pcg.cuh:341-346).
    """

    def apply_P(r):
        y = matvec(Pinv, r)
        for _ in range(poly_degree - 1):
            y = y + matvec(Pinv, r - matvec(S, y))
        return y
    dt = gamma.dtype
    max_iters = jnp.asarray(max_iters, jnp.int32)
    exit_tol = jnp.asarray(exit_tol, dt)

    if lam0 is None:
        lam = jnp.zeros_like(gamma)
        rvec = gamma
    else:
        lam = lam0.astype(dt)
        rvec = gamma - matvec(S, lam)

    r_tilde = apply_P(rvec)
    p = r_tilde
    eta = dot(rvec, r_tilde)

    class _State(NamedTuple):
        lam: jnp.ndarray
        r: jnp.ndarray
        p: jnp.ndarray
        eta: jnp.ndarray
        it: jnp.ndarray
        n_iters: jnp.ndarray
        converged: jnp.ndarray

    def cond(st: _State):
        return (st.it < max_iters) & ~st.converged

    def body(st: _State) -> _State:
        upsilon = matvec(S, st.p)
        nu = dot(st.p, upsilon)
        alpha = jnp.where(nu != 0, st.eta / nu, jnp.zeros_like(nu))
        lam = st.lam + alpha * st.p
        rvec = st.r - alpha * upsilon
        r_tilde = apply_P(rvec)
        eta_new = dot(rvec, r_tilde)
        conv_now = jnp.abs(eta_new) < exit_tol

        beta = jnp.where(st.eta != 0, eta_new / st.eta, jnp.zeros_like(eta_new))
        p = r_tilde + beta * st.p

        live = ~st.converged  # vmap safety: freeze converged problems
        return _State(
            lam=jnp.where(live, lam, st.lam),
            r=jnp.where(live, rvec, st.r),
            p=jnp.where(live, p, st.p),
            eta=jnp.where(live, eta_new, st.eta),
            it=st.it + jnp.where(live, 1, 0).astype(jnp.int32),
            n_iters=jnp.where(
                live & conv_now, st.it, st.n_iters
            ).astype(jnp.int32),
            converged=st.converged | conv_now,
        )

    init = _State(
        lam=lam,
        r=rvec,
        p=p,
        eta=eta,
        it=jnp.zeros((), jnp.int32),
        n_iters=max_iters,  # reference initializes iters to maxIters
        converged=jnp.zeros((), bool),
    )
    final = jax.lax.while_loop(cond, body, init)
    return PCGResult(
        lam=final.lam,
        iters=final.n_iters,
        converged=final.converged,
        eta=jnp.abs(final.eta),
    )

"""Differentiable KKT solves via the implicit function theorem.

No reference equivalent — this is capability the JAX substrate gives that a
CUDA kernel library does not: exact gradients of the solution (lambda, dz)
with respect to every problem datum (Q, R, A, B, q, r, c, rho), with O(1)
memory (one extra KKT solve for the backward pass, instead of differentiating
through solver iterations).

Math.  The solution x = [dz; lam] satisfies M(theta) x = b(theta) with the
symmetric saddle matrix M = [[G + rho*I, C^T], [C, 0]] and b = [g; c].  For a
cotangent x_bar, the VJP is

    solve M y = x_bar                      (same system, new rhs)
    b_bar      = y
    theta_bar  = - (y (x)^T restricted to theta's sparsity), i.e.
        Q_bar[k]  = - y_zx[k] dz_x[k]^T
        R_bar[k]  = - y_zu[k] dz_u[k]^T
        rho_bar   = - y_z . dz
        A_bar[k]  = - (lam[k+1] y_zx[k]^T + y_lam[k+1] dz_x[k]^T)
        B_bar[k]  = - (lam[k+1] y_zu[k]^T + y_lam[k+1] dz_u[k]^T)
        q_bar     = y_zx,  r_bar = y_zu,  c_bar = y_lam

(the identity blocks of C are structural constants and carry no gradient).
Both the primal and the adjoint solve reuse the same condense -> block-Thomas
machinery (direct.py), so gradients are exact to f32 and jit/vmap-compose.

Primary use cases: differentiable MPC (learning costs/dynamics through the
controller), sensitivity analysis, and bilevel trajectory optimization.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from . import assemble, recover
from .direct import btd_solve_auto

_PRECISION = jax.lax.Precision.HIGHEST


def _solve_kkt(Q, R, A, B, q, r, c, rho):
    """Exact solve of the saddle system; returns (lam, dz_x, dz_u)."""
    sys = assemble.condense(Q, R, A, B, q, r, c, rho, preconditioner=None)
    lam = btd_solve_auto(sys.S, sys.gamma)
    dz_x, dz_u = recover.recover_dz(sys.Qinv, sys.Rinv, A, B, q, r, lam)
    return lam, dz_x, dz_u


@jax.custom_vjp
def kkt_solve(Q, R, A, B, q, r, c, rho):
    """Differentiable exact KKT solve: (Q,R,A,B,q,r,c,rho) -> (lam, dz_x, dz_u).

    All arrays in the block layout of formats.KKTBlocks; rho a scalar."""
    return _solve_kkt(Q, R, A, B, q, r, c, rho)


def _fwd(Q, R, A, B, q, r, c, rho):
    out = _solve_kkt(Q, R, A, B, q, r, c, rho)
    return out, (Q, R, A, B, q, r, c, rho, out)


def _bwd_core(rho, lam, dz_x, dz_u, y_lam, y_zx, y_zu):
    """Cotangent assembly shared by the single and batched VJPs — all
    knot-axis slicing via ellipsis, so (K, n) and (B, K, n) shapes both
    work.  ``rho_bar`` sums over every axis: rho is one shared scalar in
    both APIs (a batch of kkt_solve_batched shares the regularizer)."""

    def outer(a, b):  # (..., n) x (..., m) -> (..., n, m)
        return jnp.einsum("...a,...b->...ab", a, b, precision=_PRECISION)

    def sym(M):
        return 0.5 * (M + jnp.swapaxes(M, -1, -2))

    lam_next = lam[..., 1:, :]
    y_lam_next = y_lam[..., 1:, :]

    # Q and R are Hessian blocks: valid inputs are symmetric, and the solver's
    # condensation is only the true saddle solve on the symmetric manifold, so
    # the returned cotangent is the canonical symmetric gradient (identical
    # inner product against any symmetric perturbation; the antisymmetric
    # component of a raw outer-product cotangent is not well defined here).
    Q_bar = -sym(outer(y_zx, dz_x))
    R_bar = -sym(outer(y_zu, dz_u))
    rho_bar = -(
        jnp.sum(y_zx * dz_x) + jnp.sum(y_zu * dz_u)
    )
    A_bar = -(outer(lam_next, y_zx[..., :-1, :])
              + outer(y_lam_next, dz_x[..., :-1, :]))
    B_bar = -(outer(lam_next, y_zu) + outer(y_lam_next, dz_u))
    return (Q_bar, R_bar, A_bar, B_bar, y_zx, y_zu, y_lam,
            rho_bar.astype(jnp.asarray(rho).dtype))


def _bwd(res, cotangents):
    Q, R, A, B, q, r, c, rho, (lam, dz_x, dz_u) = res
    lam_bar, dz_x_bar, dz_u_bar = cotangents

    # Adjoint solve: M y = x_bar.  Same saddle system with rhs
    # g_bar-part = dz cotangents, c-part = lam cotangent.
    y_lam, y_zx, y_zu = _solve_kkt(
        Q, R, A, B, dz_x_bar, dz_u_bar, lam_bar, rho
    )
    return _bwd_core(rho, lam, dz_x, dz_u, y_lam, y_zx, y_zu)


kkt_solve.defvjp(_fwd, _bwd)


# ---------------------------------------------------------------------------
# Batched differentiable solves.


def _solve_kkt_batched(Q, R, A, B, q, r, c, rho):
    """Exact batched saddle solve (leading batch axis on every array): the
    vmapped condense -> block-direct -> recover path, with the direct
    algorithm chosen for the whole batch's width (btd_solve_auto)."""
    sys = jax.vmap(
        lambda *xs: assemble.condense(*xs, rho, None)
    )(Q, R, A, B, q, r, c)
    lam = btd_solve_auto(sys.S, sys.gamma)
    dz_x, dz_u = jax.vmap(recover.recover_dz)(
        sys.Qinv, sys.Rinv, A, B, q, r, lam)
    return lam, dz_x, dz_u


@jax.custom_vjp
def kkt_solve_batched(Q, R, A, B, q, r, c, rho):
    """Differentiable exact KKT solve over a leading batch axis:
    (B,K,s,s), ... -> (lam (B,K,s), dz_x (B,K,s), dz_u (B,K-1,c)).

    Prefer this over ``jax.vmap(kkt_solve)``: the explicit batch axis lets
    the direct-algorithm choice see the whole batch width for the forward
    AND adjoint solves, where a vmap of the single-problem path sees one
    problem.  Gradients are the same implicit-function-theorem VJP (exact
    to f32); ``rho`` is one scalar shared by the batch, and its gradient
    sums over the batch."""
    return _solve_kkt_batched(Q, R, A, B, q, r, c, rho)


def _fwd_batched(Q, R, A, B, q, r, c, rho):
    out = _solve_kkt_batched(Q, R, A, B, q, r, c, rho)
    return out, (Q, R, A, B, q, r, c, rho, out)


def _bwd_batched(res, cotangents):
    Q, R, A, B, q, r, c, rho, (lam, dz_x, dz_u) = res
    lam_bar, dz_x_bar, dz_u_bar = cotangents
    y_lam, y_zx, y_zu = _solve_kkt_batched(
        Q, R, A, B, dz_x_bar, dz_u_bar, lam_bar, rho
    )
    return _bwd_core(rho, lam, dz_x, dz_u, y_lam, y_zx, y_zu)


kkt_solve_batched.defvjp(_fwd_batched, _bwd_batched)


def solve_and_grad_example(spec, blocks, rho, loss_fn):
    """Convenience: value-and-grad of loss_fn(lam, dz_x, dz_u) w.r.t. blocks."""
    def f(Q, R, A, B, q, r, c):
        return loss_fn(*kkt_solve(Q, R, A, B, q, r, c, rho))

    return jax.value_and_grad(f, argnums=tuple(range(7)))(
        *(jnp.asarray(a) for a in blocks)
    )

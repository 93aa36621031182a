"""Block-tridiagonal linear algebra primitives (pure JAX).

Storage format: a block-tridiagonal matrix over K knot rows with (s x s) blocks
is a ``(K, 3, s, s)`` array; per row the slots are

  * ``[:, 0]`` — left  off-diagonal block  (row k, col k-1); row 0 slot unused (zero)
  * ``[:, 1]`` — main  diagonal block
  * ``[:, 2]`` — right off-diagonal block  (row k, col k+1); last row slot unused (zero)

This mirrors the reference's device layout written by ``store_block_bd``
(gato_utils.cuh:44-73) so every kernel has a 1:1 analog here, but the semantics
here are functional: the "halo exchange" the reference does through global
memory and grid-wide barriers (``loadBlockTriDiagonal_offDiagonal`` +
``grid.sync()``, gato_utils.cuh:121-251) becomes a pair of static shifts, and
XLA's dataflow provides every barrier for free.

Edge handling is exact: row 0 has no left neighbor and row K-1 no right
neighbor (zero-padded shifts).  The reference's strided PCG variant has an
off-by-one here (its last-row test compares against KNOT_POINTS instead of
KNOT_POINTS-1, gato_utils.cuh:202,232) that this implementation does not
reproduce.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

# Small-matrix math must not be downcast (a float32 product may otherwise run in
# TF32 on a GPU): these ops are latency-bound, not FLOP-bound, so always request
# full f32 precision.
_PRECISION = jax.lax.Precision.HIGHEST


def halo_stack(x: jnp.ndarray) -> jnp.ndarray:
    """(K, s) vector segments -> (K, 3, s) halo stack [x_{k-1}, x_k, x_{k+1}].

    Out-of-range neighbors are zero — the functional equivalent of the
    reference's neighbor loads with edge special-casing (gato_utils.cuh:121-151).
    """
    zero = jnp.zeros_like(x[:1])
    xm = jnp.concatenate([zero, x[:-1]], axis=0)
    xp = jnp.concatenate([x[1:], zero], axis=0)
    return jnp.stack([xm, x, xp], axis=1)


def btd_matvec(S: jnp.ndarray, x: jnp.ndarray) -> jnp.ndarray:
    """y_k = L_k x_{k-1} + D_k x_k + U_k x_{k+1} for an (K,3,s,s) operator.

    One einsum over the halo stack: a batched small matvec that XLA fuses
    with its neighbors (reference: matVecMultBlockTriDiagonal,
    gato_utils.cuh:153-185).
    """
    xh = halo_stack(x)
    return jnp.einsum("kjab,kjb->ka", S, xh, precision=_PRECISION)


def btd_transpose(S: jnp.ndarray) -> jnp.ndarray:
    """Transpose of a block-tridiagonal operator in (K,3,s,s) form.

    (S^T)_k,left = (S_{k-1},right)^T etc.  Used by tests and the symmetric-stair
    preconditioner checks.
    """
    Lt = jnp.swapaxes(S[:, 0], -1, -2)
    Dt = jnp.swapaxes(S[:, 1], -1, -2)
    Ut = jnp.swapaxes(S[:, 2], -1, -2)
    zero = jnp.zeros_like(Lt[:1])
    new_left = jnp.concatenate([zero, Ut[:-1]], axis=0)
    new_right = jnp.concatenate([Lt[1:], zero], axis=0)
    return jnp.stack([new_left, Dt, new_right], axis=1)


def btd_to_dense(S) -> jnp.ndarray:
    """(K,3,s,s) -> dense (K*s, K*s).  Test oracle helper."""
    import numpy as np

    S = np.asarray(S)
    K, _, s, _ = S.shape
    out = np.zeros((K * s, K * s), dtype=S.dtype)
    for k in range(K):
        out[k * s : (k + 1) * s, k * s : (k + 1) * s] = S[k, 1]
        if k > 0:
            out[k * s : (k + 1) * s, (k - 1) * s : k * s] = S[k, 0]
        if k < K - 1:
            out[k * s : (k + 1) * s, (k + 1) * s : (k + 2) * s] = S[k, 2]
    return out


def block_inv(M: jnp.ndarray) -> jnp.ndarray:
    """Batched small-matrix inverse, (..., n, n) -> (..., n, n).

    Unrolled Gauss-Jordan, vectorized over all leading batch dims: every step
    is a rank-1 elementwise update over the whole batch, so the batch axis is
    the parallel axis and the n (<= ~32) pivot steps are the only sequential
    part, all of it fusible elementwise work.  XLA's generic
    ``jnp.linalg.inv`` lowers to a batched pivoted LU with a per-matrix
    sequential structure that is a poor fit for tiny blocks.

    No pivoting — the same trade the reference makes in its in-shared-memory
    inversion (invertMatrix, gato_utils.cuh:468-586), and safe here for the
    same reason: every inverted block (Q+rho*I, R+rho*I, theta) is symmetric
    positive definite, so leading principal minors are nonsingular.  Falls
    back to XLA's pivoted LU for large blocks where unrolling doesn't pay.
    """
    n = M.shape[-1]
    if n > 32:
        return jnp.linalg.inv(M)
    eye = jnp.broadcast_to(jnp.eye(n, dtype=M.dtype), M.shape)
    A = jnp.concatenate([M, eye], axis=-1)  # augmented [M | I], (..., n, 2n)
    rows = jax.lax.broadcasted_iota(jnp.int32, (n, 1), 0)
    for i in range(n):
        piv = A[..., i : i + 1, i : i + 1]
        row = A[..., i : i + 1, :] / piv
        # Eliminate column i from every other row, then write the normalized
        # pivot row — with iota masks rather than scatter updates (.at lowers
        # to dynamic-update-slice, which does not fuse as well).
        f = jnp.where(rows == i, 0.0, A[..., :, i : i + 1])
        A = A - f * row
        A = jnp.where(rows == i, row, A)
    return A[..., :, n:]

"""Direct block-tridiagonal solver: block Thomas elimination via lax.scan.

No reference equivalent — the CUDA reference uses PCG because a sequential
elimination is a poor fit for a GPU grid of blocks.  Under XLA the trade is
different: a ``lax.scan`` over the knot axis runs each step as a batched
handful of (s x s) ops, so the whole factor+solve is one short sequential
sweep with *batch-parallel* steps.  For batched workloads this can beat
iterative PCG outright (no iteration count, exact answer), and for
ill-conditioned systems it is the robust fallback when PCG stalls.

Algorithm (block Thomas / block LU without inter-block pivoting) on
S = btd(L, D, U), solving S x = b:

    forward, k = 0..K-1 (L_0 = 0, U_{-1} = 0):
        w_k = L_k C_{k-1}^{-1}
        C_k = D_k - w_k U_{k-1}
        y_k = b_k - w_k y_{k-1}
    backward, k = K-1..0 (U_{K-1} = 0):
        x_k = C_k^{-1} (y_k - U_k x_{k+1})

Stable without pivoting for the symmetric positive definite Schur systems
produced by assemble.condense (same justification as blocktri.block_inv).

Because it needs no preconditioner, ``method='direct'`` solves skip the
theta inversion and symmetric-stair products entirely — about half of the
condensation work.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from .blocktri import block_inv

_PRECISION = jax.lax.Precision.HIGHEST

# Residual acceptance for ``method='direct'``: the solver is exact up to
# floating point, so ``converged`` is DERIVED from the computed residual
# rather than asserted — sqrt(eta) <= RTOL * sqrt(1 + ||gamma||^2).  Healthy
# f32 solves land at ~1e-6 relative residual (CPU property sweep);
# 1e-3 leaves two orders of headroom for ill-conditioned-but-solvable systems
# while a singular/garbage input (residual O(1) or NaN) fails it.  The
# reference has no analog (its only failure signal is process exit,
# gato_defines.h:42-51).
DIRECT_CONV_RTOL = 1e-3


def residual_converged(eta, gamma_sq):
    """``converged`` flag for exact solves: eta (squared residual norm) is
    accepted when it is small relative to 1 + ||gamma||^2.  NaN residuals
    (singular pivots on the XLA path) compare False."""
    return eta <= DIRECT_CONV_RTOL**2 * (1.0 + gamma_sq)


def _mm(a, b):
    return jnp.einsum("...ab,...bc->...ac", a, b, precision=_PRECISION)


def _mv(a, x):
    return jnp.einsum("...ab,...b->...a", a, x, precision=_PRECISION)


def btd_solve(S: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Solve the block-tridiagonal system S x = b exactly.

    Shapes: S (..., K, 3, s, s) with leading batch dims, b (..., K, s).
    The scan runs over K; every per-step op is batched over the leading dims,
    so a 256-problem batch pays the same sequential depth as a single solve.
    """
    batch_dims = b.shape[:-2]
    K, s = b.shape[-2], b.shape[-1]

    # Move the knot axis to the front for scan: (K, ..., s, s) / (K, ..., s).
    L = jnp.moveaxis(S[..., :, 0, :, :], -3, 0)
    D = jnp.moveaxis(S[..., :, 1, :, :], -3, 0)
    U = jnp.moveaxis(S[..., :, 2, :, :], -3, 0)
    bb = jnp.moveaxis(b, -2, 0)

    # U_{k-1} aligned with row k; row 0 gets zeros (no upper neighbor term).
    U_prev = jnp.concatenate([jnp.zeros_like(U[:1]), U[:-1]], axis=0)

    zero_mat = jnp.zeros(batch_dims + (s, s), dtype=b.dtype)
    zero_vec = jnp.zeros(batch_dims + (s,), dtype=b.dtype)

    def fwd(carry, xs):
        c_prev_inv, y_prev = carry
        Lk, Dk, Upk, bk = xs
        w = _mm(Lk, c_prev_inv)
        Ck = Dk - _mm(w, Upk)
        yk = bk - _mv(w, y_prev)
        ck_inv = block_inv(Ck)
        return (ck_inv, yk), (ck_inv, yk)

    (_, _), (C_inv, y) = jax.lax.scan(
        fwd, (zero_mat, zero_vec), (L, D, U_prev, bb)
    )

    def bwd(x_next, xs):
        ck_inv, yk, Uk = xs
        xk = _mv(ck_inv, yk - _mv(Uk, x_next))
        return xk, xk

    _, xs_rev = jax.lax.scan(bwd, zero_vec, (C_inv, y, U), reverse=True)
    return jnp.moveaxis(xs_rev, 0, -2)


def _pad_back_mat(x):
    return jnp.concatenate([x, jnp.zeros_like(x[..., :1, :, :])], axis=-3)


def _pad_front_mat(x):
    return jnp.concatenate([jnp.zeros_like(x[..., :1, :, :]), x], axis=-3)


def thomas_multi(L, D, U, Bm):
    """Block-Thomas solve with a MATRIX right-hand side, scan axis first.

    Shapes: L/D/U (m, ..., s, s) — the block tridiagonal along the leading
    axis, batched over the middle dims (L[0] and U[m-1] must already be
    zero); Bm (m, ..., s, nrhs).  Returns X (m, ..., s, nrhs) with T X = Bm.
    One factorization serves all nrhs columns: the forward scan's C_k / w_k
    depend only on the operator, and the rhs recurrences are
    (s, s) x (s, nrhs) products that batch over columns for free.  Shared by
    the SPIKE solvers (chunks batched here on one chip in
    :func:`btd_solve_spike`; shards over the mesh in
    parallel/sharded._btd_solve_direct_local).
    """
    U_prev = jnp.concatenate([jnp.zeros_like(U[:1]), U[:-1]], axis=0)

    def fwd(carry, xs):
        c_prev_inv, Y_prev = carry
        Lk, Dk, Upk, Bk = xs
        w = _mm(Lk, c_prev_inv)
        Ck = Dk - _mm(w, Upk)
        Yk = Bk - _mm(w, Y_prev)
        ck_inv = block_inv(Ck)
        return (ck_inv, Yk), (ck_inv, Yk)

    # Derive the zero inits from the operands (x*0, not zeros_like) so their
    # varying-axes metadata matches the scan outputs under shard_map.
    init = (D[0] * 0.0, Bm[0] * 0.0)
    _, (C_inv, Y) = jax.lax.scan(fwd, init, (L, D, U_prev, Bm))

    def bwd(X_next, xs):
        ck_inv, Yk, Uk = xs
        Xk = _mm(ck_inv, Yk - _mm(Uk, X_next))
        return Xk, Xk

    _, X = jax.lax.scan(bwd, Bm[0] * 0.0, (C_inv, Y, U), reverse=True)
    return X


def btd_solve_cr(S: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Solve S x = b by block cyclic reduction — the parallel direct solver.

    Same contract as :func:`btd_solve`, different depth/width trade: block
    Thomas is a length-K sequential sweep whose steps are tiny, while cyclic
    reduction eliminates all odd rows at once per level — ceil(log2 K) levels
    of fully batched (m, s, s) inversions and products.  CR trades ~2x the
    flops of Thomas for log-depth, so it wins where the computation is
    depth-bound — on a GPU, where every scan step of Thomas is a launch of
    its own — :func:`btd_solve_auto` picks per device.  Same no-pivoting SPD justification; CR's reduced systems are
    Schur complements of SPD systems, hence SPD themselves.

    Per level, with odd rows j (D_o, L_o, U_o, b_o) and even rows i:

        A = L_e D_{o,left}^{-1},   B = U_e D_{o,right}^{-1}
        L' = -A L_{o,left}         U' = -B U_{o,right}
        D' = D_e - A U_{o,left} - B L_{o,right}
        b' = b_e - A b_{o,left} - B b_{o,right}

    and back-substitution x_odd = D_o^{-1}(b_o - L_o x_left - U_o x_right).
    Structural zeros at the boundary rows (L_0, U_{K-1}) are preserved by
    construction, so no masking is needed at any level.
    """
    L = S[..., :, 0, :, :]
    D = S[..., :, 1, :, :]
    U = S[..., :, 2, :, :]
    bb = b

    levels = []
    while D.shape[-3] > 1:
        Do = D[..., 1::2, :, :]
        Lo = L[..., 1::2, :, :]
        Uo = U[..., 1::2, :, :]
        bo = bb[..., 1::2, :]
        De = D[..., 0::2, :, :]
        Le = L[..., 0::2, :, :]
        Ue = U[..., 0::2, :, :]
        be = bb[..., 0::2, :]
        me = De.shape[-3]
        mo = Do.shape[-3]
        Doinv = block_inv(Do)
        levels.append((Doinv, Lo, Uo, bo, D.shape[-3]))

        # Left odd neighbor of even t is odd t-1 (zero pad for t=0); right
        # odd neighbor is odd t (zero pad when m is odd and t = me-1).
        DoinvL = _pad_front_mat(Doinv)[..., :me, :, :]
        LoL = _pad_front_mat(Lo)[..., :me, :, :]
        UoL = _pad_front_mat(Uo)[..., :me, :, :]
        boL = jnp.concatenate(
            [jnp.zeros_like(bo[..., :1, :]), bo], axis=-2)[..., :me, :]
        if mo < me:
            DoinvR = _pad_back_mat(Doinv)
            LoR = _pad_back_mat(Lo)
            UoR = _pad_back_mat(Uo)
            boR = jnp.concatenate(
                [bo, jnp.zeros_like(bo[..., :1, :])], axis=-2)
        else:
            DoinvR, LoR, UoR, boR = Doinv, Lo, Uo, bo

        A = _mm(Le, DoinvL)
        Bm = _mm(Ue, DoinvR)
        L = -_mm(A, LoL)
        U = -_mm(Bm, UoR)
        D = De - _mm(A, UoL) - _mm(Bm, LoR)
        bb = be - _mv(A, boL) - _mv(Bm, boR)

    x = _mv(block_inv(D), bb)  # (..., 1, s)

    for Doinv, Lo, Uo, bo, m in reversed(levels):
        mo = bo.shape[-2]
        me = x.shape[-2]
        # x_left of odd t is even t; x_right is even t+1 (zero past the end).
        x_pad = jnp.concatenate([x, jnp.zeros_like(x[..., :1, :])], axis=-2)
        x_right = x_pad[..., 1 : mo + 1, :]
        x_odd = _mv(Doinv, bo - _mv(Lo, x[..., :mo, :]) - _mv(Uo, x_right))
        if mo < me:
            x_odd = jnp.concatenate(
                [x_odd, jnp.zeros_like(x_odd[..., :1, :])], axis=-2)
        x = jnp.stack([x, x_odd], axis=-2).reshape(
            x.shape[:-2] + (2 * me, x.shape[-1]))[..., :m, :]

    return x


def btd_solve_auto(S: jnp.ndarray, b: jnp.ndarray,
                   use_cr: "bool | None" = None) -> jnp.ndarray:
    """Dispatched direct solve: cyclic reduction or block Thomas, as
    dispatch.choose_backend picks for this device (``use_cr`` forces the
    choice).  Both are exact; only speed is at stake."""
    if use_cr is None:
        from .dispatch import choose_backend

        use_cr = choose_backend("direct", None, dtype=b.dtype,
                                K=b.shape[-2]) == "cr"
    return btd_solve_cr(S, b) if use_cr else btd_solve(S, b)

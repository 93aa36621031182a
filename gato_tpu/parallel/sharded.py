"""Knot-axis and batch-axis sharding of the solver over a device mesh.

The reference's only parallel axis is knot points <-> CUDA blocks inside one
GPU, synchronized with cooperative grid barriers; its neighbor communication is
the block-tridiagonal halo read through global memory (loadBlockTriDiagonal,
gato_utils.cuh:121-251) and its all-reduce is atomicAdd on global scalars
(gato_pcg.cuh:331,357,387).  Scaling the same axis across devices:

  * halo exchange  -> ``lax.ppermute`` of the single boundary row per step
    (bandwidth-1 comm: O(s) floats per device per matvec, independent of K)
  * dot products   -> ``lax.psum``
  * barriers       -> implicit in XLA dataflow

The PCG loop itself is the *same code* as the single-device path (pcg.pcg)
with a sharded matvec/dot injected — one algorithm, two placements.

Condensation and dz recovery are left to XLA's sharding propagation: theta_k
couples only knots k-1 and k, so with inputs sharded on the knot axis XLA
inserts the one-row collective-permutes itself.  Only the iterative loop, where
naive propagation would re-gather per iteration, uses explicit shard_map.

Fleets of independent problems shard their batch axis instead
(:func:`solve_batched_dp`, :func:`solve_sequence_batched_dp`,
:func:`solve_packed_dp`): every device runs the single-device batched solve on
its shard with no cross-device communication.  Meshes are flat 1-D axes: the
algorithms need only neighbor exchange and all-reduce, which any all-to-all
interconnect serves at one rate.
"""

from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from .. import assemble, blocktri, direct, recover
from ..dispatch import choose_backend
from ..pcg import PCGResult, pcg
from ..problem import Preconditioner
from ..solver import _cached_const, _solve_batched_core

_PRECISION = jax.lax.Precision.HIGHEST


def _sharded_halo_stack(x: jnp.ndarray, axis_name: str) -> jnp.ndarray:
    """(Kl, s) local rows -> (Kl, 3, s) halo stack with cross-device neighbors.

    Devices at the mesh edge receive zeros from ppermute for missing partners,
    which is exactly the global boundary condition (rows 0 and K-1 have no
    neighbor) — correct edge handling for free, where the reference's strided
    variant has an off-by-one (gato_utils.cuh:202,232).
    """
    n = lax.axis_size(axis_name)
    # Last local row -> right neighbor; first local row -> left neighbor.
    from_left = lax.ppermute(
        x[-1:], axis_name, [(i, i + 1) for i in range(n - 1)]
    )
    from_right = lax.ppermute(
        x[:1], axis_name, [(i, i - 1) for i in range(1, n)]
    )
    xm = jnp.concatenate([from_left, x[:-1]], axis=0)
    xp = jnp.concatenate([x[1:], from_right], axis=0)
    return jnp.stack([xm, x, xp], axis=1)


def _sharded_matvec(axis_name: str):
    def matvec(S_local: jnp.ndarray, x_local: jnp.ndarray) -> jnp.ndarray:
        xh = _sharded_halo_stack(x_local, axis_name)
        return jnp.einsum("kjab,kjb->ka", S_local, xh, precision=_PRECISION)

    return matvec


def _sharded_dot(axis_name: str):
    def dot(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
        return lax.psum(
            jnp.vdot(a, b, precision=_PRECISION), axis_name
        )

    return dot


def pcg_sharded(
    mesh: Mesh,
    S: jnp.ndarray,
    Pinv: jnp.ndarray,
    gamma: jnp.ndarray,
    lam0: Optional[jnp.ndarray] = None,
    *,
    exit_tol=1e-6,
    max_iters=100,
    poly_degree: int = 1,
    axis_name: str = "knot",
) -> PCGResult:
    """PCG with the knot axis sharded over ``mesh[axis_name]``.

    K must be divisible by the axis size.  Scalar outputs (iters, converged,
    eta) are replicated — every device computes identical values because all
    decisions flow from psum'd scalars, the exact analog of every CUDA block
    reading the same atomicAdd'd eta after a grid barrier.
    """
    K = gamma.shape[0]
    n = mesh.shape[axis_name]
    if K % n:
        raise ValueError(f"knot_points={K} not divisible by mesh axis {axis_name}={n}")
    dot = _sharded_dot(axis_name)
    matvec = _sharded_matvec(axis_name)

    def body(S_l, Pinv_l, gamma_l, lam0_l):
        return pcg(
            S_l, Pinv_l, gamma_l, lam0_l,
            exit_tol=exit_tol, max_iters=max_iters,
            matvec=matvec, dot=dot, poly_degree=poly_degree,
        )

    run = jax.shard_map(
        body,
        mesh=mesh,
        in_specs=(P(axis_name), P(axis_name), P(axis_name), P(axis_name)),
        out_specs=PCGResult(
            lam=P(axis_name), iters=P(), converged=P(), eta=P()
        ),
    )

    if lam0 is None:
        lam0 = jnp.zeros_like(gamma)
    return run(S, Pinv, gamma, lam0)


# ---- Sharded EXACT solve: substructuring (SPIKE) over the mesh -------------
#
# The knot-sharded exact solver the reference cannot express (its only solver
# is the single-GPU cooperative PCG, gato_pcg.cuh): each
# shard eliminates its INTERIOR rows locally with one multi-RHS block-Thomas
# sweep (three simultaneous right-hand sides: the data b, and the two
# coupling columns to the neighbouring interface unknowns), producing one
# reduced block row per shard.  The n-row reduced block-tridiagonal interface
# system is all_gathered (3n s x s blocks — O(n s^2) floats, once per solve)
# and solved REDUNDANTLY on every device by log-depth cyclic reduction; the
# interior is then recovered locally with no further communication.  Total
# wire traffic: one ppermute of (2s+1) s-vectors + one small all_gather —
# against 2 ppermutes + 2 psums PER ITERATION for sharded PCG.
#
# Numerics: every interior system is a contiguous principal submatrix of the
# SPD Schur complement, and the reduced system is the interface Schur
# complement of those — both SPD, so block elimination without pivoting is
# stable for the same reason as direct.btd_solve (direct.py:21-22).


def _btd_solve_direct_local(S_l, b_l, *, axis_name: str):
    """Per-shard SPIKE body (inside shard_map): solve the globally block-
    tridiagonal S x = b exactly, returning this shard's x rows.

    Local layout: rows 0..Kl-2 are the INTERIOR, row Kl-1 is the INTERFACE
    unknown t_p (the last shard's t_{n-1} is simply x_{K-1}: its U block is
    the global trajectory-end zero, so its reduced row decouples on the
    right by construction — no masking).
    """
    Kl, s = b_l.shape
    L, D, U = S_l[:, 0], S_l[:, 1], S_l[:, 2]
    n = lax.axis_size(axis_name)

    # Interior operator: the couplings OUT of the interior (row 0's L to
    # t_{p-1}, row Kl-2's U to t_p) move to the V/W right-hand sides.
    m = Kl - 1
    Lint = L[:m].at[0].set(0.0)
    Uint = U[:m].at[m - 1].set(0.0)
    Dint = D[:m]

    # Stacked RHS: [b | V-cols | W-cols]  ->  x_int = y - V t_{p-1} - W t_p.
    Bm = jnp.zeros((m, s, 1 + 2 * s), b_l.dtype)
    Bm = Bm.at[:, :, 0].set(b_l[:m])
    Bm = Bm.at[0, :, 1 : 1 + s].set(L[0])
    Bm = Bm.at[m - 1, :, 1 + s :].add(U[m - 1])
    # Shared multi-rhs Thomas core (direct.thomas_multi: scan axis first, no
    # extra batch dims here; the zero inits derive from the operands so
    # their vma matches under shard_map's varying-axes tracking).
    X = direct.thomas_multi(Lint, Dint, Uint, Bm)
    y, V, W = X[:, :, 0], X[:, :, 1 : 1 + s], X[:, :, 1 + s :]

    # Reduced interface row p, from the interface equation
    #   L_l x_{Kl-2} + D_l t_p + U_l x'_0 = b_l
    # with x_{Kl-2} and the right neighbour's x'_0 written in terms of the
    # interface unknowns.  The neighbour's first-row (y', V', W') arrive by
    # one ppermute; the mesh edge receives zeros, matched by U_l = 0 there.
    first = jnp.concatenate(
        [y[0][:, None], V[0], W[0]], axis=1)           # (s, 1+2s)
    nbr = lax.ppermute(first, axis_name,
                       [(i, i - 1) for i in range(1, n)])
    y_n, V_n, W_n = nbr[:, 0], nbr[:, 1 : 1 + s], nbr[:, 1 + s :]

    L_l, D_l, U_l, b_int = L[Kl - 1], D[Kl - 1], U[Kl - 1], b_l[Kl - 1]
    mm = functools.partial(jnp.einsum, "ab,bc->ac", precision=_PRECISION)
    mv = functools.partial(jnp.einsum, "ab,b->a", precision=_PRECISION)
    L_red = -mm(L_l, V[m - 1])
    D_red = D_l - mm(L_l, W[m - 1]) - mm(U_l, V_n)
    U_red = -mm(U_l, W_n)
    b_red = b_int - mv(L_l, y[m - 1]) - mv(U_l, y_n)

    # Gather the n-row interface system and solve it redundantly everywhere
    # (log-depth CR; the system is tiny — 3n (s,s) blocks).
    S_red = lax.all_gather(
        jnp.stack([L_red, D_red, U_red], axis=0), axis_name)  # (n, 3, s, s)
    b_gath = lax.all_gather(b_red, axis_name)                  # (n, s)
    t = direct.btd_solve_cr(S_red, b_gath)                     # (n, s)

    p = lax.axis_index(axis_name)
    t_p = t[p]
    t_prev = jnp.where(p > 0, t[jnp.maximum(p - 1, 0)], 0.0)
    x_int = (y - jnp.einsum("mab,b->ma", V, t_prev, precision=_PRECISION)
             - jnp.einsum("mab,b->ma", W, t_p, precision=_PRECISION))
    return jnp.concatenate([x_int, t_p[None]], axis=0)


def btd_solve_sharded(
    mesh: Mesh,
    S: jnp.ndarray,
    b: jnp.ndarray,
    *,
    axis_name: str = "knot",
) -> jnp.ndarray:
    """Exact block-tridiagonal solve with the row axis sharded over the mesh.

    Same contract as direct.btd_solve (single problem: S (K, 3, s, s),
    b (K, s)); K must be divisible by the axis size with >= 2 rows per shard
    (a 1-row shard has no interior — that placement is the reduced system
    itself, i.e. a single-device solve).
    """
    K = b.shape[0]
    n = mesh.shape[axis_name]
    if K % n:
        raise ValueError(
            f"knot_points={K} not divisible by mesh axis {axis_name}={n}")
    if K // n < 2:
        raise ValueError(
            f"btd_solve_sharded needs >= 2 rows per shard (K={K}, mesh "
            f"{axis_name}={n}); use direct.btd_solve on one device")
    run = jax.shard_map(
        functools.partial(_btd_solve_direct_local, axis_name=axis_name),
        mesh=mesh,
        in_specs=(P(axis_name), P(axis_name)),
        out_specs=P(axis_name),
    )
    return run(S, b)


@functools.partial(
    jax.jit,
    static_argnames=("mesh", "axis_name", "poly_degree", "preconditioner",
                     "method", "backend"),
)
def _solve_batched_dp_core(
    Q, R, A, B, q, r, c, lam0, rho, exit_tol, max_iters,
    mesh: Mesh,
    axis_name: str,
    poly_degree: int,
    preconditioner: Preconditioner,
    method: str,
    backend: str,
):
    def body(Ql, Rl, Al, Bl, ql, rl, cl, l0, rho_, tol_, mi_):
        res = _solve_batched_core(
            Ql, Rl, Al, Bl, ql, rl, cl, l0, rho_, tol_, mi_,
            preconditioner, backend, method, poly_degree)
        return (PCGResult(lam=res.lam, iters=res.iters,
                          converged=res.converged, eta=res.eta),
                res.dz_x, res.dz_u)

    run = jax.shard_map(
        body,
        mesh=mesh,
        in_specs=(P(axis_name),) * 8 + (P(), P(), P()),
        out_specs=(
            PCGResult(lam=P(axis_name), iters=P(axis_name),
                      converged=P(axis_name), eta=P(axis_name)),
            P(axis_name), P(axis_name),
        ),
        # The body is embarrassingly parallel (no collectives); the loop
        # carries and the Triton kernel's outputs carry no varying-axes
        # annotation, so the check is skipped.
        check_vma=False,
    )
    return run(Q, R, A, B, q, r, c, lam0, rho, exit_tol, max_iters)


def solve_batched_dp(
    mesh: Mesh,
    Q, R, A, B, q, r, c,
    lam0=None,
    *,
    rho=0.0,
    exit_tol=1e-6,
    max_iters=100,
    poly_degree: int = 1,
    preconditioner="symmetric_stair",
    axis_name: str = "dp",
    method: str = "pcg",
):
    """Data-parallel batched solves: the problem batch shards across the mesh
    and every device runs the single-device batched solve
    (solver._solve_batched_core, backend chosen for the per-device batch) on
    its shard.  ``method='direct'`` runs exact solves instead of PCG.

    The natural multi-device deployment for MPC farms / batched QP serving:
    problems are independent, so there is NO cross-device communication at
    all, and results come back sharded the same way.  This composes
    orthogonally with the knot-axis sharding of :func:`solve_sharded`
    (which targets single problems too long for one device).  The core is
    jitted (mesh/axis/preconditioner static, scalars traced), so repeated
    serving-loop calls hit the compile cache.

    Arrays follow formats.KKTBlocks with a leading batch axis divisible by
    the mesh axis size.  Returns (PCGResult, dz_x, dz_u) with the batch axis
    sharded over ``axis_name``.
    """
    if method not in ("pcg", "direct"):
        raise ValueError(
            f"solve_batched_dp supports method in ('pcg', 'direct'); "
            f"got {method!r}")
    Bn = q.shape[0]
    n = mesh.shape[axis_name]
    if Bn % n:
        raise ValueError(
            f"batch {Bn} not divisible by mesh axis {axis_name}={n}")
    K = q.shape[1]
    dt = q.dtype
    if lam0 is None:
        lam0 = jnp.zeros_like(q)
    return _solve_batched_dp_core(
        Q, R, A, B, q, r, c, lam0,
        _cached_const(rho, dt), _cached_const(exit_tol, dt),
        _cached_const(max_iters, jnp.int32),
        mesh=mesh, axis_name=axis_name, poly_degree=poly_degree,
        preconditioner=Preconditioner(preconditioner), method=method,
        backend=choose_backend(method, None, dtype=dt, K=K,
                               poly_degree=poly_degree),
    )


@functools.partial(
    jax.jit,
    static_argnames=("mesh", "axis_name", "poly_degree", "preconditioner",
                     "backend"),
)
def _solve_sequence_batched_dp_core(
    Q, R, A, B, q, r, c, lam0, rhos, exit_tol, max_iters,
    mesh: Mesh,
    axis_name: str,
    poly_degree: int,
    preconditioner: Preconditioner,
    backend: str,
):
    from ..mpc import _solve_sequence_batched_core

    def body(Ql, Rl, Al, Bl, ql, rl, cl, l0, rhos_, tol_, mi_):
        return tuple(_solve_sequence_batched_core(
            Ql, Rl, Al, Bl, ql, rl, cl, l0, rhos_, tol_, mi_,
            preconditioner, backend, poly_degree))

    run = jax.shard_map(
        body,
        mesh=mesh,
        # Sequence arrays carry (T, B, ...): the stream axis B (axis 1)
        # shards; T stays replicated in time (the scan is per device).
        in_specs=(P(None, axis_name),) * 7 + (P(axis_name), P(), P(), P()),
        out_specs=(P(None, axis_name),) * 6,
        check_vma=False,  # embarrassingly parallel (see _solve_batched_dp_core)
    )
    return run(Q, R, A, B, q, r, c, lam0, rhos, exit_tol, max_iters)


@functools.partial(
    jax.jit,
    static_argnames=("mesh", "axis_name", "backend"),
)
def _solve_sequence_batched_dp_direct_core(
    Q, R, A, B, q, r, c, rhos,
    mesh: Mesh,
    axis_name: str,
    backend: str,
):
    """EXACT sharded farm: no warm-start carry, so the (T, B) grid folds
    into one dp batch of B*T independent solves (mpc.
    _solve_sequence_batched_direct_core over the mesh).  The fold is
    STREAM-MAJOR — (T, B) -> (B, T) -> (B*T,) — so each device's shard
    holds whole streams (all steps of B/n streams), matching the
    stream-sharded (None, dp) input layout with no cross-device
    relayout.  Per-step rhos fold into the Q/R diagonals via the SHARED
    mpc._fold_rhos (one definition for both the single-device and sharded
    exact farms)."""
    from ..mpc import _fold_rhos

    T, Bn, K, s = Q.shape[:4]
    Qr, Rr = _fold_rhos(Q, R, rhos)

    def flat(a):
        return jnp.moveaxis(a, 0, 1).reshape((Bn * T,) + a.shape[2:])

    zero = jnp.zeros((), Q.dtype)
    res, dz_x, dz_u = _solve_batched_dp_core(
        flat(Qr), flat(Rr), flat(A), flat(B), flat(q), flat(r), flat(c),
        jnp.zeros((Bn * T, K, s), Q.dtype), zero, zero,
        jnp.zeros((), jnp.int32),
        mesh=mesh, axis_name=axis_name, poly_degree=1,
        preconditioner=Preconditioner.SYMMETRIC_STAIR, method="direct",
        backend=backend,
    )

    def unflat(a):
        return jnp.moveaxis(a.reshape((Bn, T) + a.shape[1:]), 0, 1)

    return (unflat(res.lam), unflat(dz_x), unflat(dz_u),
            unflat(res.iters), unflat(res.converged), unflat(res.eta))


def solve_sequence_batched_dp(
    mesh: Mesh,
    Q, R, A, B, q, r, c,          # leading (T, B) axes on every array
    lam0=None,
    rhos=None,
    *,
    rho=0.0,
    exit_tol=1e-6,
    max_iters=100,
    poly_degree: int = 1,
    preconditioner="symmetric_stair",
    axis_name: str = "dp",
    method: str = "pcg",
):
    """An MPC farm sharded across the mesh: B warm-started streams split over
    ``mesh[axis_name]``, each device scanning its local shard of streams
    (mpc.solve_sequence_batched semantics) — zero cross-device
    communication, the fleet-serving deployment at devices x streams x
    steps scale.

    Arrays carry leading (T, B) axes; B must divide by the mesh axis size.
    ``rhos`` is per-step (T,), ``lam0`` is (B, K, s) (zeros by default).
    Returns (lam, dz_x, dz_u, iters, converged, eta) with (T, B) leading
    axes, stream-sharded over ``axis_name``.

    ``method='direct'`` runs the EXACT farm (mpc.solve_sequence_batched
    semantics): no warm-start carry, so the grid folds stream-major into
    one dp batch of B*T solves — ``lam0``/``exit_tol``/``max_iters`` are
    unused there, and ``poly_degree``/``preconditioner`` are likewise
    irrelevant to an exact solve (no PCG loop runs)."""
    if method not in ("pcg", "direct"):
        raise ValueError(
            f"solve_sequence_batched_dp supports method in ('pcg', "
            f"'direct'); got {method!r}")
    T, Bn = q.shape[0], q.shape[1]
    n = mesh.shape[axis_name]
    if Bn % n:
        raise ValueError(
            f"stream count {Bn} not divisible by mesh axis {axis_name}={n}")
    K = q.shape[2]
    dt = q.dtype
    if rhos is None:
        rhos = _cached_const(rho, dt, (T,))
    else:
        rhos = jnp.asarray(rhos, dt)
    if method == "direct":
        return _solve_sequence_batched_dp_direct_core(
            Q, R, A, B, q, r, c, rhos, mesh=mesh, axis_name=axis_name,
            backend=choose_backend("direct", None, dtype=dt, K=K),
        )
    if lam0 is None:
        lam0 = jnp.zeros_like(q[0])
    return _solve_sequence_batched_dp_core(
        Q, R, A, B, q, r, c, lam0,
        rhos, _cached_const(exit_tol, dt),
        _cached_const(max_iters, jnp.int32),
        mesh=mesh, axis_name=axis_name, poly_degree=poly_degree,
        preconditioner=Preconditioner(preconditioner),
        backend=choose_backend("pcg", None, dtype=dt, K=K,
                               poly_degree=poly_degree),
    )


@functools.partial(
    jax.jit,
    static_argnames=("mesh", "axis_name", "preconditioner", "poly_degree",
                     "method"),
)
def _solve_sharded_core(
    Q, Rp, Ap, Bp, q, rp, c, lam0, rho, exit_tol, max_iters,
    mesh: Mesh,
    axis_name: str,
    preconditioner: Preconditioner,
    poly_degree: int,
    method: str = "pcg",
):
    """ONE jitted program for the whole knot-sharded solve, zero host hops
    between stages.  Module-level jit with (mesh, axis, preconditioner)
    static: an MPC/serving loop that varies rho/tol/lam0 retraces NOTHING.
    Condensation and recovery run under XLA sharding propagation, the PCG
    loop (or the exact interface elimination) under shard_map.
    """
    if method == "direct":
        # Exact knot-sharded solve (substructuring — btd_solve_sharded):
        # condensation and recovery run under XLA sharding propagation (the
        # preconditioner is skipped entirely, as on the single-device
        # direct path), the interface elimination under
        # shard_map.  ``converged`` derives from the true residual, exactly
        # like solver._direct_result.
        sys = assemble.condense(
            Q, Rp[:-1], Ap[:-1], Bp[:-1], q, rp[:-1], c, rho, None
        )
        n = mesh.shape[axis_name]
        if q.shape[0] // n < 2:
            # 1-row shards have no interior; the reduced system is the whole
            # system — solve it in place (XLA gathers, K == n is tiny).
            lam = direct.btd_solve_auto(sys.S, sys.gamma)
        else:
            run = jax.shard_map(
                functools.partial(_btd_solve_direct_local,
                                  axis_name=axis_name),
                mesh=mesh,
                in_specs=(P(axis_name), P(axis_name)),
                out_specs=P(axis_name),
            )
            lam = run(sys.S, sys.gamma)
        resid = sys.gamma - blocktri.btd_matvec(sys.S, lam)
        eta = jnp.sum(resid * resid)
        gamma_sq = jnp.sum(sys.gamma * sys.gamma)
        res = PCGResult(
            lam=lam, iters=jnp.zeros((), jnp.int32),
            converged=direct.residual_converged(eta, gamma_sq), eta=eta,
        )
        dz_x, dz_u = recover.recover_dz(
            sys.Qinv, sys.Rinv, Ap[:-1], Bp[:-1], q, rp[:-1], res.lam
        )
        return res, dz_x, dz_u

    sys = assemble.condense(
        Q, Rp[:-1], Ap[:-1], Bp[:-1], q, rp[:-1], c, rho, preconditioner
    )
    res = pcg_sharded(
        mesh, sys.S, sys.Pinv, sys.gamma, lam0,
        exit_tol=exit_tol, max_iters=max_iters, poly_degree=poly_degree,
        axis_name=axis_name,
    )
    dz_x, dz_u = recover.recover_dz(
        sys.Qinv, sys.Rinv, Ap[:-1], Bp[:-1], q, rp[:-1], res.lam
    )
    return res, dz_x, dz_u


def solve_sharded(
    mesh: Mesh,
    Q, R, A, B, q, r, c,
    lam0=None,
    *,
    rho=0.0,
    exit_tol=1e-6,
    max_iters=100,
    preconditioner: Preconditioner = Preconditioner.SYMMETRIC_STAIR,
    poly_degree: int = 1,
    axis_name: str = "knot",
    method: str = "pcg",
):
    """Full solve with the knot axis sharded across the mesh.

    Interval arrays (R, A, B, r: K-1 entries) are padded by one zero row to
    K so every array shards evenly; the pad never contributes (zero blocks).
    The wrapper only stages inputs (device_put with the knot sharding) and
    calls the single jitted core; repeated calls with new data/scalars hit
    the jit cache.

    ``method='direct'`` runs the exact knot-sharded solver (substructuring,
    see btd_solve_sharded): one multi-RHS Thomas sweep per shard, the n-row
    interface system solved redundantly after an all_gather, no iteration.
    Condensation/recovery run under sharding propagation."""
    K, s = q.shape
    n = mesh.shape[axis_name]
    if K % n:
        raise ValueError(f"knot_points={K} not divisible by mesh axis {axis_name}={n}")
    if method not in ("pcg", "direct"):
        raise ValueError(
            f"solve_sharded supports method in ('pcg', 'direct'); got {method!r}")

    knot_sharded = NamedSharding(mesh, P(axis_name))

    def pad1(x):
        return jnp.concatenate([x, jnp.zeros_like(x[:1])], axis=0)

    dt = jnp.asarray(Q).dtype
    put = functools.partial(jax.device_put, device=knot_sharded)
    if lam0 is None:
        lam0 = jnp.zeros_like(jnp.asarray(q))
    return _solve_sharded_core(
        put(jnp.asarray(Q)), put(pad1(jnp.asarray(R))),
        put(pad1(jnp.asarray(A))), put(pad1(jnp.asarray(B))),
        put(jnp.asarray(q)), put(pad1(jnp.asarray(r))), put(jnp.asarray(c)),
        put(jnp.asarray(lam0)),
        _cached_const(rho, dt) if not isinstance(rho, jnp.ndarray) else rho,
        _cached_const(exit_tol, dt), _cached_const(max_iters, jnp.int32),
        mesh=mesh, axis_name=axis_name, preconditioner=preconditioner,
        poly_degree=poly_degree, method=method,
    )


# --------------------------------------------------------------------------
# Multi-device packed serving: one PackedKKT, batch sharded over the mesh.


def solve_packed_dp(
    mesh: Mesh,
    packed,
    options=None,
    lam0=None,
    *,
    axis_name: str = "dp",
):
    """Serve one :class:`gato_tpu.packed.PackedKKT` across the mesh.

    The pack's batch axis shards over ``axis_name`` and every device solves
    its shard (:func:`solve_batched_dp`) with zero cross-device
    communication.  Pack once, fleet-serve on every device; the warm-start
    carry (``result.lam_packed``) comes back sharded the same way, so an
    MPC serving loop never leaves the mesh.  No reference equivalent.

    Requires ``plan.batch`` divisible by the mesh axis (raises otherwise).
    Returns a PackedSolveResult (arrays sharded over ``axis_name``);
    ``.unpack()`` gives the public shapes.
    """
    from .. import packed as pk
    from ..problem import SolverOptions

    if options is None:
        options = SolverOptions()
    plan = packed.plan
    n = mesh.shape[axis_name]
    pk._check_options(options, plan, "solve_packed_dp")
    if plan.batch % n:
        raise ValueError(
            f"packed batch {plan.batch} not divisible by mesh axis "
            f"{axis_name}={n}")
    dt = plan.dtype
    # The carry comes back sharded over the axis; a cold start's zeros go
    # there too, so the first call and every carried call share one
    # executable.
    lam0 = jax.device_put(pk._packed_lam0(lam0, plan),
                          NamedSharding(mesh, P(axis_name)))
    res, dz_x, dz_u = _solve_batched_dp_core(
        *packed.blocks(), lam0,
        _cached_const(options.rho, dt),
        _cached_const(options.exit_tol, dt),
        _cached_const(options.max_iters, jnp.int32),
        mesh=mesh, axis_name=axis_name,
        poly_degree=options.precond_poly_degree,
        preconditioner=options.preconditioner, method=options.method,
        backend=choose_backend(options.method, None, dtype=dt, K=plan.K,
                               poly_degree=options.precond_poly_degree),
    )
    return pk.PackedSolveResult(
        lam_p=res.lam, dzx_p=dz_x, dzu_p=dz_u, iters=res.iters,
        converged=res.converged, eta=res.eta, plan=plan)

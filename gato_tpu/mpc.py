"""MPC-style solve sequences: many dependent solves in ONE device program.

The reference's intended MPC usage is a host loop: solve, copy lambda out,
feed it back as input_lambda with warm_start=True (gpu_library.cu:161-179 —
though its kernels then ignore the warm start, gato_pcg.cuh:296-304).  Every
hop through the host costs a dispatch and a device-to-host copy.

``solve_sequence`` runs the whole chain as a single ``lax.scan``: T solves,
each warm-started from the previous multipliers, one dispatch total.  Each
step carries its own KKT data (leading T axis — in an SQP/MPC loop the
linearization changes every step) and optionally its own rho (the
"rho updates" pattern from the reference's MPC story).

The scan body is the same condense -> PCG -> recover program as
solver._solve_batched_core; lambda stays on the device between steps.  Warm
starting typically cuts PCG iterations by 2-5x for slowly-varying problems,
and unlike the host loop no step waits on the host.
"""

from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp

from . import assemble, recover
from .formats import KKTBlocks
from .problem import Preconditioner, ProblemSpec, SolverOptions
from .solver import (SolveResult, _cached_const, _pcg_batched,
                     _solve_batched_core, resolve_backend)


def _fold_rhos(Q, R, rhos):
    """Fold per-step regularizers into the Q/R diagonals: rho only ever
    enters the system as ``G + rho*I`` (gato_schur.cuh:697,700 — bitwise
    the same addition condense performs), so folding up front lets one
    batched solve serve steps with differing regularizers.  Shared by the
    single-device exact farm below and the dp-sharded one
    (parallel.sharded._solve_sequence_batched_dp_direct_core) so the fold
    cannot silently diverge between them."""
    rr = rhos.reshape((rhos.shape[0],) + (1,) * (Q.ndim - 1))
    Qr = Q + rr * jnp.eye(Q.shape[-1], dtype=Q.dtype)
    Rr = R + rr * jnp.eye(R.shape[-1], dtype=R.dtype)
    return Qr, Rr


@functools.partial(jax.jit, static_argnames=("backend",))
def _solve_sequence_batched_direct_core(Q, R, A, B, q, r, c, rhos,
                                        backend: str):
    """EXACT sequence farm: a (T, B) grid of independent direct solves run
    as ONE batch of T*B problems — no warm-start carry exists for an exact
    solve, so the T axis has no sequential dependency and folds straight
    into the batch axis (where the PCG farm below must scan T sequentially
    to carry its warm start).  The per-step ``rhos`` are folded into the
    Q/R diagonals up front (:func:`_fold_rhos`)."""
    T, Bn, K, s = Q.shape[:4]
    Qr, Rr = _fold_rhos(Q, R, rhos)

    def flat(a):
        return a.reshape((T * Bn,) + a.shape[2:])

    zero = jnp.zeros((), Q.dtype)
    res = _solve_batched_core(
        flat(Qr), flat(Rr), flat(A), flat(B), flat(q), flat(r), flat(c),
        jnp.zeros((T * Bn, K, s), Q.dtype), zero, zero,
        jnp.zeros((), jnp.int32),
        preconditioner=Preconditioner.SYMMETRIC_STAIR, backend=backend,
        method="direct",
    )

    def unflat(a):
        return a.reshape((T, Bn) + a.shape[1:])

    return SolveResult(*(unflat(x) for x in res))


@functools.partial(
    jax.jit,
    static_argnames=("preconditioner", "backend", "poly_degree"),
)
def _solve_sequence_batched_core(
    Q, R, A, B, q, r, c,        # leading (T, Bn) axes on every array
    lam0, rhos, exit_tol, max_iters,
    preconditioner: Preconditioner,
    backend: str,
    poly_degree: int = 1,
):
    def step(lam_carry, xs):
        Qt, Rt, At, Bt, qt, rt, ct, rho_t = xs
        sys = jax.vmap(
            lambda *a: assemble.condense(*a, rho_t, preconditioner)
        )(Qt, Rt, At, Bt, qt, rt, ct)
        res = _pcg_batched(sys.S, sys.Pinv, sys.gamma, lam_carry, exit_tol,
                           max_iters, backend, poly_degree)
        dz_x, dz_u = jax.vmap(recover.recover_dz)(
            sys.Qinv, sys.Rinv, At, Bt, qt, rt, res.lam
        )
        out = SolveResult(lam=res.lam, dz_x=dz_x, dz_u=dz_u,
                          iters=res.iters, converged=res.converged,
                          eta=res.eta)
        return res.lam, out

    _, outs = jax.lax.scan(step, lam0, (Q, R, A, B, q, r, c, rhos))
    return outs


def solve_sequence_batched(
    spec: ProblemSpec,
    blocks: KKTBlocks,
    options: SolverOptions = SolverOptions(),
    lam0: Optional[jnp.ndarray] = None,
    rhos: Optional[jnp.ndarray] = None,
    pcg_backend: Optional[str] = None,
) -> SolveResult:
    """Solve a BATCH of dependent KKT sequences in lockstep — an MPC farm.

    ``blocks`` carries leading (T, B) axes on every array: B independent
    MPC/SQP problem streams, each of T dependent steps.  Every stream
    carries its own warm start across the sequence (``result.lam[t, b]``
    warm-starts step t+1 of stream b), and every step is one batched solve
    advancing all B streams at once — the serving deployment for fleets of
    controllers.  No reference equivalent (the CUDA solver handles one
    problem per call and its warm start is inoperative,
    gato_pcg.cuh:296-304).

    Args mirror :func:`solve_sequence`: ``rhos`` is per-step (T,),
    ``lam0`` is (B, K, s) (zeros by default).  Returns a SolveResult with
    leading (T, B) axes.

    ``method='direct'`` runs the farm EXACTLY: the T*B solves are
    independent (no warm-start carry exists for an exact solve), so the
    whole grid folds into ONE batched solve, with per-step ``rhos`` honored
    by diagonal folding; ``lam0`` is ignored (exact solves take no initial
    guess).
    """
    dtype = jnp.dtype(options.dtype)
    b = KKTBlocks(*(jnp.asarray(a, dtype=dtype) for a in blocks))
    if b.Q.ndim != 5:
        raise ValueError(
            f"solve_sequence_batched expects leading (T, B) axes on every "
            f"array (Q (T, B, K, s, s)); got Q shape {b.Q.shape}")
    T, Bn, K, s = b.Q.shape[0], b.Q.shape[1], b.Q.shape[2], b.Q.shape[3]
    from .formats import check_block_shapes

    check_block_shapes(spec, b, lead=(T, Bn))

    if lam0 is None:
        lam0 = _cached_const(0, dtype, (Bn, K, s))
    else:
        lam0 = jnp.asarray(lam0, dtype=dtype).reshape(Bn, K, s)
    if rhos is None:
        rhos = _cached_const(options.rho, dtype, (T,))
    else:
        rhos = jnp.asarray(rhos, dtype=dtype).reshape(T)

    if options.method == "direct":
        # EXACT farm: T*B independent solves in one batched solve — see
        # _solve_sequence_batched_direct_core.
        backend = resolve_backend(pcg_backend, options, spec)
        return _solve_sequence_batched_direct_core(
            b.Q, b.R, b.A, b.B, b.q, b.r, b.c, rhos, backend=backend)
    backend = resolve_backend(pcg_backend, options, spec)
    return _solve_sequence_batched_core(
        b.Q, b.R, b.A, b.B, b.q, b.r, b.c,
        lam0, rhos,
        _cached_const(options.exit_tol, dtype),
        _cached_const(options.max_iters, jnp.int32),
        options.preconditioner,
        backend,
        options.precond_poly_degree,
    )


def solve_sequence(
    spec: ProblemSpec,
    blocks: KKTBlocks,
    options: SolverOptions = SolverOptions(),
    lam0: Optional[jnp.ndarray] = None,
    rhos: Optional[jnp.ndarray] = None,
    pcg_backend: Optional[str] = None,
) -> SolveResult:
    """Solve T dependent KKT systems with cross-step warm starting.

    Args:
      blocks: KKTBlocks with a leading T (time/SQP-iteration) axis on every
        array.  For a fixed linearization, tile the constant blocks.
      rhos: optional per-step regularizers (T,); defaults to options.rho.
      lam0: initial multipliers (K, s); zeros by default.

    Returns a SolveResult with a leading T axis; ``result.lam[t]`` warm-starts
    solve t+1.  Note the first solve warm starts from ``lam0`` regardless of
    ``options.warm_start`` — chaining is the point of this API.

    ``method='direct'`` solves the sequence exactly: with no warm-start
    carry the T steps are independent, so they all solve IN PARALLEL as one
    batch of T problems; ``lam0`` is ignored.
    """
    dtype = jnp.dtype(options.dtype)
    b = KKTBlocks(*(jnp.asarray(a, dtype=dtype) for a in blocks))
    if b.Q.ndim != 4:
        raise ValueError(
            f"solve_sequence expects a leading T axis on every array "
            f"(Q (T, K, s, s)); got Q shape {b.Q.shape}")
    T, K, s = b.Q.shape[0], b.Q.shape[1], b.Q.shape[2]
    from .formats import check_block_shapes

    check_block_shapes(spec, b, lead=(T,))

    if lam0 is None:
        lam0 = _cached_const(0, dtype, (K, s))
    else:
        lam0 = jnp.asarray(lam0, dtype=dtype).reshape(K, s)
    if rhos is None:
        rhos = _cached_const(options.rho, dtype, (T,))
    else:
        rhos = jnp.asarray(rhos, dtype=dtype).reshape(T)

    if options.method == "direct":
        # An exact sequence has no warm-start carry: the T solves are
        # independent, so the T axis IS the batch axis.
        backend = resolve_backend(pcg_backend, options, spec)
        res = _solve_sequence_batched_direct_core(
            b.Q[:, None], b.R[:, None], b.A[:, None], b.B[:, None],
            b.q[:, None], b.r[:, None], b.c[:, None], rhos, backend=backend)
        return SolveResult(
            lam=res.lam[:, 0], dz_x=res.dz_x[:, 0], dz_u=res.dz_u[:, 0],
            iters=res.iters[:, 0], converged=res.converged[:, 0],
            eta=res.eta[:, 0],
        )
    backend = resolve_backend(pcg_backend, options, spec)
    # The single sequence is the B=1 case of the batched core (one code path
    # to maintain).
    res = _solve_sequence_batched_core(
        b.Q[:, None], b.R[:, None], b.A[:, None], b.B[:, None],
        b.q[:, None], b.r[:, None], b.c[:, None],
        lam0[None], rhos,
        _cached_const(options.exit_tol, dtype),
        _cached_const(options.max_iters, jnp.int32),
        options.preconditioner,
        backend,
        options.precond_poly_degree,
    )
    return SolveResult(
        lam=res.lam[:, 0], dz_x=res.dz_x[:, 0], dz_u=res.dz_u[:, 0],
        iters=res.iters[:, 0], converged=res.converged[:, 0],
        eta=res.eta[:, 0],
    )

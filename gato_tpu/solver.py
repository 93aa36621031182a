"""High-level solver: condense -> PCG -> recover, as one jitted function.

This is the idiomatic structured API (the reference-signature shim lives in
api.py).
The whole solve — CSR blocks already packed — is a single ``jax.jit`` program:
one dispatch from the host, workspaces managed by XLA.  The
reference re-allocates every workspace and re-launches 5 kernels per solve
(gpu_library.cu:25-83), paying allocator and launch latency each time.

Static under jit: array shapes (ProblemSpec) and the preconditioner kind.
Runtime: rho, exit_tol, max_iters, warm-start lambda — so an MPC loop that
adapts rho/tol retraces nothing (the reference needs a full CSR->dense
re-conversion per rho and a *recompile* per shape).
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from . import assemble, blocktri, pcg as pcg_mod, recover
from .dispatch import VALID_PCG_BACKENDS, choose_backend  # noqa: F401
from .formats import KKTBlocks
from .problem import Preconditioner, ProblemSpec, SolverOptions


class SolveResult(NamedTuple):
    lam: jnp.ndarray        # (K, s)   multipliers
    dz_x: jnp.ndarray       # (K, s)   state steps
    dz_u: jnp.ndarray       # (K-1, c) control steps
    iters: jnp.ndarray      # ()       PCG iterations (reference counting)
    converged: jnp.ndarray  # ()       bool
    eta: jnp.ndarray        # ()       final |r . Pinv r|

    def dz_flat(self) -> np.ndarray:
        """Interleaved [dz_x0, dz_u0, ..., dz_x_{K-1}] as the reference
        returns — one implementation of the layout (formats.interleave_dz)."""
        from .formats import interleave_dz
        from .problem import ProblemSpec

        dz_x = np.asarray(self.dz_x)
        dz_u = np.asarray(self.dz_u)
        K, s = dz_x.shape
        c = dz_u.shape[-1]
        return interleave_dz(ProblemSpec(s, c, K), dz_x, dz_u)

    def lam_flat(self) -> np.ndarray:
        return np.asarray(self.lam).reshape(-1)


def _direct_result(sys, batched: bool, backend: str):
    """Exact solve of S lam = gamma (direct.py) by the algorithm ``backend``
    names ('thomas' | 'cr').  iters=0 by definition; eta reports the squared
    true residual norm of the returned solution, and ``converged`` is derived
    from it (direct.residual_converged) — a singular/garbage system reports
    False instead of an unconditional True."""
    from . import direct

    lam = direct.btd_solve_auto(sys.S, sys.gamma, use_cr=backend == "cr")
    mv = jax.vmap(blocktri.btd_matvec) if batched else blocktri.btd_matvec
    resid = sys.gamma - mv(sys.S, lam)
    axes = tuple(range(resid.ndim - 2, resid.ndim))
    eta = jnp.sum(resid * resid, axis=axes)
    gamma_sq = jnp.sum(sys.gamma * sys.gamma, axis=axes)
    shape = resid.shape[:-2]
    return pcg_mod.PCGResult(
        lam=lam,
        iters=jnp.zeros(shape, jnp.int32),
        converged=direct.residual_converged(eta, gamma_sq),
        eta=eta,
    )


def _pcg_batched(S, Pinv, gamma, lam0, exit_tol, max_iters, backend: str,
                 poly_degree: int):
    """PCG over a leading batch axis: the Triton kernel (one program per
    problem) or XLA's while loop under vmap."""
    if backend == "triton":
        from .kernels.pcg_triton import pcg_triton

        return pcg_triton(S, Pinv, gamma, lam0, exit_tol, max_iters,
                          poly_degree=poly_degree)
    return jax.vmap(
        lambda S_, P_, g_, l_: pcg_mod.pcg(
            S_, P_, g_, l_, exit_tol=exit_tol, max_iters=max_iters,
            poly_degree=poly_degree,
        )
    )(S, Pinv, gamma, lam0)


@functools.partial(
    jax.jit,
    static_argnames=("preconditioner", "backend", "method", "poly_degree"),
)
def _solve_core(
    Q, R, A, B, q, r, c,
    lam0, rho, exit_tol, max_iters,
    preconditioner: Preconditioner,
    backend: str,
    method: str = "pcg",
    poly_degree: int = 1,
):
    precond = None if method == "direct" else preconditioner
    sys = assemble.condense(Q, R, A, B, q, r, c, rho, precond)
    if method == "direct":
        res = _direct_result(sys, batched=False, backend=backend)
    elif backend == "triton":
        res = _pcg_batched(sys.S[None], sys.Pinv[None], sys.gamma[None],
                           lam0[None], exit_tol, max_iters, backend,
                           poly_degree)
        res = pcg_mod.PCGResult(*(x[0] for x in res))
    else:
        res = pcg_mod.pcg(
            sys.S, sys.Pinv, sys.gamma, lam0,
            exit_tol=exit_tol, max_iters=max_iters,
            poly_degree=poly_degree,
        )
    dz_x, dz_u = recover.recover_dz(sys.Qinv, sys.Rinv, A, B, q, r, res.lam)
    return SolveResult(
        lam=res.lam, dz_x=dz_x, dz_u=dz_u,
        iters=res.iters, converged=res.converged, eta=res.eta,
    )


def _as_jnp(blocks: KKTBlocks, dtype) -> KKTBlocks:
    return KKTBlocks(*(jnp.asarray(a, dtype=dtype) for a in blocks))


# Device-constant cache for per-call scalars (rho, exit_tol, max_iters) and
# cold-start lambda zeros.  Without it every solve() issues fresh host->device
# transfers for values that rarely change between calls; at the IIWA shape
# those copies cost a visible share of a single solve.  The reference keeps
# its CSR inputs device-resident across the testiters loop for the same
# reason (gpu_library.cu:140-157).
_CONST_CACHE: dict = {}


def _cached_const(value, dtype, shape=None):
    key = (repr(value), str(dtype), shape)
    out = _CONST_CACHE.get(key)
    if out is None:
        if len(_CONST_CACHE) > 512:
            _CONST_CACHE.clear()
        if shape is None:
            out = jnp.asarray(value, dtype)
        else:
            out = jnp.full(shape, value, dtype)
        if isinstance(out, jax.core.Tracer):
            # solve()/solve_batched() is itself being traced (e.g. wrapped in
            # an outer jit); constants are then just graph nodes — no transfer
            # to amortize and nothing concrete to cache.
            return out
        out.block_until_ready()
        _CONST_CACHE[key] = out
    return out


def resolve_backend(pcg_backend: Optional[str], options: SolverOptions,
                    spec: ProblemSpec) -> str:
    """dispatch.choose_backend for one call of the public API."""
    return choose_backend(options.method, pcg_backend, dtype=options.dtype,
                          K=spec.knot_points,
                          poly_degree=options.precond_poly_degree)


def solve(
    spec: ProblemSpec,
    blocks: KKTBlocks,
    options: SolverOptions = SolverOptions(),
    lam0: Optional[jnp.ndarray] = None,
    pcg_backend: Optional[str] = None,
) -> SolveResult:
    """Solve one KKT system.

    Args:
      spec: static problem shape (consistency-checked against ``blocks``).
      blocks: packed KKT data (see formats.pack_kkt).
      options: runtime solver options.
      lam0: optional (K, s) warm-start multipliers; used only when
        ``options.warm_start`` — matching the reference API surface
        (gpu_library.cu:46-47), except that here warm starting actually works.
      pcg_backend: 'jax' | 'triton' | None (auto, dispatch.choose_backend).
        Unknown strings and requests this platform cannot honour raise
        ValueError.
    """
    dtype = jnp.dtype(options.dtype)
    b = _as_jnp(blocks, dtype)
    from .formats import check_block_shapes

    check_block_shapes(spec, b)
    K, s = b.Q.shape[0], b.Q.shape[1]

    if options.warm_start and lam0 is not None:
        lam0 = jnp.asarray(lam0, dtype=dtype).reshape(K, s)
    else:
        lam0 = _cached_const(0, dtype, (K, s))

    backend = resolve_backend(pcg_backend, options, spec)
    return _solve_core(
        b.Q, b.R, b.A, b.B, b.q, b.r, b.c,
        lam0,
        _cached_const(options.rho, dtype),
        _cached_const(options.exit_tol, dtype),
        _cached_const(options.max_iters, jnp.int32),
        options.preconditioner,
        backend,
        options.method,
        options.precond_poly_degree,
    )


@functools.partial(
    jax.jit,
    static_argnames=("preconditioner", "backend", "method", "poly_degree"),
)
def _solve_batched_core(
    Q, R, A, B, q, r, c, lam0, rho, exit_tol, max_iters,
    preconditioner: Preconditioner,
    backend: str,
    method: str = "pcg",
    poly_degree: int = 1,
):
    precond = None if method == "direct" else preconditioner
    sys = jax.vmap(
        lambda *xs: assemble.condense(*xs, rho, precond)
    )(Q, R, A, B, q, r, c)
    if method == "direct":
        res = _direct_result(sys, batched=True, backend=backend)
    else:
        res = _pcg_batched(sys.S, sys.Pinv, sys.gamma, lam0, exit_tol,
                           max_iters, backend, poly_degree)
    dz_x, dz_u = jax.vmap(recover.recover_dz)(
        sys.Qinv, sys.Rinv, A, B, q, r, res.lam
    )
    return SolveResult(
        lam=res.lam, dz_x=dz_x, dz_u=dz_u,
        iters=res.iters, converged=res.converged, eta=res.eta,
    )


def solve_batched(
    spec: ProblemSpec,
    blocks: KKTBlocks,
    options: SolverOptions = SolverOptions(),
    lam0: Optional[jnp.ndarray] = None,
    pcg_backend: Optional[str] = None,
) -> SolveResult:
    """Solve a batch of independent KKT systems (leading batch axis on every
    array in ``blocks``).  No reference equivalent — the CUDA solver handles
    one problem per call.

    Per-problem convergence is exact: on the XLA path problems that converge
    early stop updating while the rest of the batch iterates (masked updates
    in pcg.py); the Triton kernel runs each problem's loop in its own
    program, so each exits on its own count.
    """
    dtype = jnp.dtype(options.dtype)
    b = _as_jnp(blocks, dtype)
    if b.Q.ndim != 4:
        raise ValueError(
            f"solve_batched expects a leading batch axis on every array "
            f"(Q (B, K, s, s)); got Q shape {b.Q.shape}")
    Bn, K, s = b.Q.shape[0], b.Q.shape[1], b.Q.shape[2]
    from .formats import check_block_shapes

    check_block_shapes(spec, b, lead=(Bn,))

    if options.warm_start and lam0 is not None:
        lam0 = jnp.asarray(lam0, dtype=dtype).reshape(Bn, K, s)
    else:
        lam0 = _cached_const(0, dtype, (Bn, K, s))

    backend = resolve_backend(pcg_backend, options, spec)
    return _solve_batched_core(
        b.Q, b.R, b.A, b.B, b.q, b.r, b.c,
        lam0,
        _cached_const(options.rho, dtype),
        _cached_const(options.exit_tol, dtype),
        _cached_const(options.max_iters, jnp.int32),
        options.preconditioner,
        backend,
        options.method,
        options.precond_poly_degree,
    )

"""Device timing for solver workloads.

Library form of the benchmark methodology bench.py uses (the analog of the
reference's cudaEvent testiters loop, gpu_library.cu:166-198), exposed so
users can measure THEIR problems without the usual traps:

* JAX dispatch is asynchronous — a timing that does not wait for the result
  (``jax.block_until_ready``) measures the enqueue, not the solve;
* a fixed per-call cost (dispatch, launch, the loop predicate's read-back)
  can dwarf a small solve, so a single call says little about throughput;
* XLA hoists loop-invariant work (e.g. the whole condensation when only the
  rhs changes per step) out of timing loops, silently under-reporting any
  path it can see into.

:func:`chain_time` answers all three at once: it times a chain of T solves
INSIDE one jitted ``lax.scan`` whose per-step problem data is perturbed
(breaking invariant hoisting), waits for the result with
``block_until_ready``, and differences two chain lengths (T vs 2T) so the
fixed per-call cost cancels exactly.  :func:`time_solve` wraps it for one
(spec, blocks, options) at the public solver surface.
"""

from __future__ import annotations

import functools
import time
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from .formats import KKTBlocks
from .problem import ProblemSpec, SolverOptions


def _chain_fn(step_fn, q0, length):
    """One jitted scan of ``length`` chained cold solves.

    step_fn(q0, lam_carry, t) -> array that data-depends on the whole step."""

    @jax.jit
    def chain(q):
        def body(carry, t):
            out = step_fn(q, carry, t)
            return out, None

        out, _ = jax.lax.scan(
            body, jnp.zeros_like(q0), jnp.arange(length, dtype=jnp.float32)
        )
        return out

    return chain


def _timed(chain, q0, rep):
    q = q0 * (1.0 + 1e-6 * (rep + 1))
    t0 = time.perf_counter()
    jax.block_until_ready(chain(q))
    return (time.perf_counter() - t0) * 1e3


def _best_cluster(estimates, n):
    """Median and range of the tightest window of ``n`` consecutive sorted
    estimates — a one-off transient (host preemption, device contention)
    lands far from the cluster and is excluded instead of polluting a plain
    median/spread over everything."""
    xs = sorted(estimates)
    n = min(n, len(xs))
    best_i, best_r = 0, float("inf")
    for i in range(len(xs) - n + 1):
        r = xs[i + n - 1] - xs[i]
        if r < best_r:
            best_i, best_r = i, r
    window = xs[best_i:best_i + n]
    return float(np.median(window)), float(best_r)


def chain_time(step_fn, q0, T: int, reps: int = 7, n_independent: int = 2,
               min_diff_ms: float = 8.0, rel_spread: float = 0.2,
               max_extra: int = 4, label: str = "",
               log=None):
    """Per-step device time in ms, via T-vs-2T chain differencing.

    ``step_fn(q0, lam_carry, t)`` must run one full solve whose inputs
    depend on ``t`` and ``lam_carry`` (see :func:`time_solve` for a correct
    perturbation) and return an array that data-depends on every output to
    keep.  Runs ``n_independent`` full repetitions and returns
    (cluster_ms, info_dict with reps/spread/T).  Two robustness loops:

    * if the pilot chain difference is below ``min_diff_ms`` (noise
      territory), T is doubled — up to three times — and the measurement
      redone;
    * if the estimates disagree by more than ``rel_spread`` of their value
      (a transient stall of one rep), up to ``max_extra`` further
      independent estimates are taken
      and the tightest ``n_independent``-wide cluster is reported, so a
      one-off glitch is excluded rather than averaged in."""
    for attempt in range(4):
        c1 = _chain_fn(step_fn, q0, T)
        c2 = _chain_fn(step_fn, q0, 2 * T)
        t0 = time.perf_counter()
        jax.block_until_ready(c1(q0))  # compile + first run
        # Reference protocol (BASELINE.md): report the first run INCLUDING
        # compile alongside the steady-state average.  Re-captured on every
        # attempt (each T doubling builds and compiles fresh chains) so the
        # reported value is the FINAL T's chain, the one info['T'] names.
        first_call_ms = (time.perf_counter() - t0) * 1e3
        jax.block_until_ready(c2(q0))
        estimates = []
        diffs = []

        def one_estimate(k):
            t1 = float(np.median([_timed(c1, q0, 10 * k + r) for r in range(reps)]))
            t2 = float(np.median([_timed(c2, q0, 10 * k + r) for r in range(reps)]))
            d = t2 - t1
            diffs.append(d)
            # A stall during either chain can drive the difference
            # non-positive.  Such a measurement carries no signal; clamping
            # it to a floor would let TWO stalls form a fake zero-spread
            # "tightest cluster" of identical floor values that sails through
            # the spread check — so corrupted differences are DROPPED and
            # re-measured instead.
            if d > 0:
                estimates.append(d / T)

        def cluster():
            if not estimates:
                return 0.0, 0.0
            return _best_cluster(estimates, n_independent)

        for k in range(n_independent):
            one_estimate(k)
        if float(np.median(diffs)) >= min_diff_ms or attempt == 3:
            ms, spread = cluster()
            extra = 0
            while (len(estimates) < n_independent
                   or spread > rel_spread * ms) and extra < max_extra:
                if log is not None:
                    log(f"  [{label}] {len(estimates)} usable estimates, "
                        f"spread {spread:.4f} ms vs {ms:.4f} ms; re-measuring")
                one_estimate(n_independent + extra)
                ms, spread = cluster()
                extra += 1
            info = {
                "reps_ms": [round(e, 6) for e in estimates],
                "spread_ms": round(spread, 6),
                "T": T,
                "chain_diff_ms": round(float(np.median(diffs)), 3),
                "first_call_ms": round(first_call_ms, 1),
            }
            warnings = []
            if float(np.median(diffs)) < min_diff_ms:
                warnings.append("chain difference below noise floor")
            if len(estimates) < n_independent:
                warnings.append(
                    f"only {len(estimates)}/{n_independent} usable estimates"
                    " (non-positive chain differences dropped)")
            elif spread > rel_spread * ms:
                warnings.append(
                    f"estimates still spread {spread:.4f} ms after "
                    f"{len(estimates)} independent measurements")
            if warnings:
                info["noise_warning"] = "; ".join(warnings)
            return ms, info
        if log is not None:
            log(f"  [{label}] chain diff {np.median(diffs):.2f} ms < "
                f"{min_diff_ms} ms at T={T}; doubling T")
        T *= 2
    raise AssertionError("unreachable")


def perturb(blocks: KKTBlocks, q0, lam_carry, t):
    """Fresh problem data each chain step: breaks the execution cache AND
    XLA's loop-invariant hoisting of the condensation (perturbing only the
    rhs q lets XLA hoist the whole S/Pinv assembly out of the scan,
    under-reporting XLA-path configs ~3x — measured)."""
    scale = 1.0 + 1e-6 * jnp.cos(t) + 1e-7 * jnp.tanh(jnp.sum(lam_carry))
    Q = blocks.Q * scale
    q = q0 * (1.0 + 1e-6 * jnp.sin(t))
    return Q, q


def time_solve(
    spec: ProblemSpec,
    blocks: KKTBlocks,
    options: SolverOptions = SolverOptions(),
    pcg_backend: Optional[str] = None,
    *,
    T: int = 64,
    **chain_kwargs,
):
    """Honest per-solve device latency for one problem configuration.

    Returns (avg_ms, info): the median per-solve device time over chained
    cold solves (every step a genuinely fresh problem — Q and q perturbed),
    plus the measurement detail.  ``blocks`` may carry a leading batch axis
    (then solve_batched semantics apply and avg_ms is per BATCH; divide by
    the batch size for per-solve)."""
    from .solver import _solve_batched_core, _solve_core, resolve_backend

    dtype = jnp.dtype(options.dtype)
    b = KKTBlocks(*(jax.device_put(jnp.asarray(a, dtype=dtype))
                    for a in blocks))
    batched = b.Q.ndim == 4
    backend = resolve_backend(pcg_backend, options, spec)
    core = functools.partial(
        (_solve_batched_core if batched else _solve_core).__wrapped__,
        preconditioner=options.preconditioner,
        backend=backend,
        method=options.method,
        poly_degree=options.precond_poly_degree,
    )
    rho = jnp.asarray(options.rho, dtype)
    tol = jnp.asarray(options.exit_tol, dtype)
    mi = jnp.asarray(options.max_iters, jnp.int32)
    zero_lam = jnp.zeros_like(b.q)
    jax.block_until_ready(b)

    def step(q0, lam_carry, t):
        Q, q = perturb(b, q0, lam_carry, t)
        res = core(Q, b.R, b.A, b.B, q, b.r, b.c, zero_lam, rho, tol, mi)
        # Touch dz too, so no stage is dead-code eliminated on XLA paths.
        return res.lam + res.dz_x + 1e-20 * jnp.sum(res.dz_u)

    label = chain_kwargs.pop("label", f"{backend}/{options.method}")
    return chain_time(step, b.q, T, label=label, **chain_kwargs)

"""Conditioning / robustness sweep: drive genuinely degenerate systems
through BOTH methods and every backend, asserting the FAILURE FLAGS — not
the solutions.

The reference's only failure signal is silent max_iters exhaustion
(gato_pcg.cuh:48-50); this repo claims to do better (converged flags,
residual-derived for direct solves — solver._direct_result), so prove it
under stress:

* PCG stall: an ill-conditioned Schur complement at a tolerance f32 cannot
  reach within the iteration cap -> ``converged=False`` on every backend.
* Exactly singular input (zero row/col in a Q block, rho=0): condensation
  NaN-poisons through blocktri.block_inv (1/0), so PCG runs to its cap and
  ``residual_converged`` reports False for exact solves — WITHOUT disturbing
  healthy problems sharing the same batch.

The Triton kernel ('triton') and cyclic reduction ('cr') run as an H100
would choose them, on the CPU (the ``as_h100`` fixture, conftest.py).
"""

import numpy as np
import pytest

import jax.numpy as jnp

from gato_tpu import ProblemSpec, SolverOptions
from gato_tpu.formats import KKTBlocks
from gato_tpu.solver import solve, solve_batched
from gato_tpu.testing import random_blocks

SPEC = ProblemSpec(4, 2, 8)
DIRECT = SolverOptions(rho=0.0, method="direct")


def _use(backend, as_h100):
    """pcg_backend argument for ``backend``; drops the H100 view for the
    backends the CPU chooses itself ('jax', 'thomas')."""
    if backend in ("jax", "thomas"):
        as_h100()
    return "triton" if backend == "triton" else None


def _singular_blocks(seed=3, knot=2):
    """Blocks whose Q[knot] has an exactly-zero first row/column: with
    rho=0 the condensation must invert a singular block."""
    b = random_blocks(SPEC, seed=seed)
    Q = np.asarray(b.Q).copy()
    Q[knot, :, 0] = 0.0
    Q[knot, 0, :] = 0.0
    return b._replace(Q=jnp.asarray(Q))


def _ill_conditioned_blocks(seed=3, lo=1e-6):
    """SPD Q blocks with eigenvalue spread [lo, 1] — condition number 1/lo,
    where f32 PCG visibly stalls against a tight exit_tol."""
    b = random_blocks(SPEC, seed=seed)
    rng = np.random.default_rng(0)
    s, K = SPEC.state_size, SPEC.knot_points
    Qs = []
    for _ in range(K):
        V, _r = np.linalg.qr(rng.normal(size=(s, s)))
        Qs.append(V @ np.diag(np.logspace(np.log10(lo), 0, s)) @ V.T)
    return b._replace(Q=jnp.asarray(np.array(Qs, np.float32)))


@pytest.mark.parametrize("backend", ["jax", "triton"])
def test_pcg_stall_reports_not_converged(backend, as_h100):
    """cond ~1e6 + exit_tol=1e-12 + a 40-iteration cap: the loop exhausts
    max_iters and the flag must say so (the reference would exit silently
    with garbage; gato_pcg.cuh:48-50)."""
    blocks = _ill_conditioned_blocks()
    opts = SolverOptions(rho=1e-9, exit_tol=1e-12, max_iters=40)
    res = solve(SPEC, blocks, opts, pcg_backend=_use(backend, as_h100))
    assert int(res.iters) == 40
    assert not bool(res.converged)


@pytest.mark.parametrize("backend", ["jax", "triton"])
def test_singular_pcg_runs_to_cap_not_converged(backend, as_h100):
    """Exactly-singular input through method='pcg': the NaN-poisoned
    condensation makes every PCG backend report iters == max_iters,
    converged=False — never a quietly regularized solve."""
    backend = _use(backend, as_h100)
    opts = SolverOptions(rho=0.0, exit_tol=1e-8, max_iters=25)
    res = solve(SPEC, _singular_blocks(), opts, pcg_backend=backend)
    assert int(res.iters) == 25
    assert not bool(res.converged)
    # Control: regularized, the same problem converges again.
    ok = solve(SPEC, _singular_blocks(),
               SolverOptions(rho=1e-2, exit_tol=1e-8, max_iters=200),
               pcg_backend=backend)
    assert bool(ok.converged)


def test_singular_in_pcg_batch_flags_only_that_problem(as_h100):
    """One singular problem inside a Triton-kernel PCG batch: only its flag
    drops (to max_iters, unconverged), the healthy members keep EXACT
    iteration parity with the XLA path and matching solutions — each
    problem runs in its own program, so the NaN cannot reach the others."""
    B, bad_idx = 5, 1
    bb = _batch_with_singular(B, bad_idx)
    opts = SolverOptions(rho=0.0, exit_tol=1e-8, max_iters=60)
    rf = solve_batched(SPEC, bb, opts, pcg_backend="triton")
    rj = solve_batched(SPEC, bb, opts, pcg_backend="jax")
    want = np.ones(B, bool)
    want[bad_idx] = False
    assert np.asarray(rf.converged).tolist() == want.tolist()
    assert np.asarray(rj.converged).tolist() == want.tolist()
    assert int(np.asarray(rf.iters)[bad_idx]) == 60
    assert (np.asarray(rf.iters)[want].tolist()
            == np.asarray(rj.iters)[want].tolist())
    lam_f = np.asarray(rf.lam)[want]
    lam_j = np.asarray(rj.lam)[want]
    scale = float(np.max(np.abs(lam_j)))
    assert float(np.max(np.abs(lam_f - lam_j))) / scale < 1e-4


@pytest.mark.parametrize("backend", ["thomas", "cr"])
def test_singular_direct_reports_not_converged(backend, as_h100):
    """Single-problem direct solve on a singular system: converged=False by
    block Thomas AND by cyclic reduction (the residual is NaN)."""
    _use(backend, as_h100)
    res = solve(SPEC, _singular_blocks(), DIRECT)
    assert not bool(res.converged)
    # Control: the same problem regularized is fine again.
    ok = solve(SPEC, _singular_blocks(), SolverOptions(rho=1e-2,
                                                       method="direct"))
    assert bool(ok.converged)


def _batch_with_singular(B, bad_idx, knot=2):
    probs = [random_blocks(SPEC, seed=100 + i) for i in range(B)]
    arrs = [np.stack([np.asarray(p[f]) for p in probs]) for f in range(7)]
    arrs[0][bad_idx, knot, :, 0] = 0.0
    arrs[0][bad_idx, knot, 0, :] = 0.0
    return KKTBlocks(*(jnp.asarray(a) for a in arrs))


@pytest.mark.parametrize("B,bad_idx", [(16, 5), (5, 1)])
def test_singular_in_batch_flags_only_that_problem(B, bad_idx, as_h100):
    """One singular problem in an exact batch: ONLY its flag drops, and the
    healthy members' cyclic-reduction solutions still match block Thomas."""
    bb = _batch_with_singular(B, bad_idx)
    rf = solve_batched(SPEC, bb, DIRECT)   # cr, as on an H100
    as_h100()
    rj = solve_batched(SPEC, bb, DIRECT)   # thomas, the CPU's choice
    want = np.ones(B, bool)
    want[bad_idx] = False
    assert np.asarray(rf.converged).tolist() == want.tolist()
    assert np.asarray(rj.converged).tolist() == want.tolist()
    lam_f = np.asarray(rf.lam)[want]
    lam_j = np.asarray(rj.lam)[want]
    scale = float(np.max(np.abs(lam_j)))
    assert float(np.max(np.abs(lam_f - lam_j))) / scale < 1e-4

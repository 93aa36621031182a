"""solve_sequence: on-device warm-started solve chains (MPC pattern)."""

import jax.numpy as jnp
import numpy as np

from gato_tpu import ProblemSpec, SolverOptions
from gato_tpu.formats import KKTBlocks
from gato_tpu.mpc import solve_sequence
from gato_tpu.solver import solve
from gato_tpu.testing import dense_oracle, random_blocks


def _tile(blocks, T):
    return KKTBlocks(*(np.broadcast_to(np.asarray(a), (T,) + np.asarray(a).shape).copy()
                       for a in blocks))


def test_sequence_matches_per_step_solves():
    spec = ProblemSpec(4, 2, 16)
    T = 5
    steps = [random_blocks(spec, seed=300 + t) for t in range(T)]
    seq = KKTBlocks(*(np.stack([np.asarray(s[f]) for s in steps])
                      for f in range(7)))
    opts = SolverOptions(exit_tol=1e-10, max_iters=400, rho=0.01)

    res = solve_sequence(spec, seq, opts)
    assert res.lam.shape == (T, 16, 4)

    lam_prev = jnp.zeros((16, 4))
    for t in range(T):
        single = solve(spec, steps[t],
                       SolverOptions(exit_tol=1e-10, max_iters=400, rho=0.01,
                                     warm_start=True),
                       lam0=lam_prev, pcg_backend="jax")
        assert int(res.iters[t]) == int(single.iters), t
        np.testing.assert_allclose(np.asarray(res.lam[t]),
                                   np.asarray(single.lam),
                                   rtol=1e-4, atol=1e-4)
        lam_prev = single.lam


def test_sequence_warm_start_reduces_iters():
    """Identical problems repeated: step 0 pays full iterations, later steps
    converge immediately from the carried multipliers."""
    spec = ProblemSpec(4, 2, 20)
    blocks = random_blocks(spec, seed=44)
    seq = _tile(blocks, 4)
    res = solve_sequence(spec, seq,
                         SolverOptions(exit_tol=1e-8, max_iters=300, rho=0.01))
    iters = [int(x) for x in res.iters]
    assert iters[0] > 5
    assert all(i <= 1 for i in iters[1:])
    lam_ref, _ = dense_oracle(spec, blocks, rho=0.01)
    np.testing.assert_allclose(np.asarray(res.lam[-1]).reshape(-1), lam_ref,
                               rtol=2e-3, atol=2e-3)


def test_sequence_per_step_rho():
    spec = ProblemSpec(3, 1, 10)
    blocks = random_blocks(spec, seed=55)
    seq = _tile(blocks, 3)
    rhos = jnp.asarray([1e-3, 1e-2, 1e-1])
    res = solve_sequence(spec, seq,
                         SolverOptions(exit_tol=1e-10, max_iters=400),
                         rhos=rhos)
    for t, rho in enumerate([1e-3, 1e-2, 1e-1]):
        lam_ref, _ = dense_oracle(spec, blocks, rho=rho)
        np.testing.assert_allclose(np.asarray(res.lam[t]).reshape(-1), lam_ref,
                                   rtol=2e-3, atol=2e-3, err_msg=f"step {t}")


def test_sequence_batched_matches_independent_sequences(as_h100):
    """solve_sequence_batched (T, B) == B independent solve_sequence runs:
    exact per-stream iteration parity and matching solutions, on both the
    jax path and the Triton kernel (interpreted)."""
    from gato_tpu.mpc import solve_sequence_batched

    spec = ProblemSpec(4, 2, 12)
    T, B = 4, 3
    streams = []
    for b in range(B):
        steps = [random_blocks(spec, seed=700 + 10 * b + t) for t in range(T)]
        streams.append(KKTBlocks(*(np.stack([np.asarray(s[f]) for s in steps])
                                   for f in range(7))))
    batched = KKTBlocks(*(np.stack([np.asarray(streams[b][f]) for b in range(B)],
                                   axis=1) for f in range(7)))
    opts = SolverOptions(exit_tol=1e-10, max_iters=400, rho=0.01)

    refs = [solve_sequence(spec, streams[b], opts, pcg_backend="jax")
            for b in range(B)]
    for backend in ("jax", "triton"):
        res = solve_sequence_batched(spec, batched, opts, pcg_backend=backend)
        assert res.lam.shape == (T, B, 12, 4)
        for b in range(B):
            assert [int(i) for i in np.asarray(res.iters)[:, b]] == \
                [int(i) for i in np.asarray(refs[b].iters)], (backend, b)
            np.testing.assert_allclose(np.asarray(res.lam[:, b]),
                                       np.asarray(refs[b].lam),
                                       rtol=1e-4, atol=1e-4,
                                       err_msg=f"{backend}/{b}")
            np.testing.assert_allclose(np.asarray(res.dz_u[:, b]),
                                       np.asarray(refs[b].dz_u),
                                       rtol=1e-4, atol=1e-4)


def test_sequence_batched_direct_matches_per_step_batches():
    """The EXACT farm (method='direct'): a (T, B) sequence equals the T
    per-step solve_batched(method='direct') calls — including per-step
    rhos, which the surface folds into the Q/R diagonals before the one
    batched kernel call."""
    from gato_tpu.mpc import solve_sequence_batched
    from gato_tpu.solver import solve_batched

    spec = ProblemSpec(4, 2, 12)
    T, Bn = 3, 4
    steps = [[random_blocks(spec, seed=900 + 10 * t + b) for b in range(Bn)]
             for t in range(T)]
    seq = KKTBlocks(*(np.stack([np.stack([np.asarray(steps[t][b][f])
                                          for b in range(Bn)])
                                for t in range(T)])
                      for f in range(7)))
    rhos = np.array([1e-2, 5e-2, 1e-3], dtype=np.float32)

    res = solve_sequence_batched(spec, seq, SolverOptions(method="direct"),
                                 rhos=rhos)
    assert res.lam.shape == (T, Bn, 12, 4)
    assert bool(np.all(np.asarray(res.converged)))
    assert np.all(np.asarray(res.iters) == 0)

    for t in range(T):
        step = KKTBlocks(*(np.stack([np.asarray(steps[t][b][f])
                                     for b in range(Bn)]) for f in range(7)))
        ref = solve_batched(spec, step,
                            SolverOptions(method="direct", rho=float(rhos[t])))
        np.testing.assert_allclose(np.asarray(res.lam[t]),
                                   np.asarray(ref.lam),
                                   rtol=1e-5, atol=1e-5, err_msg=f"t={t}")
        np.testing.assert_allclose(np.asarray(res.dz_u[t]),
                                   np.asarray(ref.dz_u),
                                   rtol=1e-5, atol=1e-5, err_msg=f"t={t}")


def test_sequence_direct_single_stream_matches_per_step():
    """solve_sequence(method='direct'): T independent exact solves, run as
    one batch over the T axis — matches per-step solve(method='direct')."""
    spec = ProblemSpec(3, 2, 8)
    T = 4
    steps = [random_blocks(spec, seed=700 + t) for t in range(T)]
    seq = KKTBlocks(*(np.stack([np.asarray(s[f]) for s in steps])
                      for f in range(7)))
    opts = SolverOptions(method="direct", rho=1e-2)

    res = solve_sequence(spec, seq, opts)
    assert res.lam.shape == (T, 8, 3)
    for t in range(T):
        ref = solve(spec, steps[t], opts)
        np.testing.assert_allclose(np.asarray(res.lam[t]),
                                   np.asarray(ref.lam),
                                   rtol=1e-5, atol=1e-5, err_msg=f"t={t}")


def test_sequence_batched_rejects_unknown_backend():
    import pytest

    from gato_tpu.mpc import solve_sequence_batched

    spec = ProblemSpec(4, 2, 12)
    blocks = random_blocks(spec, seed=1)
    seq = KKTBlocks(*(np.broadcast_to(np.asarray(a), (2, 3) + np.asarray(a).shape).copy()
                      for a in blocks))
    with pytest.raises(ValueError, match="unknown pcg_backend"):
        solve_sequence_batched(spec, seq, SolverOptions(rho=1e-2),
                               pcg_backend="nope")

"""End-to-end solver tests vs the dense oracle: IIWA shape, long horizons,
warm-start MPC behavior, batching — the BASELINE.json configs."""

import jax.numpy as jnp
import numpy as np
import pytest

from gato_tpu import Preconditioner, ProblemSpec, SolverOptions
from gato_tpu.formats import KKTBlocks
from gato_tpu.solver import solve, solve_batched
from gato_tpu.testing import dense_oracle, random_blocks


def _check(spec, blocks, rho=0.01, tol=2e-3, **kw):
    res = solve(spec, blocks,
                SolverOptions(exit_tol=1e-12, max_iters=500, rho=rho, **kw),
                pcg_backend="jax")
    lam_ref, dz_ref = dense_oracle(spec, blocks, rho=rho)
    scale = max(1.0, np.abs(lam_ref).max(), np.abs(dz_ref).max())
    assert bool(res.converged)
    np.testing.assert_allclose(res.lam_flat(), lam_ref, atol=tol * scale)
    np.testing.assert_allclose(res.dz_flat(), dz_ref, atol=tol * scale)
    return res


def test_iiwa_shape():
    spec = ProblemSpec(14, 7, 50)
    _check(spec, random_blocks(spec, seed=42))


@pytest.mark.parametrize("K", [100, 250])
def test_long_horizon(K):
    spec = ProblemSpec(4, 2, K)
    _check(spec, random_blocks(spec, seed=K))


@pytest.mark.parametrize("kind", list(Preconditioner))
def test_preconditioners_all_converge(kind):
    spec = ProblemSpec(6, 3, 20)
    _check(spec, random_blocks(spec, seed=13), preconditioner=kind)


def test_nonzero_constraint_residual():
    """c != 0 exercises the gamma_0 correction (assemble.py docstring)."""
    spec = ProblemSpec(3, 2, 8)
    blocks = random_blocks(spec, seed=21, c_zero=False)
    assert np.any(np.asarray(blocks.c)[0] != 0)
    _check(spec, blocks)


def test_warm_start_mpc_loop():
    """MPC-style repeated solves with rho updates: warm starts must converge in
    fewer iterations and to the same solution (BASELINE.json config 3)."""
    spec = ProblemSpec(4, 2, 30)
    blocks = random_blocks(spec, seed=33)
    opts = dict(exit_tol=1e-10, max_iters=500)

    cold = solve(spec, blocks, SolverOptions(rho=0.01, **opts), pcg_backend="jax")
    assert bool(cold.converged)

    warm = solve(
        spec, blocks,
        SolverOptions(rho=0.011, warm_start=True, **opts),  # rho nudge, reuse lam
        lam0=cold.lam, pcg_backend="jax",
    )
    cold2 = solve(spec, blocks, SolverOptions(rho=0.011, **opts), pcg_backend="jax")
    assert bool(warm.converged) and bool(cold2.converged)
    assert int(warm.iters) < int(cold2.iters)
    np.testing.assert_allclose(
        np.asarray(warm.lam), np.asarray(cold2.lam), rtol=1e-3, atol=1e-3
    )


def test_warm_start_flag_off_ignores_lam0():
    """warm_start=False must reproduce the cold start exactly (the reference's
    observed behavior — its kernels always reset lambda, gato_pcg.cuh:296-304)."""
    spec = ProblemSpec(3, 1, 10)
    blocks = random_blocks(spec, seed=5)
    opts = SolverOptions(exit_tol=1e-8, max_iters=200, rho=0.001)
    cold = solve(spec, blocks, opts, pcg_backend="jax")
    with_lam0 = solve(spec, blocks, opts, lam0=jnp.ones((10, 3)), pcg_backend="jax")
    assert int(cold.iters) == int(with_lam0.iters)
    np.testing.assert_array_equal(np.asarray(cold.lam), np.asarray(with_lam0.lam))


def test_batched_solve_matches_single():
    spec = ProblemSpec(4, 2, 12)
    problems = [random_blocks(spec, seed=100 + i) for i in range(8)]
    batched_blocks = KKTBlocks(*(np.stack([np.asarray(p[f]) for p in problems])
                                 for f in range(7)))
    opts = SolverOptions(exit_tol=1e-10, max_iters=300, rho=0.01)
    res = solve_batched(spec, batched_blocks, opts, pcg_backend="jax")
    assert res.lam.shape == (8, 12, 4)
    for i, p in enumerate(problems):
        single = solve(spec, p, opts, pcg_backend="jax")
        assert int(res.iters[i]) == int(single.iters)
        np.testing.assert_allclose(
            np.asarray(res.lam[i]), np.asarray(single.lam), rtol=1e-4, atol=1e-4
        )
        np.testing.assert_allclose(
            np.asarray(res.dz_x[i]), np.asarray(single.dz_x), rtol=1e-4, atol=1e-4
        )


def test_rho_and_tol_do_not_retrace():
    """rho/exit_tol/max_iters are runtime args: changing them must not retrace
    (the reference requires a rebuild per shape and re-conversion per rho)."""
    from gato_tpu.solver import _solve_core

    spec = ProblemSpec(3, 2, 6)
    blocks = random_blocks(spec, seed=77)
    n0 = _solve_core._cache_size()
    solve(spec, blocks, SolverOptions(rho=0.001), pcg_backend="jax")
    n1 = _solve_core._cache_size()
    solve(spec, blocks, SolverOptions(rho=0.5, exit_tol=1e-3, max_iters=7),
          pcg_backend="jax")
    assert _solve_core._cache_size() == n1 > n0


def test_float64_dtype():
    """SolverOptions(dtype='float64') under jax.enable_x64: the whole
    pipeline runs in f64 and matches the oracle to ~1e-14."""
    import jax

    from gato_tpu.testing import dense_oracle

    spec = ProblemSpec(4, 2, 10)
    blocks = random_blocks(spec, seed=1)
    with jax.enable_x64(True):
        res = solve(spec, blocks,
                    SolverOptions(rho=1e-3, exit_tol=1e-22, max_iters=400,
                                  dtype="float64"),
                    pcg_backend="jax")
        assert res.lam.dtype == jnp.float64
        lam_ref, _ = dense_oracle(spec, blocks, rho=1e-3)
        np.testing.assert_allclose(res.lam_flat(), lam_ref,
                                   rtol=1e-10, atol=1e-12)


def test_f64_auto_selects_jax_backend(as_h100):
    """Auto-selection routes non-f32 compute to the pure-XLA path: the
    Triton kernel is float32, and on an H100 the auto default would
    otherwise hand f64 arrays to it.  The check lives in
    dispatch.choose_backend so every auto-selector inherits it."""
    from gato_tpu.dispatch import choose_backend

    kw = dict(K=50)
    assert choose_backend("pcg", None, dtype="float64", **kw) == "jax"
    assert choose_backend("pcg", None, dtype="float32", **kw) == "triton"
    assert choose_backend("direct", None, dtype="float64", **kw) == "cr"


def test_auto_selectors_forward_dtype(monkeypatch):
    """Every auto-selection call site must pass options.dtype through to
    dispatch.choose_backend — dropping it anywhere would silently hand f64
    arrays to the float32 kernel on a GPU while all CPU tests keep passing
    (the CPU auto-selects 'jax' regardless)."""
    import jax
    import jax.numpy as jnp

    from gato_tpu import dispatch, mpc as mpc_mod
    from gato_tpu.formats import KKTBlocks

    seen = []
    real = dispatch.choose_backend

    def recorder(method, requested, **k):
        seen.append(jnp.dtype(k["dtype"]).name)
        return real(method, requested, **k)

    monkeypatch.setattr(dispatch, "choose_backend", recorder)
    from gato_tpu import solver as solver_mod

    monkeypatch.setattr(solver_mod, "choose_backend", recorder)
    spec = ProblemSpec(2, 1, 4)
    blocks = random_blocks(spec, seed=0)
    opts = SolverOptions(dtype="float64", rho=1e-2)
    with jax.enable_x64(True):
        solve(spec, blocks, opts)
        assert seen[-1] == "float64"
        solve_batched(spec, KKTBlocks(*(np.asarray(a)[None]
                                        for a in blocks)), opts)
        assert seen[-1] == "float64"
        seq = KKTBlocks(*(jnp.broadcast_to(jnp.asarray(np.asarray(a)),
                                           (2,) + np.asarray(a).shape)
                          for a in blocks))
        mpc_mod.solve_sequence(spec, seq, opts)
        assert seen[-1] == "float64"
        farm = KKTBlocks(*(jnp.broadcast_to(jnp.asarray(np.asarray(a)),
                                            (2, 3) + np.asarray(a).shape)
                           for a in blocks))
        mpc_mod.solve_sequence_batched(spec, farm, opts)
        assert seen[-1] == "float64"

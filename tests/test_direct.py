"""Direct block-Thomas solver: exactness vs oracle, parity with PCG, batching."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gato_tpu import ProblemSpec, SolverOptions
from gato_tpu.blocktri import btd_to_dense
from gato_tpu.direct import btd_solve
from gato_tpu.formats import KKTBlocks
from gato_tpu.solver import solve, solve_batched
from gato_tpu.testing import dense_oracle, random_blocks


def _random_spd_btd(K, s, seed=0):
    rng = np.random.default_rng(seed)
    off = rng.normal(size=(K - 1, s, s)).astype(np.float32) * 0.2
    diag = np.asarray([
        (lambda F: F @ F.T + np.eye(s) * 2.0)(rng.normal(size=(s, s)))
        for _ in range(K)
    ], dtype=np.float32)
    zero = np.zeros((1, s, s), dtype=np.float32)
    left = np.concatenate([zero, off], axis=0)
    right = np.concatenate([off.transpose(0, 2, 1), zero], axis=0)
    return np.stack([left, diag, right], axis=1)


@pytest.mark.parametrize("K,s", [(2, 3), (5, 2), (50, 14), (128, 4)])
def test_btd_solve_exact(K, s):
    S = _random_spd_btd(K, s, seed=K + s)
    b = np.random.default_rng(1).normal(size=(K, s)).astype(np.float32)
    x = btd_solve(jnp.asarray(S), jnp.asarray(b))
    x_ref = np.linalg.solve(btd_to_dense(S).astype(np.float64), b.reshape(-1))
    np.testing.assert_allclose(np.asarray(x).reshape(-1), x_ref,
                               rtol=1e-4, atol=1e-4)


def test_btd_solve_batched_native():
    """Leading batch dims without vmap."""
    Bn, K, s = 3, 10, 4
    Ss = np.stack([_random_spd_btd(K, s, seed=i) for i in range(Bn)])
    bs = np.random.default_rng(2).normal(size=(Bn, K, s)).astype(np.float32)
    x = btd_solve(jnp.asarray(Ss), jnp.asarray(bs))
    for i in range(Bn):
        x_ref = np.linalg.solve(btd_to_dense(Ss[i]).astype(np.float64),
                                bs[i].reshape(-1))
        np.testing.assert_allclose(np.asarray(x[i]).reshape(-1), x_ref,
                                   rtol=1e-4, atol=1e-4)


def test_solve_method_direct_matches_oracle():
    spec = ProblemSpec(14, 7, 50)
    blocks = random_blocks(spec, seed=42)
    rho = 0.01
    res = solve(spec, blocks, SolverOptions(rho=rho, method="direct"))
    lam_ref, dz_ref = dense_oracle(spec, blocks, rho=rho)
    scale = max(1.0, np.abs(lam_ref).max())
    assert bool(res.converged) and int(res.iters) == 0
    np.testing.assert_allclose(res.lam_flat(), lam_ref, atol=2e-3 * scale)
    np.testing.assert_allclose(res.dz_flat(), dz_ref, atol=2e-3 * scale)
    assert float(res.eta) < 1e-4  # squared true residual


def test_direct_beats_pcg_accuracy_when_stalled():
    """With a tiny iteration budget PCG can't converge; direct is exact."""
    spec = ProblemSpec(6, 3, 40)
    blocks = random_blocks(spec, seed=3)
    lam_ref, _ = dense_oracle(spec, blocks, rho=0.001)
    pcg_res = solve(spec, blocks,
                    SolverOptions(rho=0.001, max_iters=2, exit_tol=1e-12),
                    pcg_backend="jax")
    direct_res = solve(spec, blocks, SolverOptions(rho=0.001, method="direct"))
    err_pcg = np.abs(pcg_res.lam_flat() - lam_ref).max()
    err_dir = np.abs(direct_res.lam_flat() - lam_ref).max()
    assert not bool(pcg_res.converged)
    assert err_dir < err_pcg / 10


def test_solve_batched_direct():
    spec = ProblemSpec(4, 2, 12)
    problems = [random_blocks(spec, seed=70 + i) for i in range(6)]
    blocks = KKTBlocks(*(np.stack([np.asarray(p[f]) for p in problems])
                         for f in range(7)))
    res = solve_batched(spec, blocks, SolverOptions(rho=0.01, method="direct"))
    assert res.lam.shape == (6, 12, 4)
    assert bool(jnp.all(res.converged)) and int(jnp.max(res.iters)) == 0
    for i, p in enumerate(problems):
        lam_ref, _ = dense_oracle(spec, p, rho=0.01)
        np.testing.assert_allclose(np.asarray(res.lam[i]).reshape(-1), lam_ref,
                                   rtol=2e-3, atol=2e-3)


def test_direct_grad_flows():
    """btd_solve is differentiable (pure lax.scan) — useful for bilevel /
    sensitivity work; smoke-check a gradient."""
    S = jnp.asarray(_random_spd_btd(6, 2, seed=9))
    b = jnp.ones((6, 2), jnp.float32)

    def loss(bv):
        return jnp.sum(btd_solve(S, bv) ** 2)

    g = jax.grad(loss)(b)
    assert np.all(np.isfinite(np.asarray(g)))
    # finite-difference check on one coordinate
    eps = 1e-3
    bp = b.at[2, 1].add(eps)
    bm = b.at[2, 1].add(-eps)
    fd = (loss(bp) - loss(bm)) / (2 * eps)
    np.testing.assert_allclose(float(g[2, 1]), float(fd), rtol=2e-2)


def test_thomas_multi_matches_per_column_solves():
    """The shared multi-rhs Thomas core (direct.thomas_multi — used by the
    mesh SPIKE, parallel/sharded._btd_solve_direct_local): one factorization
    applied to a stacked rhs must equal per-column btd_solve, including with
    extra batch dims between the scan axis and the blocks."""
    from gato_tpu.direct import thomas_multi

    K, s, nrhs, B = 9, 3, 4, 2
    S = np.stack([_random_spd_btd(K, s, seed=10 + i) for i in range(B)])
    Bm = np.random.default_rng(4).normal(size=(B, K, s, nrhs)) \
        .astype(np.float32)
    L, D, U = (jnp.moveaxis(jnp.asarray(S[:, :, j]), 1, 0) for j in range(3))
    X = thomas_multi(L, D, U, jnp.moveaxis(jnp.asarray(Bm), 1, 0))
    X = jnp.moveaxis(X, 0, 1)                       # (B, K, s, nrhs)
    for col in range(nrhs):
        ref = btd_solve(jnp.asarray(S), jnp.asarray(Bm[..., col]))
        np.testing.assert_allclose(np.asarray(X[..., col]), np.asarray(ref),
                                   rtol=2e-4, atol=2e-4, err_msg=str(col))


@pytest.mark.parametrize("batch", [1, 4])
@pytest.mark.parametrize("K", [2, 3, 5, 8, 17, 64])
def test_btd_solve_cr_matches_thomas(K, batch):
    """Cyclic reduction (the parallel direct solver) vs block Thomas vs the
    float64 dense solve, on random SPD block-tridiagonal systems: odd and
    power-of-two K, the K=2 single-level edge, batched and single."""
    from gato_tpu.direct import btd_solve_cr

    s = 3
    S = np.stack([_random_spd_btd(K, s, seed=K + i) for i in range(batch)])
    b = np.random.default_rng(K).normal(size=(batch, K, s)).astype(np.float32)
    dense = np.stack([
        np.linalg.solve(np.asarray(btd_to_dense(jnp.asarray(S[i])),
                                   np.float64), b[i].reshape(-1).astype(
                                       np.float64)).reshape(K, s)
        for i in range(batch)])
    thomas = np.asarray(btd_solve(jnp.asarray(S), jnp.asarray(b)))
    cr = np.asarray(btd_solve_cr(jnp.asarray(S), jnp.asarray(b)))
    scale = float(np.max(np.abs(dense))) or 1.0
    for got in (thomas, cr):
        np.testing.assert_allclose(got / scale, dense / scale,
                                   rtol=2e-4, atol=2e-4)


def test_method_direct_uses_cr_dispatch(as_h100, monkeypatch):
    """On an H100 the exact solve routes through cyclic reduction,
    end-to-end via solve."""
    from gato_tpu import direct as direct_mod

    calls = []
    real = direct_mod.btd_solve_cr

    def spy(S, b):
        calls.append(b.shape)
        return real(S, b)

    monkeypatch.setattr(direct_mod, "btd_solve_cr", spy)
    spec = ProblemSpec(4, 2, 12)
    blocks = random_blocks(spec, seed=5)
    res = solve(spec, blocks, SolverOptions(rho=1e-2, method="direct"))
    assert calls, "the exact solve did not reach cyclic reduction"
    lam_ref, _ = dense_oracle(spec, blocks, rho=1e-2)
    np.testing.assert_allclose(res.lam_flat(), lam_ref, rtol=2e-3, atol=2e-3)


def test_direct_converged_is_residual_derived(as_h100):
    """A singular condensed system must report converged=False on BOTH direct
    backends (VERDICT: the flag was unconditionally True).  Construction: the
    condensed S is congruent to blocks C_k = B_k R_k^{-1} B_k^T + Qinv_k
    (Thomas pivots), so R_{K-2} = -I, B_{K-2} = I, Q_{K-1} = I makes the last
    pivot exactly zero while every Q/R stays invertible (condensation clean).
    Checked by cyclic reduction (the H100's choice) and block Thomas (the
    CPU's).
    """
    s, c, K = 2, 2, 3
    spec = ProblemSpec(s, c, K)
    eye = np.eye(s, dtype=np.float32)
    blocks = KKTBlocks(
        Q=np.stack([eye, eye, eye]),
        R=np.stack([np.eye(c, dtype=np.float32),
                    -np.eye(c, dtype=np.float32)]),
        A=np.stack([eye, eye]),
        B=np.stack([np.zeros((s, c), np.float32), eye[:, :c]]),
        q=np.arange(K * s, dtype=np.float32).reshape(K, s) + 1.0,
        r=np.ones((K - 1, c), np.float32),
        c=np.ones((K, s), np.float32),
    )
    opts = SolverOptions(rho=0.0, method="direct")
    good = blocks._replace(R=np.stack([np.eye(c, dtype=np.float32)] * 2))
    for algo in ("cr", "thomas"):
        if algo == "thomas":
            as_h100()
        assert not bool(solve(spec, blocks, opts).converged), algo
        # Healthy counterpart (R flipped positive definite): converged, and
        # tiny relative residual.
        res = solve(spec, good, opts)
        assert bool(res.converged), algo
        assert float(res.eta) < 1e-6, algo

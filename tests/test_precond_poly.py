"""Polynomial preconditioner composition (SolverOptions.precond_poly_degree).

An extension in the spirit of the reference's PRECONDITIONER_BANDWIDTH knob
(gato_defines.h:11): instead of assembling wider-band Pinv blocks, PCG applies
M_d r = P sum_{i<d} (I - S P)^i r.  Degree 1 reproduces the reference exactly;
higher degrees must cut iterations, agree with the oracle, and keep EXACT
iteration parity across all backends.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gato_tpu import ProblemSpec, SolverOptions
from gato_tpu.solver import solve, solve_batched
from gato_tpu.formats import KKTBlocks
from gato_tpu.testing import dense_oracle, random_blocks

IIWA = ProblemSpec(14, 7, 50)


def _opts(degree, **kw):
    base = dict(rho=1e-3, exit_tol=1e-6, max_iters=200)
    base.update(kw)
    return SolverOptions(precond_poly_degree=degree, **base)


def test_degree_cuts_iterations():
    blocks = random_blocks(IIWA, seed=7)
    iters = {}
    for d in (1, 2, 3):
        res = solve(IIWA, blocks, _opts(d), pcg_backend="jax")
        assert bool(res.converged)
        iters[d] = int(res.iters)
    assert iters[2] < iters[1]
    assert iters[3] <= iters[2]
    assert iters[2] < 20  # measured: 27 -> 19 -> 16


def test_degree2_matches_oracle():
    spec = ProblemSpec(4, 2, 12)
    blocks = random_blocks(spec, seed=1)
    res = solve(spec, blocks, _opts(2, exit_tol=1e-10, max_iters=400),
                pcg_backend="jax")
    lam_o, _ = dense_oracle(spec, blocks, rho=1e-3)
    np.testing.assert_allclose(np.asarray(res.lam).reshape(-1), lam_o,
                               rtol=1e-3, atol=1e-4)


@pytest.mark.parametrize("degree", [2, pytest.param(3, marks=pytest.mark.slow)])
def test_backend_parity_poly(degree, as_h100):
    """jax / triton must agree on iteration counts exactly at any degree
    (the repo invariant extends to the composed preconditioner).  Small
    shape: the parity axis is degree x backend, not problem size —
    IIWA-size parity runs compiled in chip_smoke.py on the card."""
    spec = ProblemSpec(6, 3, 24)
    blocks = random_blocks(spec, seed=9)
    opts = _opts(degree)
    ref = solve(spec, blocks, opts, pcg_backend="jax")
    for be in ("triton",):
        got = solve(spec, blocks, opts, pcg_backend=be)
        assert int(got.iters) == int(ref.iters), be
        np.testing.assert_allclose(np.asarray(got.lam), np.asarray(ref.lam),
                                   rtol=1e-3, atol=1e-4)


def test_batched_parity_poly(as_h100):
    spec = ProblemSpec(5, 3, 10)
    problems = [random_blocks(spec, seed=40 + i) for i in range(4)]
    batch = KKTBlocks(*(np.stack([np.asarray(p[f]) for p in problems])
                        for f in range(7)))
    opts = _opts(2)
    ref = solve_batched(spec, batch, opts, pcg_backend="jax")
    for be in ("triton",):
        got = solve_batched(spec, batch, opts, pcg_backend=be)
        np.testing.assert_array_equal(np.asarray(got.iters),
                                      np.asarray(ref.iters))
        np.testing.assert_allclose(np.asarray(got.lam), np.asarray(ref.lam),
                                   rtol=1e-3, atol=1e-4)


@pytest.mark.slow
def test_sharded_poly_matches_single_device():
    from jax.sharding import Mesh
    from gato_tpu import assemble
    from gato_tpu.parallel.sharded import pcg_sharded
    from gato_tpu.pcg import pcg
    from gato_tpu.problem import Preconditioner

    spec = ProblemSpec(4, 2, 16)
    b = random_blocks(spec, seed=3)
    sys = assemble.condense(*(jnp.asarray(a) for a in b), jnp.float32(1e-2),
                            Preconditioner.SYMMETRIC_STAIR)
    single = pcg(sys.S, sys.Pinv, sys.gamma, exit_tol=1e-8, max_iters=200,
                 poly_degree=2)
    mesh = Mesh(np.array(jax.devices()[:4]), ("knot",))
    sharded = pcg_sharded(mesh, sys.S, sys.Pinv, sys.gamma,
                          exit_tol=1e-8, max_iters=200, poly_degree=2)
    assert int(sharded.iters) == int(single.iters)
    np.testing.assert_allclose(np.asarray(sharded.lam),
                               np.asarray(single.lam), rtol=1e-4, atol=1e-5)


def test_degree1_unchanged_default():
    """Default options keep the reference's plain application — same count as
    an explicit degree-1 run."""
    blocks = random_blocks(IIWA, seed=7)
    base = solve(IIWA, blocks, SolverOptions(rho=1e-3, exit_tol=1e-6,
                                             max_iters=200),
                 pcg_backend="jax")
    d1 = solve(IIWA, blocks, _opts(1), pcg_backend="jax")
    assert int(base.iters) == int(d1.iters)


def test_triton_block_jacobi_poly_degree_parity(as_h100):
    """Block-Jacobi composed polynomially through the Triton kernel: exact
    iteration parity with the jax oracle (the spectrum of P S stays below 2
    here, so the composed operator is SPD and eta decays monotonically)."""
    from gato_tpu.problem import Preconditioner

    spec = ProblemSpec(5, 3, 12)
    blocks = random_blocks(spec, seed=21)
    opts = SolverOptions(rho=1e-2, exit_tol=1e-8, max_iters=400,
                         preconditioner=Preconditioner.BLOCK_JACOBI,
                         precond_poly_degree=2)
    ref = solve(spec, blocks, opts, pcg_backend="jax")
    got = solve(spec, blocks, opts, pcg_backend="triton")
    assert int(got.iters) == int(ref.iters)
    np.testing.assert_allclose(np.asarray(got.lam), np.asarray(ref.lam),
                               rtol=1e-4, atol=1e-4)


def test_triton_scalar_jacobi_poly_degree_converges(as_h100):
    """Scalar Jacobi + poly degree 2 hits the documented SPD caveat
    (SolverOptions docstring): nothing bounds the spectrum of P S below 2, so
    the composed operator can be indefinite — eta oscillates and the exit
    iteration becomes reduction-order-sensitive (any change of summation
    order moves it).  What IS guaranteed and asserted: both paths converge,
    and each agrees with the dense oracle at the oracle tolerance of
    test_solver."""
    from gato_tpu.problem import Preconditioner

    spec = ProblemSpec(5, 3, 12)
    blocks = random_blocks(spec, seed=21)
    opts = SolverOptions(rho=1e-2, exit_tol=1e-8, max_iters=400,
                         preconditioner=Preconditioner.JACOBI,
                         precond_poly_degree=2)
    lam_o, _ = dense_oracle(spec, blocks, rho=1e-2)
    scale = max(1.0, float(np.abs(lam_o).max()))
    for be in ("jax", "triton"):
        res = solve(spec, blocks, opts, pcg_backend=be)
        assert bool(res.converged), be
        np.testing.assert_allclose(res.lam_flat(), lam_o, atol=2e-3 * scale,
                                   err_msg=be)

"""Cross-backend property sweep: every backend must agree with the jax
numerics oracle — exact iteration counts, close solutions — across a grid of
shapes, regularizers, tolerances, and poly degrees (the repo's core
invariant, CLAUDE.md, exercised wider than the per-feature tests).  The
Triton kernel runs in the Pallas interpreter under the ``as_h100``
fixture (conftest.py)."""

import numpy as np
import pytest

from gato_tpu import ProblemSpec, SolverOptions
from gato_tpu.solver import solve
from gato_tpu.testing import dense_oracle, random_blocks


# The sweep is deliberately WIDER than the per-feature tests (extra
# confidence, same invariant); the heavy interpret-mode cases carry the
# `slow` marker — the fast tier keeps every backend x method pair plus poly
# and long-horizon representatives, `-m ''` runs the full grid.
_slow = pytest.mark.slow

CASES = [
    # (spec, rho, exit_tol, degree)
    (ProblemSpec(2, 1, 5), 1e-3, 1e-8, 1),      # pendulum shape
    (ProblemSpec(2, 1, 5), 1e-3, 1e-8, 2),
    pytest.param(ProblemSpec(5, 4, 7), 1e-2, 1e-10, 1,  # control > state
                 marks=_slow),
    (ProblemSpec(3, 2, 64), 1e-4, 1e-8, 1),     # longer horizon, tiny rho
    pytest.param(ProblemSpec(3, 2, 64), 1e-4, 1e-8, 3, marks=_slow),
    pytest.param(ProblemSpec(9, 5, 21), 1e-1, 1e-6, 2,  # heavy reg, sp=16
                 marks=_slow),
    (ProblemSpec(1, 1, 4), 1e-3, 1e-10, 1),     # minimal sizes
    pytest.param(ProblemSpec(17, 3, 6), 1e-2, 1e-8, 1,  # s past 16: SP=32
                 marks=_slow),
    (ProblemSpec(2, 1, 2), 1e-3, 1e-8, 1),      # minimal horizon: every knot
                                                # is a boundary knot
]


@pytest.mark.parametrize("spec,rho,tol,degree", CASES)
def test_backend_agreement(spec, rho, tol, degree, as_h100):
    blocks = random_blocks(spec, seed=hash((spec.nx, spec.nk)) % 1000)
    opts = SolverOptions(rho=rho, exit_tol=tol, max_iters=400,
                         precond_poly_degree=degree)
    ref = solve(spec, blocks, opts, pcg_backend="jax")
    assert bool(ref.converged)
    scale = max(float(np.max(np.abs(np.asarray(ref.lam)))), 1.0)
    for be in ("triton",):
        got = solve(spec, blocks, opts, pcg_backend=be)
        assert int(got.iters) == int(ref.iters), (be, spec)
        np.testing.assert_allclose(np.asarray(got.lam) / scale,
                                   np.asarray(ref.lam) / scale,
                                   rtol=1e-4, atol=1e-4, err_msg=str((be, spec)))
        np.testing.assert_allclose(np.asarray(got.dz_u), np.asarray(ref.dz_u),
                                   rtol=1e-3, atol=1e-3, err_msg=str((be, spec)))
        if be == "triton":
            # The packed serving surface runs solve_batched's core with the
            # backend auto-dispatch picks — bitwise, across the whole grid.
            from gato_tpu import pack, solve_batched, solve_packed
            from gato_tpu.formats import KKTBlocks

            one = KKTBlocks(*(np.asarray(a)[None] for a in blocks))
            auto = solve_batched(spec, one, opts)
            pr = solve_packed(pack(spec, blocks), opts).unpack()
            assert int(pr.iters) == int(auto.iters[0]), spec
            np.testing.assert_array_equal(np.asarray(pr.lam),
                                          np.asarray(auto.lam[0]),
                                          err_msg=str(("packed", spec)))
            np.testing.assert_array_equal(np.asarray(pr.dz_u),
                                          np.asarray(auto.dz_u[0]),
                                          err_msg=str(("packed", spec)))


@pytest.mark.parametrize("spec,rho", [
    (ProblemSpec(2, 1, 5), 1e-3),
    (ProblemSpec(5, 4, 7), 1e-2),
    (ProblemSpec(3, 2, 64), 1e-4),
])
def test_solutions_match_dense_oracle(spec, rho, as_h100):
    """Both PCG backends against the f64 dense saddle-point oracle."""
    blocks = random_blocks(spec, seed=3)
    opts = SolverOptions(rho=rho, exit_tol=1e-12, max_iters=500)
    lam_ref, dz_ref = dense_oracle(spec, blocks, rho=rho)
    scale = max(float(np.max(np.abs(lam_ref))), 1.0)
    for be in ("jax", "triton"):
        res = solve(spec, blocks, opts, pcg_backend=be)
        np.testing.assert_allclose(res.lam_flat() / scale, lam_ref / scale,
                                   rtol=2e-3, atol=2e-3, err_msg=be)
        np.testing.assert_allclose(res.dz_flat(), dz_ref,
                                   rtol=2e-3, atol=2e-3, err_msg=be)


@pytest.mark.parametrize("spec,rho", [
    (ProblemSpec(2, 1, 5), 1e-3),
    pytest.param(ProblemSpec(5, 4, 7), 1e-2, marks=_slow),
    pytest.param(ProblemSpec(3, 2, 64), 1e-4, marks=_slow),
    (ProblemSpec(1, 1, 4), 1e-3),
    pytest.param(ProblemSpec(17, 3, 6), 1e-2, marks=_slow),
    (ProblemSpec(2, 1, 2), 1e-3),               # minimal horizon
])
def test_direct_backends_match_dense_oracle(spec, rho, as_h100):
    """method='direct' by both algorithms (block Thomas, the CPU's choice;
    cyclic reduction, the H100's) against the f64 dense saddle-point oracle
    — the exact-solver analog of the PCG sweep above."""
    blocks = random_blocks(spec, seed=17)
    opts = SolverOptions(rho=rho, method="direct")
    lam_ref, dz_ref = dense_oracle(spec, blocks, rho=rho)
    scale = max(float(np.max(np.abs(lam_ref))), 1.0)
    for be in ("cr", "thomas"):
        if be == "thomas":
            as_h100()  # back to the CPU's own choice
        res = solve(spec, blocks, opts)
        assert int(res.iters) == 0 and bool(res.converged)
        np.testing.assert_allclose(res.lam_flat() / scale, lam_ref / scale,
                                   rtol=2e-4, atol=2e-4, err_msg=be)
        np.testing.assert_allclose(res.dz_flat(), dz_ref,
                                   rtol=2e-3, atol=2e-3, err_msg=be)

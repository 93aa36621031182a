"""The reference's end-to-end integration test, ported verbatim.

Same CSR data, same solver arguments, same dense NumPy saddle-point oracle,
same tolerances (rtol=1, atol=0.01) as the reference's test_pendulum_5.py.
This is the parity gate.
"""

import numpy as np
from scipy import sparse

import gato_tpu
from gato_tpu.testing import pendulum_problem


def test_pendulum_linsys_solve_matches_reference_oracle(capsys):
    p = pendulum_problem()
    testiters = 10
    exit_tol = 1e-6
    max_iters = 10
    warm_start = False
    input_lambda = [0.0] * 10
    rho = 0.001

    l, dz = gato_tpu.linsys_solve(
        p.G_row, p.G_col, p.G_val, p.C_row, p.C_col, p.C_val,
        p.g, p.c, input_lambda, testiters, exit_tol, max_iters,
        warm_start, rho,
    )

    # Oracle exactly as in test_pendulum_5.py:28-34 (unregularized dense solve;
    # the loose tolerances absorb the rho difference).
    G = sparse.csr_matrix((p.G_val, p.G_col, p.G_row)).todense()
    C = sparse.csr_matrix((p.C_val, p.C_col, p.C_row)).todense()
    A = np.block([[G, C.T], [C, np.zeros((C.shape[0], C.shape[0]))]])
    gamma = np.block([[np.array([p.g]).T], [np.array([p.c]).T]])
    x = np.linalg.inv(A).dot(gamma)
    x_gato = np.block([[np.array([dz]).T], [np.array([l]).T]])

    assert np.allclose(x_gato, x, rtol=1, atol=0.01)

    # Observable harness behavior: first-run iteration count + avg time printed.
    out = capsys.readouterr().out
    assert "first run PCG terminated in" in out
    assert "avg time:" in out


def test_pendulum_linsys_solve_triton_backend(as_h100):
    """The reference e2e flow through the Triton PCG kernel (the H100's
    default at this horizon; interpreted here) — same oracle, same
    tolerances."""
    p = pendulum_problem()
    l, dz = gato_tpu.linsys_solve(
        p.G_row, p.G_col, p.G_val, p.C_row, p.C_col, p.C_val,
        p.g, p.c, [0.0] * 10, 1, 1e-6, 10, False, 0.001,
        verbose=False,
    )
    l_ref, dz_ref = gato_tpu.linsys_solve(
        p.G_row, p.G_col, p.G_val, p.C_row, p.C_col, p.C_val,
        p.g, p.c, [0.0] * 10, 1, 1e-6, 10, False, 0.001,
        pcg_backend="jax", verbose=False,
    )
    # max_iters=10 is exhausted on this problem (as in the reference run),
    # so iterates carry un-damped f32 reduction-order differences.
    np.testing.assert_allclose(l, l_ref, rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(dz, dz_ref, rtol=1e-3, atol=1e-3)


def test_pendulum_spec_inference():
    p = pendulum_problem()
    spec = gato_tpu.infer_spec(p.C_row, p.g, p.c)
    assert (spec.state_size, spec.control_size, spec.knot_points) == (2, 1, 5)


def test_pendulum_tight_parity():
    """Beyond the reference's loose gate: against the rho-regularized oracle the
    solver should be accurate to f32 levels."""
    from gato_tpu.formats import pack_kkt
    from gato_tpu.solver import solve
    from gato_tpu.problem import SolverOptions
    from gato_tpu.testing import dense_oracle

    p = pendulum_problem()
    blocks = pack_kkt(p.spec, p.G_row, p.G_col, p.G_val,
                      p.C_row, p.C_col, p.C_val, p.g, p.c)
    rho = 0.001
    res = solve(p.spec, blocks,
                SolverOptions(exit_tol=1e-12, max_iters=200, rho=rho),
                pcg_backend="jax")
    lam_ref, dz_ref = dense_oracle(p.spec, blocks, rho=rho)
    np.testing.assert_allclose(res.lam_flat(), lam_ref, rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(res.dz_flat(), dz_ref, rtol=1e-3, atol=1e-3)

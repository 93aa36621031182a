"""API edge cases: degenerate budgets, minimal shapes, option plumbing."""

import numpy as np
import pytest

import gato_tpu
from gato_tpu import ProblemSpec, SolverOptions
from gato_tpu.solver import solve
from gato_tpu.testing import blocks_to_csr, dense_oracle, random_blocks


def test_max_iters_zero():
    """max_iters=0: the reference's for-loop never runs, leaving lambda=0 and
    iters initialized to maxIters=0 (gpu_library.cu:169, gato_pcg.cuh:311-313,348);
    dz is then recovered from lambda=0."""
    spec = ProblemSpec(3, 1, 6)
    blocks = random_blocks(spec, seed=1)
    res = solve(spec, blocks, SolverOptions(max_iters=0, rho=0.01),
                pcg_backend="jax")
    assert int(res.iters) == 0 and not bool(res.converged)
    np.testing.assert_array_equal(np.asarray(res.lam), 0.0)
    # dz from lambda=0 is G^{-1} g per block
    assert np.all(np.isfinite(np.asarray(res.dz_x)))


def test_rho_zero():
    spec = ProblemSpec(4, 2, 8)
    blocks = random_blocks(spec, seed=2)
    res = solve(spec, blocks, SolverOptions(rho=0.0, exit_tol=1e-12,
                                            max_iters=400), pcg_backend="jax")
    lam_ref, _ = dense_oracle(spec, blocks, rho=0.0)
    np.testing.assert_allclose(res.lam_flat(), lam_ref, rtol=2e-3, atol=2e-3)


def test_minimum_knots():
    """K=2 is the smallest valid trajectory (one interval)."""
    spec = ProblemSpec(3, 2, 2)
    blocks = random_blocks(spec, seed=3)
    for method in ("pcg", "direct"):
        res = solve(spec, blocks,
                    SolverOptions(rho=0.01, exit_tol=1e-12, max_iters=200,
                                  method=method), pcg_backend="jax")
        lam_ref, dz_ref = dense_oracle(spec, blocks, rho=0.01)
        np.testing.assert_allclose(res.lam_flat(), lam_ref, rtol=2e-3,
                                   atol=2e-3, err_msg=method)
        np.testing.assert_allclose(res.dz_flat(), dz_ref, rtol=2e-3,
                                   atol=2e-3, err_msg=method)


def test_control_wider_than_state():
    """c > s is legal (underactuated notation flipped)."""
    spec = ProblemSpec(2, 5, 6)
    blocks = random_blocks(spec, seed=4)
    res = solve(spec, blocks, SolverOptions(rho=0.01, exit_tol=1e-12,
                                            max_iters=400), pcg_backend="jax")
    lam_ref, dz_ref = dense_oracle(spec, blocks, rho=0.01)
    np.testing.assert_allclose(res.lam_flat(), lam_ref, rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(res.dz_flat(), dz_ref, rtol=2e-3, atol=2e-3)


def test_linsys_solve_explicit_spec_overrides_inference():
    spec = ProblemSpec(4, 2, 12)
    p = blocks_to_csr(spec, random_blocks(spec, seed=5))
    l, dz = gato_tpu.linsys_solve(
        p.G_row, p.G_col, p.G_val, p.C_row, p.C_col, p.C_val, p.g, p.c,
        [0.0] * spec.nl, 1, 1e-8, 300, False, 0.01,
        spec=spec, verbose=False,
    )
    assert len(l) == spec.nl and len(dz) == spec.nz


def test_invalid_spec_raises():
    with pytest.raises(ValueError):
        ProblemSpec(0, 1, 5)
    with pytest.raises(ValueError):
        ProblemSpec(2, 1, 1)


def test_ill_conditioned_direct_robust():
    """Nearly-singular Hessian blocks (tiny rho): direct stays accurate."""
    spec = ProblemSpec(4, 2, 10)
    blocks = random_blocks(spec, seed=6, diag_G=True)
    # scale some Q diagonals down hard
    Q = np.asarray(blocks.Q).copy()
    Q[::2] *= 1e-3
    blocks = blocks._replace(Q=Q)
    rho = 1e-5
    res = solve(spec, blocks, SolverOptions(rho=rho, method="direct"))
    lam_ref, _ = dense_oracle(spec, blocks, rho=rho)
    scale = max(1.0, np.abs(lam_ref).max())
    np.testing.assert_allclose(res.lam_flat(), lam_ref, atol=5e-3 * scale)


def test_import_keeps_kernels_lazy():
    """`import gato_tpu` must not import the Pallas kernel modules: the
    one dispatch site (solver._pcg_batched) lazy-imports them so the
    pure-XLA/f64 paths keep working where Pallas cannot import.
    Run in a subprocess — this suite's process has long since loaded them."""
    import subprocess
    import sys

    out = subprocess.run(
        [sys.executable, "-c",
         "import jax; jax.config.update('jax_platforms', 'cpu')\n"
         "import sys, gato_tpu\n"
         "bad = [m for m in sys.modules if 'gato_tpu.kernels' in m]\n"
         "assert not bad, bad\n"
         "print('ok')"],
        capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_malformed_blocks_rejected_on_every_backend():
    """The kernel path zero-pads whatever it is given (pcg_triton pads to
    its tiles), so a malformed field must be rejected at the surface,
    before any backend is chosen."""
    from gato_tpu.solver import solve_batched

    spec = ProblemSpec(2, 1, 5)
    blocks = random_blocks(spec, seed=3)
    bad = blocks._replace(c=np.asarray(blocks.c)[:-1])  # (K-1, s) slip
    for be in ("jax", "triton"):
        with pytest.raises(ValueError, match="blocks.c shape"):
            solve(spec, bad, SolverOptions(), pcg_backend=be)
    with pytest.raises(ValueError, match="leading batch axis"):
        solve_batched(spec, blocks, SolverOptions())  # no batch axis


def test_malformed_sequence_blocks_rejected():
    import jax.numpy as jnp

    from gato_tpu import solve_sequence

    spec = ProblemSpec(2, 1, 5)
    blocks = random_blocks(spec, seed=4)
    T = 3
    seq = type(blocks)(*(jnp.broadcast_to(jnp.asarray(a), (T,) + a.shape)
                         for a in blocks))
    bad = seq._replace(c=np.asarray(seq.c)[:, :-1])
    with pytest.raises(ValueError, match="blocks.c shape"):
        solve_sequence(spec, bad, SolverOptions())


def test_solver_options_preconditioner_strings():
    """The enum's string values are accepted (the kernel-level APIs use
    exactly these strings); unknown names raise at construction instead of
    an AttributeError deep in the solve."""
    from gato_tpu.problem import Preconditioner

    o = SolverOptions(preconditioner="symmetric_stair")
    assert o.preconditioner is Preconditioner.SYMMETRIC_STAIR
    spec = ProblemSpec(2, 1, 5)
    blocks = random_blocks(spec, seed=5)
    res = solve(spec, blocks, SolverOptions(preconditioner="jacobi"),
                pcg_backend="jax")
    assert bool(res.converged)
    with pytest.raises(ValueError):
        SolverOptions(preconditioner="block-jacobi")

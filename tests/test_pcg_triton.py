"""The Triton PCG kernel (kernels/pcg_triton.py) against pcg.pcg.

On the CPU the kernel runs in the Pallas interpreter (``interpret=True``):
same program, same phases, the block barriers elided.  The compiled kernel
runs under the ``gpu`` marker on the card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gato_tpu import ProblemSpec, SolverOptions, assemble, dispatch
from gato_tpu import pcg as pcg_mod
from gato_tpu.formats import KKTBlocks
from gato_tpu.kernels import pcg_triton as pt
from gato_tpu.mpc import solve_sequence
from gato_tpu.problem import Preconditioner
from gato_tpu.solver import solve, solve_batched
from gato_tpu.testing import random_blocks

SHAPES = {
    "pendulum": ProblemSpec(2, 1, 5),
    "odd_K": ProblemSpec(4, 2, 37),
    "iiwa_width": ProblemSpec(14, 7, 6),
}
TOL = 1e-6


def _system(spec, precond, B=2, seed=0, rho=1e-2):
    bl = [random_blocks(spec, seed=seed + i) for i in range(B)]
    st = [jnp.asarray(np.stack([np.asarray(b[f]) for b in bl]))
          for f in range(7)]
    return jax.vmap(lambda *x: assemble.condense(*x, rho, precond))(*st)


def _reference(sys, lam0, max_iters=300, poly_degree=1):
    return jax.vmap(lambda S, P, g, l: pcg_mod.pcg(
        S, P, g, l, exit_tol=TOL, max_iters=max_iters,
        poly_degree=poly_degree))(sys.S, sys.Pinv, sys.gamma, lam0)


def _kernel(sys, lam0, max_iters=300, poly_degree=1, tol=TOL):
    return pt.pcg_triton(sys.S, sys.Pinv, sys.gamma, lam0, tol, max_iters,
                         poly_degree=poly_degree, interpret=True)


def _assert_matches(got, ref):
    """Equal iteration counts, except the +-1 tie CLAUDE.md documents: the
    early-exiting side's eta must then sit within float32 round-off of the
    exit tolerance.  Solutions agree to the exit tolerance (the backend
    parity bound of the other CPU tests)."""
    gi, ri = np.asarray(got.iters), np.asarray(ref.iters)
    for b in range(gi.shape[0]):
        if gi[b] != ri[b]:
            assert abs(int(gi[b]) - int(ri[b])) == 1, (gi, ri)
            early = got.eta[b] if gi[b] < ri[b] else ref.eta[b]
            assert 0.9 * TOL <= float(early) <= TOL, (gi, ri, early)
    np.testing.assert_array_equal(np.asarray(got.converged),
                                  np.asarray(ref.converged))
    scale = float(jnp.max(jnp.abs(ref.lam))) or 1.0
    np.testing.assert_allclose(np.asarray(got.lam) / scale,
                               np.asarray(ref.lam) / scale, atol=1e-4)


# Scalar Jacobi runs at degree 1 only: its degree-2 polynomial is not
# positive definite on these systems, so CG itself is erratic there.
PRECOND_DEGREES = [(Preconditioner.SYMMETRIC_STAIR, 1),
                   (Preconditioner.SYMMETRIC_STAIR, 2),
                   (Preconditioner.BLOCK_JACOBI, 1),
                   (Preconditioner.BLOCK_JACOBI, 2),
                   (Preconditioner.JACOBI, 1)]


@pytest.mark.parametrize("warm", [False, True], ids=["cold", "warm"])
@pytest.mark.parametrize("precond,poly_degree", PRECOND_DEGREES)
@pytest.mark.parametrize("shape", list(SHAPES))
def test_kernel_matches_pcg(shape, precond, poly_degree, warm):
    spec = SHAPES[shape]
    # Scalar Jacobi leaves the Schur system badly conditioned at rho=1e-2
    # (more iterations than unknowns, where float32 CG loses orthogonality
    # and any change of summation order changes the count); a larger rho
    # keeps the comparison on a numerically stable iteration.
    rho = 1.0 if precond == Preconditioner.JACOBI else 1e-2
    sys = _system(spec, precond, rho=rho)
    lam0 = (0.1 * jnp.ones_like(sys.gamma) if warm
            else jnp.zeros_like(sys.gamma))
    ref = _reference(sys, lam0, poly_degree=poly_degree)
    assert bool(jnp.all(ref.converged))
    _assert_matches(_kernel(sys, lam0, poly_degree=poly_degree), ref)


def test_per_problem_exit_in_batch():
    """Problems of one batch exit on their own counts: one program each."""
    spec = ProblemSpec(4, 2, 12)
    bl = [random_blocks(spec, seed=i) for i in range(3)]
    # Scale one problem's costs so its Schur system conditions differently.
    bl[1] = bl[1]._replace(Q=np.asarray(bl[1].Q) * 50.0)
    st = [jnp.asarray(np.stack([np.asarray(b[f]) for b in bl]))
          for f in range(7)]
    sys = jax.vmap(lambda *x: assemble.condense(
        *x, 1e-2, Preconditioner.BLOCK_JACOBI))(*st)
    lam0 = jnp.zeros_like(sys.gamma)
    ref = _reference(sys, lam0)
    got = _kernel(sys, lam0)
    assert len(set(np.asarray(ref.iters).tolist())) > 1
    _assert_matches(got, ref)


def _singular_system():
    spec = ProblemSpec(4, 2, 8)
    b = random_blocks(spec, seed=3)
    Q = np.asarray(b.Q).copy()
    Q[2, :, 0] = 0.0
    Q[2, 0, :] = 0.0
    good = [jnp.asarray(np.asarray(x))[None] for x in b]
    bad = [jnp.asarray(np.asarray(x))[None] for x in b._replace(Q=Q)]
    st = [jnp.concatenate([g, s]) for g, s in zip(good, bad)]
    return jax.vmap(lambda *x: assemble.condense(
        *x, 0.0, Preconditioner.SYMMETRIC_STAIR))(*st)


def test_singular_runs_to_cap_not_converged():
    """A singular block NaN-poisons only its own problem: it runs to the cap
    and reports not converged; its healthy batch neighbour converges."""
    sys = _singular_system()
    got = _kernel(sys, jnp.zeros_like(sys.gamma), max_iters=40)
    assert bool(got.converged[0]) and not bool(got.converged[1])
    assert int(got.iters[1]) == 40


def test_stall_reports_not_converged():
    """An unreachable tolerance exhausts the cap on both paths."""
    sys = _system(ProblemSpec(4, 2, 8), Preconditioner.SYMMETRIC_STAIR)
    lam0 = jnp.zeros_like(sys.gamma)
    got = _kernel(sys, lam0, max_iters=3)
    ref = _reference(sys, lam0, max_iters=3)
    assert not bool(jnp.any(got.converged))
    np.testing.assert_array_equal(np.asarray(got.iters), [3, 3])
    np.testing.assert_allclose(np.asarray(got.lam), np.asarray(ref.lam),
                               rtol=1e-4, atol=1e-5)


def test_zero_rhs_and_zero_cap():
    """gamma == 0 converges at iteration 0 with lam == 0 (the nu == 0
    guard); max_iters == 0 returns the start with iters == 0."""
    sys = _system(ProblemSpec(3, 2, 6), Preconditioner.SYMMETRIC_STAIR)
    zero = jnp.zeros_like(sys.gamma)
    got = pt.pcg_triton(sys.S, sys.Pinv, zero, zero, TOL, 50,
                        interpret=True)
    assert bool(jnp.all(got.converged))
    np.testing.assert_array_equal(np.asarray(got.iters), [0, 0])
    assert float(jnp.max(jnp.abs(got.lam))) == 0.0
    capped = _kernel(sys, zero, max_iters=0)
    np.testing.assert_array_equal(np.asarray(capped.iters), [0, 0])
    assert not bool(jnp.any(capped.converged))


@pytest.mark.parametrize("K,s", [(1, 1), (5, 2), (50, 14), (1024, 14),
                                 (7, 17), (3, 40)])
def test_plan_shapes(K, s):
    """Padding: SP a power of two >= 16 and >= s; KT a power of two; KP the
    knots rounded up to whole tiles; KH one zero halo row before and at
    least one after, in whole tiles."""
    SP, KT, KP, KH = pt.plan(K, s)
    for n in (SP, KT):
        assert n & (n - 1) == 0
    assert SP >= max(16, s)
    assert KT * SP * SP <= pt._TILE_ELEMS or KT == 1
    assert KP >= K and KP % KT == 0
    assert KH >= KP + 2 and KH % KT == 0


@pytest.mark.parametrize("entry", ["solve", "solve_batched",
                                   "solve_sequence"])
def test_solver_routes_to_kernel(as_h100, entry):
    """Auto dispatch on an H100 at a short horizon runs the kernel; the
    public entry points then agree with the XLA path."""
    spec = ProblemSpec(3, 2, 8)
    opts = SolverOptions(rho=1e-2, exit_tol=TOL, max_iters=200)
    blocks = random_blocks(spec, seed=4)
    if entry == "solve_batched":
        blocks = KKTBlocks(*(np.stack([np.asarray(a)] * 2) for a in blocks))
    if entry == "solve_sequence":
        blocks = KKTBlocks(*(np.stack([np.asarray(a)] * 3) for a in blocks))
    fn = {"solve": solve, "solve_batched": solve_batched,
          "solve_sequence": solve_sequence}[entry]
    ref = fn(spec, blocks, opts, pcg_backend="jax")
    assert dispatch.choose_backend("pcg", None, dtype="float32",
                                   K=8) == "triton"
    got = fn(spec, blocks, opts)
    np.testing.assert_array_equal(np.asarray(got.iters),
                                  np.asarray(ref.iters))
    np.testing.assert_allclose(np.asarray(got.dz_x), np.asarray(ref.dz_x),
                               rtol=1e-4, atol=1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("precond,poly_degree", PRECOND_DEGREES[:4])
def test_compiled_kernel_matches_pcg(gpu, precond, poly_degree):
    """The kernel as compiled for the card, at the IIWA shape, against the
    XLA while loop on the same card: degree 2 runs the extra barrier-separated
    tile passes that the interpreter cannot check for a missing barrier."""
    sys = _system(ProblemSpec(14, 7, 50), precond, B=4)
    lam0 = jnp.zeros_like(sys.gamma)
    ref = _reference(sys, lam0, poly_degree=poly_degree)
    got = pt.pcg_triton(sys.S, sys.Pinv, sys.gamma, lam0, TOL, 300,
                        poly_degree=poly_degree)
    _assert_matches(got, ref)


@pytest.mark.gpu
def test_explicit_triton_runs_on_gpu(gpu):
    spec = ProblemSpec(14, 7, 50)
    blocks = random_blocks(spec, seed=1)
    opts = SolverOptions(rho=1e-3, exit_tol=1e-6, max_iters=200)
    ref = solve(spec, blocks, opts, pcg_backend="jax")
    got = solve(spec, blocks, opts, pcg_backend="triton")
    assert int(got.iters) == int(ref.iters)
    np.testing.assert_allclose(np.asarray(got.lam), np.asarray(ref.lam),
                               rtol=1e-3, atol=1e-4)

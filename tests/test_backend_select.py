"""Backend choice (dispatch.choose_backend) and request validation.

The reference selects its PCG kernel explicitly and exits rather than
silently degrading (check_sms, gato_utils.cuh:836-854); these tests pin the
same contract here: unknown or platform-incompatible explicit backends raise,
and automatic choices follow the table of measured devices.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from gato_tpu import ProblemSpec, SolverOptions, dispatch
from gato_tpu.formats import KKTBlocks
from gato_tpu.mpc import solve_sequence, solve_sequence_batched
from gato_tpu.solver import VALID_PCG_BACKENDS, solve, solve_batched
from gato_tpu.testing import random_blocks

SPEC = ProblemSpec(3, 2, 8)
OPTS = SolverOptions(rho=0.01, exit_tol=1e-8, max_iters=200)
H100 = ("gpu", "NVIDIA H100 80GB HBM3")
CPU = ("cpu", "cpu")
OTHER_GPU = ("gpu", "NVIDIA A100-SXM4-80GB")


def _blocks(seed=0):
    return random_blocks(SPEC, seed=seed)


def _lead(blocks, *lead):
    return KKTBlocks(*(np.broadcast_to(np.asarray(a), lead + np.shape(a))
                       for a in blocks))


# (device, method, requested, dtype, K, poly_degree) -> backend
TABLE = [
    (CPU, "pcg", None, "float32", 50, 1, "jax"),
    (CPU, "pcg", "jax", "float32", 50, 1, "jax"),
    (CPU, "direct", None, "float32", 50, 1, "thomas"),
    (CPU, "direct", "jax", "float64", 4096, 1, "thomas"),
    (H100, "pcg", None, "float32", 50, 1, "triton"),
    (H100, "pcg", None, "float32", 128, 1, "triton"),
    (H100, "pcg", None, "float32", 129, 1, "jax"),
    (H100, "pcg", None, "float32", 1024, 1, "jax"),
    (H100, "pcg", None, "float32", 50, 2, "triton"),
    (H100, "pcg", None, "float32", 51, 2, "jax"),
    (H100, "pcg", None, "float32", 128, 2, "jax"),
    (H100, "pcg", None, "float32", 50, 3, "jax"),
    (H100, "pcg", "triton", "float32", 128, 3, "triton"),
    (H100, "pcg", None, "float64", 50, 1, "jax"),
    (H100, "pcg", "jax", "float32", 50, 1, "jax"),
    (H100, "pcg", "triton", "float32", 4096, 1, "triton"),
    (H100, "direct", None, "float32", 50, 1, "cr"),
    (H100, "direct", None, "float32", 4096, 2, "cr"),
    (H100, "direct", "jax", "float64", 50, 1, "cr"),
    (OTHER_GPU, "pcg", None, "float32", 50, 1, "jax"),
    (OTHER_GPU, "pcg", "triton", "float32", 50, 1, "triton"),
    (OTHER_GPU, "direct", None, "float32", 50, 1, "thomas"),
]


@pytest.mark.parametrize("device,method,requested,dtype,K,degree,want",
                         TABLE)
def test_choice_table(device, method, requested, dtype, K, degree, want):
    got = dispatch.choose_backend(method, requested, dtype=dtype, K=K,
                                  poly_degree=degree, device=device)
    assert got == want


@pytest.mark.parametrize("device,method,requested,dtype,match", [
    (CPU, "pcg", "triton", "float32", "CUDA GPU only"),
    (H100, "pcg", "triton", "float64", "float32 kernel"),
    (H100, "direct", "triton", "float32", "method='direct'"),
    (H100, "pcg", "fused", "float32", "unknown pcg_backend"),
    (H100, "pcg", "pallas", "float32", "unknown pcg_backend"),
    (CPU, "thomas", None, "float32", "unknown method"),
])
def test_choice_rejects(device, method, requested, dtype, match):
    with pytest.raises(ValueError, match=match):
        dispatch.choose_backend(method, requested, dtype=dtype, K=8,
                                device=device)


def test_current_device_reads_default_device():
    import jax

    d = jax.devices()[0]
    assert dispatch.current_device() == (d.platform, d.device_kind)


@pytest.mark.parametrize("entry", ["solve", "solve_batched", "solve_sequence",
                                   "solve_sequence_batched"])
def test_explicit_kernel_raises_on_cpu(entry):
    """An explicit kernel request this platform cannot compile raises — it
    is never run in the interpreter instead."""
    fn, lead = {"solve": (solve, ()), "solve_batched": (solve_batched, (2,)),
                "solve_sequence": (solve_sequence, (3,)),
                "solve_sequence_batched": (solve_sequence_batched,
                                           (3, 2))}[entry]
    with pytest.raises(ValueError, match="CUDA GPU only"):
        fn(SPEC, _lead(_blocks(), *lead), OPTS, pcg_backend="triton")


@pytest.mark.parametrize("entry,name", [("solve", "fast"),
                                        ("solve", "PALLAS"),
                                        ("solve_batched", "fsued"),
                                        ("solve_sequence", "nope")])
def test_unknown_backend_raises(entry, name):
    fn, lead = {"solve": (solve, ()), "solve_batched": (solve_batched, (2,)),
                "solve_sequence": (solve_sequence, (3,))}[entry]
    with pytest.raises(ValueError, match="unknown pcg_backend"):
        fn(SPEC, _lead(_blocks(), *lead), OPTS, pcg_backend=name)


def test_valid_backends_are_exhaustive():
    assert VALID_PCG_BACKENDS == ("jax", "triton")


def test_options_validation():
    with pytest.raises(ValueError, match="precond_poly_degree"):
        SolverOptions(precond_poly_degree=0)
    with pytest.raises(ValueError, match="precond_poly_degree"):
        SolverOptions(precond_poly_degree=-2)
    with pytest.raises(ValueError, match="method"):
        SolverOptions(method="thomas")


def test_solve_debug_matches_solve_at_poly_degree_2():
    from gato_tpu.debug import solve_debug

    opts = SolverOptions(rho=0.01, exit_tol=1e-8, max_iters=100,
                         precond_poly_degree=2)
    blocks = _blocks(seed=11)
    ref = solve(SPEC, blocks, opts, pcg_backend="jax")
    dbg = solve_debug(SPEC, blocks, opts)
    assert int(dbg.result.iters) == int(ref.iters)
    np.testing.assert_allclose(np.asarray(dbg.result.lam), np.asarray(ref.lam),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("degree,want", [(1, "triton"), (2, "triton"),
                                          (3, "jax")])
def test_entry_points_forward_poly_degree(as_h100, monkeypatch, degree,
                                          want):
    """solve passes precond_poly_degree to the chooser: on an H100 at K=8
    degrees 1 and 2 run the kernel, an unmeasured degree runs XLA."""
    from gato_tpu import solver as solver_mod

    seen = []
    real = dispatch.choose_backend

    def recorder(method, requested, **k):
        seen.append(real(method, requested, **k))
        return seen[-1]

    monkeypatch.setattr(solver_mod, "choose_backend", recorder)
    opts = SolverOptions(rho=0.01, exit_tol=1e-8, max_iters=200,
                         precond_poly_degree=degree)
    res = solve(SPEC, _blocks(seed=5), opts)
    assert seen == [want]
    assert bool(res.converged)


def test_f64_runs_xla_on_h100(as_h100):
    """float64 compute on a GPU takes the XLA path automatically."""
    import jax

    spec = ProblemSpec(2, 1, 5)
    with jax.enable_x64(True):
        res = solve(spec, random_blocks(spec, seed=3),
                    SolverOptions(dtype="float64"))
        assert res.lam.dtype == jnp.float64

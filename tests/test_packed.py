"""Packed-input serving API (gato_tpu.packed) vs the standard surface.

The packed path runs solve_batched's jitted core, with the backend dispatch
picks, on the SAME staged arrays — so outputs must be bit-identical, not
merely close.  The ``as_h100`` cases run the H100's choices (Triton kernel
interpreted, cyclic reduction) on the CPU."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gato_tpu import ProblemSpec, SolverOptions
from gato_tpu import packed as pk
from gato_tpu.formats import KKTBlocks
from gato_tpu.solver import _solve_batched_core, solve_batched
from gato_tpu.testing import random_blocks

SPEC = ProblemSpec(3, 2, 10)
OPTS = SolverOptions(rho=1e-3, exit_tol=1e-10, max_iters=300)


def _stack(spec, n, seed0=0):
    problems = [random_blocks(spec, seed=seed0 + i) for i in range(n)]
    return problems, KKTBlocks(*(jnp.asarray(np.stack(
        [np.asarray(p[f]) for p in problems])) for f in range(7)))


def _assert_same(res, ref):
    np.testing.assert_array_equal(np.asarray(res.iters), np.asarray(ref.iters))
    np.testing.assert_array_equal(np.asarray(res.lam), np.asarray(ref.lam))
    np.testing.assert_array_equal(np.asarray(res.dz_x), np.asarray(ref.dz_x))
    np.testing.assert_array_equal(np.asarray(res.dz_u), np.asarray(ref.dz_u))
    np.testing.assert_array_equal(np.asarray(res.converged),
                                  np.asarray(ref.converged))


@pytest.mark.parametrize("device", ["cpu", "h100"])
@pytest.mark.parametrize("method", ["pcg", "direct"])
def test_packed_matches_solve_batched(method, device, as_h100):
    if device == "cpu":
        as_h100()
    _, bb = _stack(SPEC, 5, seed0=11)
    opts = dataclasses.replace(OPTS, method=method)
    ref = solve_batched(SPEC, bb, opts)
    res = pk.solve_packed(pk.pack(SPEC, bb), opts).unpack()
    _assert_same(res, ref)
    np.testing.assert_array_equal(np.asarray(res.eta), np.asarray(ref.eta))


@pytest.mark.parametrize("method", ["pcg", "direct"])
def test_packed_single_problem(method):
    problems, _ = _stack(SPEC, 1, seed0=40)
    opts = dataclasses.replace(OPTS, method=method)
    ref = solve_batched(SPEC, KKTBlocks(*(np.asarray(a)[None]
                                          for a in problems[0])), opts)
    res = pk.solve_packed(pk.pack(SPEC, problems[0]), opts).unpack()
    assert res.lam.shape == (SPEC.knot_points, SPEC.state_size)  # unbatched
    assert res.iters.shape == ()
    _assert_same(res, type(ref)(*(x[0] for x in ref)))


@pytest.mark.parametrize("precond", ["jacobi", "block_jacobi"])
def test_packed_preconditioner_variants(precond):
    from gato_tpu.problem import Preconditioner

    _, bb = _stack(SPEC, 3, seed0=55)
    opts = dataclasses.replace(OPTS, preconditioner=Preconditioner(precond))
    ref = solve_batched(SPEC, bb, opts)
    res = pk.solve_packed(pk.pack(SPEC, bb), opts).unpack()
    _assert_same(res, ref)


def test_update_vectors_matches_full_repack():
    problems, bb = _stack(SPEC, 3, seed0=70)
    packed = pk.pack(SPEC, bb)
    # Fresh rhs on the same matrices: full repack vs vector-only refresh.
    _, bb2 = _stack(SPEC, 3, seed0=170)
    bb_mixed = KKTBlocks(Q=bb.Q, R=bb.R, A=bb.A, B=bb.B,
                         q=bb2.q, r=bb2.r, c=bb2.c)
    full = pk.pack(SPEC, bb_mixed)
    refreshed = pk.update_vectors(packed, bb2.q, bb2.r, bb2.c)
    for f in ("Q", "R", "A", "B", "q", "r", "c"):
        np.testing.assert_array_equal(np.asarray(getattr(full, f)),
                                      np.asarray(getattr(refreshed, f)))
    res = pk.solve_packed(refreshed, OPTS).unpack()
    ref = solve_batched(SPEC, bb_mixed, OPTS)
    _assert_same(res, ref)


def test_packed_warm_start_carry():
    _, bb = _stack(SPEC, 2, seed0=100)
    packed = pk.pack(SPEC, bb)
    first = pk.solve_packed(packed, OPTS)
    # The carry re-solves the same system in <= 1 iteration ...
    again = pk.solve_packed(packed, OPTS, lam0=first.lam_packed)
    assert int(np.max(np.asarray(again.iters))) <= 1
    # ... and is bit-identical to feeding the unpacked lambda back in.
    res_pub = pk.solve_packed(packed, OPTS, lam0=first.unpack().lam)
    np.testing.assert_array_equal(np.asarray(again.unpack().lam),
                                  np.asarray(res_pub.unpack().lam))


def test_packed_is_jit_transparent():
    """PackedKKT/PackedSolveResult are pytrees with static plans, and a
    second same-plan solve hits the jit cache (retrace-free serving loop)."""
    _, bb = _stack(SPEC, 2, seed0=130)
    packed = pk.pack(SPEC, bb)
    leaves, treedef = jax.tree_util.tree_flatten(packed)
    assert len(leaves) == 7
    rebuilt = jax.tree_util.tree_unflatten(treedef, leaves)
    assert rebuilt.plan == packed.plan
    res = pk.solve_packed(packed, OPTS)
    assert len(jax.tree_util.tree_leaves(res)) == 6
    first = _solve_batched_core._cache_size()
    pk.solve_packed(packed, dataclasses.replace(OPTS, rho=2e-3))
    assert _solve_batched_core._cache_size() == first


def test_one_pack_serves_both_methods():
    """The staged layout is method-independent: one pack, PCG and exact
    solves chosen per call, each bitwise equal to solve_batched."""
    _, bb = _stack(SPEC, 3, seed0=200)
    packed = pk.pack(SPEC, bb)
    for method in ("pcg", "direct"):
        opts = dataclasses.replace(OPTS, method=method)
        _assert_same(pk.solve_packed(packed, opts).unpack(),
                     solve_batched(SPEC, bb, opts))


@pytest.mark.parametrize("method", ["pcg", "direct"])
def test_packed_float64(method):
    """A float64 pack solves in float64, bitwise equal to solve_batched at
    dtype float64; a pack casts to float32 unless asked otherwise."""
    _, bb = _stack(SPEC, 3, seed0=210)
    assert pk.pack(SPEC, bb).plan.dtype == "float32"
    opts = dataclasses.replace(OPTS, method=method, dtype="float64")
    with jax.enable_x64(True):
        packed = pk.pack(SPEC, bb, dtype="float64")
        res = pk.solve_packed(packed, opts).unpack()
        assert res.lam.dtype == jnp.float64
        _assert_same(res, solve_batched(SPEC, bb, opts))


def test_packed_validation():
    problems, bb = _stack(SPEC, 2, seed0=160)
    packed = pk.pack(SPEC, bb)
    with pytest.raises(ValueError, match="float32"):
        pk.solve_packed(packed, dataclasses.replace(OPTS, dtype="float64"))
    with pytest.raises(ValueError, match="does not match"):
        pk.pack(ProblemSpec(4, 2, 10), bb)
    # Vector fields are validated too: a (K-1)-row c (easy slip — r IS
    # (K-1, c)) must raise, not broadcast into a silently-wrong system.
    bad = bb._replace(c=np.asarray(bb.c)[:, :-1, :])
    with pytest.raises(ValueError, match="blocks.c shape"):
        pk.pack(SPEC, bad)
    with pytest.raises(ValueError, match="q shape"):
        pk.update_vectors(packed, np.zeros((2, 4, 3), np.float32),
                          problems[0].r, problems[0].c)
    with pytest.raises(ValueError, match="lam0 shape"):
        pk.solve_packed(packed, OPTS, lam0=np.zeros((7, 7), np.float32))
    # Unbatched pack: a wrong-sized public lam0 must hit the diagnostic
    # ValueError, not an opaque reshape error.
    single = pk.pack(SPEC, problems[0])
    with pytest.raises(ValueError, match="lam0 shape"):
        pk.solve_packed(single, OPTS, lam0=np.zeros(
            (SPEC.knot_points, SPEC.state_size + 1), np.float32))


# ---------------------------------------------------------------------------
# Sequence farms (pack_sequence / solve_packed_sequence)
# ---------------------------------------------------------------------------


def _seq_stack(spec, T, B, seed0=0):
    rng = np.random.default_rng(seed0)
    _, base = _stack(spec, B, seed0=seed0)
    qs = (np.asarray(base.q)[None]
          + 0.01 * rng.normal(size=(T,) + base.q.shape)).astype(np.float32)
    return KKTBlocks(*(jnp.broadcast_to(jnp.asarray(a), (T,) + a.shape)
                       for a in base))._replace(q=jnp.asarray(qs))


def test_packed_sequence_matches_mpc():
    """Same core, same staged arrays -> bit-identical to the public
    mpc.solve_sequence_batched farm."""
    from gato_tpu.mpc import solve_sequence_batched

    seq = _seq_stack(SPEC, T=4, B=3, seed0=20)
    ref = solve_sequence_batched(SPEC, seq, OPTS)
    ps = pk.pack_sequence(SPEC, seq)
    res = pk.solve_packed_sequence(ps, OPTS).unpack()
    _assert_same(res, ref)


def test_packed_sequence_window_carry():
    """A long stream served as two packed windows with the lambda carry
    must reproduce the single-window run exactly — the streaming serving
    loop's steady state."""
    seq = _seq_stack(SPEC, T=6, B=3, seed0=21)
    full = pk.solve_packed_sequence(pk.pack_sequence(SPEC, seq), OPTS)

    first = KKTBlocks(*(a[:3] for a in seq))
    second = KKTBlocks(*(a[3:] for a in seq))
    r1 = pk.solve_packed_sequence(pk.pack_sequence(SPEC, first), OPTS)
    r2 = pk.solve_packed_sequence(pk.pack_sequence(SPEC, second), OPTS,
                                  lam0=r1.lam_tail_packed)
    np.testing.assert_array_equal(
        np.concatenate([np.asarray(r1.iters), np.asarray(r2.iters)]),
        np.asarray(full.iters))
    np.testing.assert_array_equal(
        np.concatenate([np.asarray(r1.unpack().lam),
                        np.asarray(r2.unpack().lam)]),
        np.asarray(full.unpack().lam))


def test_pack_sequence_validation():
    seq = _seq_stack(SPEC, T=2, B=2, seed0=22)
    with pytest.raises(ValueError, match="leading \\(T, B\\) axes"):
        pk.pack_sequence(SPEC, KKTBlocks(*(a[0] for a in seq)))
    with pytest.raises(ValueError, match="method='direct'"):
        pk.solve_packed_sequence(
            pk.pack_sequence(SPEC, seq),
            SolverOptions(rho=1e-3, method="direct"))
    with pytest.raises(ValueError, match="lam0 shape"):
        pk.solve_packed_sequence(pk.pack_sequence(SPEC, seq), OPTS,
                                 lam0=jnp.zeros((7, 7)))

"""Multi-device paths on the 8-virtual-device CPU mesh (conftest forces
xla_force_host_platform_device_count=8)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh, PartitionSpec as P

from gato_tpu import ProblemSpec, SolverOptions
from gato_tpu.assemble import condense
from gato_tpu.formats import KKTBlocks
from gato_tpu.parallel.sharded import pcg_sharded, solve_sharded
from gato_tpu.pcg import pcg
from gato_tpu.solver import solve
from gato_tpu.testing import dense_oracle, random_blocks


def _mesh(n, name="knot"):
    devs = jax.devices()[:n]
    return Mesh(np.array(devs), (name,))


def test_8_devices_available():
    assert len(jax.devices()) >= 8


@pytest.mark.parametrize("n_dev", [2, 4, 8])
def test_pcg_sharded_matches_single(n_dev):
    spec = ProblemSpec(4, 2, 32)
    blocks = random_blocks(spec, seed=8)
    sys = condense(*(jnp.asarray(a) for a in blocks), rho=jnp.float32(0.01))

    single = pcg(sys.S, sys.Pinv, sys.gamma, exit_tol=1e-10, max_iters=300)
    sharded = pcg_sharded(
        _mesh(n_dev), sys.S, sys.Pinv, sys.gamma,
        exit_tol=1e-10, max_iters=300,
    )
    assert bool(sharded.converged)
    # Same algorithm, different reduction order: expect near-identical iterates.
    assert abs(int(sharded.iters) - int(single.iters)) <= 2
    np.testing.assert_allclose(
        np.asarray(sharded.lam), np.asarray(single.lam), rtol=1e-3, atol=1e-4
    )


def test_solve_sharded_matches_oracle():
    spec = ProblemSpec(4, 2, 32)
    blocks = random_blocks(spec, seed=17)
    rho = 0.01
    res, dz_x, dz_u = solve_sharded(
        _mesh(8),
        *(jnp.asarray(a) for a in blocks),
        rho=rho, exit_tol=1e-12, max_iters=500,
    )
    lam_ref, dz_ref = dense_oracle(spec, blocks, rho=rho)
    assert bool(res.converged)
    np.testing.assert_allclose(
        np.asarray(res.lam).reshape(-1), lam_ref, rtol=2e-3, atol=2e-3
    )
    single = solve(spec, blocks, SolverOptions(exit_tol=1e-12, max_iters=500,
                                               rho=rho), pcg_backend="jax")
    np.testing.assert_allclose(
        np.asarray(dz_x), np.asarray(single.dz_x), rtol=1e-3, atol=1e-4
    )
    np.testing.assert_allclose(
        np.asarray(dz_u), np.asarray(single.dz_u), rtol=1e-3, atol=1e-4
    )


def test_sharded_rejects_indivisible():
    spec = ProblemSpec(3, 1, 30)
    blocks = random_blocks(spec, seed=2)
    sys = condense(*(jnp.asarray(a) for a in blocks), rho=jnp.float32(0.01))
    with pytest.raises(ValueError):
        pcg_sharded(_mesh(8), sys.S, sys.Pinv, sys.gamma)


def test_batch_sharding_dp():
    """Plain data parallelism: a batch of problems sharded over devices via
    sharding annotations only (no shard_map needed)."""
    from gato_tpu.formats import KKTBlocks
    from gato_tpu.solver import solve_batched

    spec = ProblemSpec(3, 2, 10)
    problems = [random_blocks(spec, seed=200 + i) for i in range(8)]
    batched = KKTBlocks(*(np.stack([np.asarray(p[f]) for p in problems])
                          for f in range(7)))
    mesh = Mesh(np.array(jax.devices()[:8]), ("dp",))
    sharding = jax.sharding.NamedSharding(mesh, P("dp"))
    batched = KKTBlocks(*(jax.device_put(jnp.asarray(a), sharding)
                          for a in batched))
    res = solve_batched(spec, batched,
                        SolverOptions(exit_tol=1e-10, max_iters=300, rho=0.01),
                        pcg_backend="jax")
    for i, p in enumerate(problems):
        single = solve(spec, p,
                       SolverOptions(exit_tol=1e-10, max_iters=300, rho=0.01),
                       pcg_backend="jax")
        np.testing.assert_allclose(np.asarray(res.lam[i]),
                                   np.asarray(single.lam),
                                   rtol=1e-3, atol=1e-4)


def test_solve_batched_dp_pcg():
    """Data-parallel batch: problems sharded over the mesh, the single-device
    batched solve per device, zero cross-device comm.  Exact iteration
    parity with the single-device jax path per problem."""
    from jax.sharding import Mesh

    from gato_tpu.parallel.sharded import solve_batched_dp

    spec = ProblemSpec(4, 2, 10)
    n_dev = 4
    B = 8
    problems = [random_blocks(spec, seed=200 + i) for i in range(B)]
    batch = KKTBlocks(*(jnp.asarray(np.stack([np.asarray(p[f])
                                              for p in problems]))
                        for f in range(7)))
    mesh = Mesh(np.array(jax.devices()[:n_dev]), ("dp",))
    res, dz_x, dz_u = solve_batched_dp(
        mesh, *batch, rho=1e-2, exit_tol=1e-10, max_iters=300)
    for i in range(B):
        ref = solve(spec, problems[i],
                    SolverOptions(rho=1e-2, exit_tol=1e-10, max_iters=300),
                    pcg_backend="jax")
        assert int(np.asarray(res.iters)[i]) == int(ref.iters), i
        np.testing.assert_allclose(np.asarray(res.lam)[i],
                                   np.asarray(ref.lam), rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(np.asarray(dz_u)[i],
                                   np.asarray(ref.dz_u), rtol=1e-4, atol=1e-4)


def test_solve_batched_dp_rejects_ragged():
    from jax.sharding import Mesh

    from gato_tpu.parallel.sharded import solve_batched_dp

    spec = ProblemSpec(3, 2, 8)
    batch = KKTBlocks(*(jnp.asarray(np.stack([np.asarray(a)] * 3))
                        for a in random_blocks(spec, seed=0)))
    mesh = Mesh(np.array(jax.devices()[:2]), ("dp",))
    with pytest.raises(ValueError, match="divisible"):
        solve_batched_dp(mesh, *batch, rho=1e-2)


def test_solve_batched_dp_direct():
    """Data-parallel EXACT solves: method='direct' per shard — results match
    the single-device direct oracle, iters are 0 by definition."""
    from jax.sharding import Mesh

    from gato_tpu.parallel.sharded import solve_batched_dp

    spec = ProblemSpec(4, 2, 10)
    n_dev = 4
    B = 8
    problems = [random_blocks(spec, seed=400 + i) for i in range(B)]
    batch = KKTBlocks(*(jnp.asarray(np.stack([np.asarray(p[f])
                                              for p in problems]))
                        for f in range(7)))
    mesh = Mesh(np.array(jax.devices()[:n_dev]), ("dp",))
    res, dz_x, dz_u = solve_batched_dp(mesh, *batch, rho=1e-2,
                                       method="direct")
    for i in range(B):
        ref = solve(spec, problems[i],
                    SolverOptions(rho=1e-2, method="direct"),
                    pcg_backend="jax")
        assert int(np.asarray(res.iters)[i]) == 0
        np.testing.assert_allclose(np.asarray(res.lam)[i],
                                   np.asarray(ref.lam), rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(np.asarray(dz_x)[i],
                                   np.asarray(ref.dz_x), rtol=1e-4, atol=1e-4)

    import pytest

    with pytest.raises(ValueError, match="method"):
        solve_batched_dp(mesh, *batch, rho=1e-2, method="thomas")


@pytest.mark.parametrize("method", ["pcg", "direct"])
def test_solve_batched_dp_h100_backends(method, as_h100):
    """The H100's per-shard choices — the Triton kernel (interpreted) inside
    shard_map for PCG, cyclic reduction for exact solves — agree with the
    single-device XLA path problem by problem."""
    from gato_tpu.parallel.sharded import solve_batched_dp

    spec = ProblemSpec(3, 2, 12)
    B = 4
    problems = [random_blocks(spec, seed=500 + i) for i in range(B)]
    batch = KKTBlocks(*(jnp.asarray(np.stack([np.asarray(p[f])
                                              for p in problems]))
                        for f in range(7)))
    mesh = Mesh(np.array(jax.devices()[:2]), ("dp",))
    res, dz_x, _ = solve_batched_dp(mesh, *batch, rho=1e-2, exit_tol=1e-10,
                                    max_iters=300, method=method)
    as_h100()
    opts = SolverOptions(rho=1e-2, exit_tol=1e-10, max_iters=300,
                         method=method)
    for i in range(B):
        ref = solve(spec, problems[i], opts, pcg_backend="jax")
        assert int(np.asarray(res.iters)[i]) == int(ref.iters), i
        assert bool(np.asarray(res.converged)[i])
        np.testing.assert_allclose(np.asarray(res.lam)[i],
                                   np.asarray(ref.lam), rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(np.asarray(dz_x)[i],
                                   np.asarray(ref.dz_x), rtol=1e-4, atol=1e-4)


# slow tier: the dp farm also runs in __graft_entry__.dryrun_multichip
# (placement 5).
@pytest.mark.slow
def test_solve_sequence_batched_dp():
    """MPC farm sharded over the mesh: each device scans its local streams;
    matches the single-device farm exactly."""
    from jax.sharding import Mesh

    from gato_tpu.mpc import solve_sequence_batched
    from gato_tpu.parallel.sharded import solve_sequence_batched_dp

    spec = ProblemSpec(4, 2, 10)
    T, B, n_dev = 3, 8, 4
    streams = []
    for b in range(B):
        steps = [random_blocks(spec, seed=800 + 10 * b + t) for t in range(T)]
        streams.append(KKTBlocks(*(np.stack([np.asarray(s[f]) for s in steps])
                                   for f in range(7))))
    batched = KKTBlocks(*(jnp.asarray(
        np.stack([np.asarray(streams[b][f]) for b in range(B)], axis=1))
        for f in range(7)))
    mesh = Mesh(np.array(jax.devices()[:n_dev]), ("dp",))
    lam, dz_x, dz_u, iters, conv, eta = solve_sequence_batched_dp(
        mesh, *batched, rho=1e-2, exit_tol=1e-8, max_iters=300)
    ref = solve_sequence_batched(spec, batched,
                                 SolverOptions(rho=1e-2, exit_tol=1e-8,
                                               max_iters=300))
    assert np.asarray(iters).tolist() == np.asarray(ref.iters).tolist()
    np.testing.assert_allclose(np.asarray(lam), np.asarray(ref.lam),
                               rtol=1e-5, atol=1e-6)

    import pytest

    with pytest.raises(ValueError, match="divisible"):
        solve_sequence_batched_dp(
            Mesh(np.array(jax.devices()[:3]), ("dp",)), *batched, rho=1e-2)

    # The EXACT farm over the mesh: stream-major fold into one dp batch —
    # matches the single-mesh exact farm (which itself matches per-step
    # solve_batched, test_mpc), per-step rhos included.
    rhos = np.array([1e-2, 5e-2, 1e-3], dtype=np.float32)
    lam_d, dzx_d, dzu_d, it_d, conv_d, eta_d = solve_sequence_batched_dp(
        mesh, *batched, rhos=rhos, method="direct")
    ref_d = solve_sequence_batched(spec, batched,
                                   SolverOptions(method="direct"), rhos=rhos)
    assert lam_d.shape == ref_d.lam.shape
    assert np.all(np.asarray(conv_d))
    # Round-off tolerance: the per-shard fold batches fewer problems than
    # the single-device fold, and XLA may order the batched sums
    # differently.
    np.testing.assert_allclose(np.asarray(lam_d), np.asarray(ref_d.lam),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(np.asarray(dzu_d), np.asarray(ref_d.dz_u),
                               rtol=1e-4, atol=1e-4)

    with pytest.raises(ValueError, match="supports method"):
        solve_sequence_batched_dp(mesh, *batched, method="nope")


def test_solve_sharded_second_call_hits_jit_cache():
    """The core is a single module-level jit (mesh/axis/precond static):
    a serving loop that varies data and rho must not retrace."""
    from gato_tpu.parallel.sharded import _solve_sharded_core

    spec = ProblemSpec(4, 2, 32)
    mesh = _mesh(4)
    _solve_sharded_core._clear_cache()
    for seed, rho in ((1, 0.01), (2, 0.02)):
        blocks = random_blocks(spec, seed=seed)
        res, dz_x, dz_u = solve_sharded(mesh, *blocks, rho=rho,
                                        exit_tol=1e-8, max_iters=200)
        assert bool(res.converged)
    assert _solve_sharded_core._cache_size() == 1


def _dp_stack(spec, B, seed0):
    ps = [random_blocks(spec, seed=seed0 + i) for i in range(B)]
    return KKTBlocks(*(jnp.asarray(np.stack([np.asarray(p[f]) for p in ps]))
                       for f in range(7)))


@pytest.mark.parametrize("method", ["pcg", "direct"])
def test_solve_packed_dp_matches_single_device(method):
    """One PackedKKT served over the mesh: the batch shards, each device
    solves its shard — results match the single-device packed solve."""
    import dataclasses

    from gato_tpu import packed as pk
    from gato_tpu.parallel.sharded import solve_packed_dp

    spec = ProblemSpec(3, 2, 12)
    opts = dataclasses.replace(
        SolverOptions(rho=1e-2, exit_tol=1e-10, max_iters=300),
        method=method)
    packed = pk.pack(spec, _dp_stack(spec, 16, 60))
    single = pk.solve_packed(packed, opts)
    dp = solve_packed_dp(_mesh(2, "dp"), packed, opts)
    assert dp.plan == packed.plan
    np.testing.assert_array_equal(np.asarray(dp.iters),
                                  np.asarray(single.iters))
    np.testing.assert_array_equal(np.asarray(dp.converged),
                                  np.asarray(single.converged))
    for f in ("lam_p", "dzx_p", "dzu_p"):
        np.testing.assert_allclose(np.asarray(getattr(dp, f)),
                                   np.asarray(getattr(single, f)),
                                   rtol=1e-4, atol=1e-4, err_msg=f)
    # The lam carry comes back sharded over the mesh, not on one device.
    assert len(dp.lam_p.sharding.device_set) == 2
    if method == "pcg":
        again = solve_packed_dp(_mesh(2, "dp"), packed, opts,
                                lam0=dp.lam_packed)
        assert int(np.max(np.asarray(again.iters))) <= 1


def test_solve_packed_dp_validation():
    import dataclasses

    from gato_tpu import packed as pk
    from gato_tpu.parallel.sharded import solve_packed_dp

    spec = ProblemSpec(3, 2, 12)
    opts = SolverOptions(rho=1e-2, exit_tol=1e-10, max_iters=300)
    packed = pk.pack(spec, _dp_stack(spec, 6, 100))
    with pytest.raises(ValueError, match="not divisible by mesh axis"):
        solve_packed_dp(_mesh(4, "dp"), packed, opts)
    with pytest.raises(ValueError, match="float32"):
        solve_packed_dp(_mesh(2, "dp"), packed,
                        dataclasses.replace(opts, dtype="float64"))


def test_solve_packed_dp_second_call_hits_jit_cache():
    """A fleet-serving loop must not retrace: the second call with fresh
    data and the carry reuses the compiled executable."""
    from gato_tpu import packed as pk
    from gato_tpu.parallel import sharded as sh

    spec = ProblemSpec(3, 2, 12)
    bb = _dp_stack(spec, 16, 120)
    opts = SolverOptions(rho=1e-2, exit_tol=1e-10, max_iters=300)
    packed = pk.pack(spec, bb)
    mesh = _mesh(2, "dp")
    first = sh.solve_packed_dp(mesh, packed, opts)
    size = sh._solve_batched_dp_core._cache_size()
    refreshed = pk.update_vectors(packed, np.asarray(bb.q) * 1.01,
                                  bb.r, bb.c)
    sh.solve_packed_dp(mesh, refreshed, opts, lam0=first.lam_packed)
    assert sh._solve_batched_dp_core._cache_size() == size


# ---- Sharded EXACT solve (substructuring) ---------------------------------


@pytest.mark.parametrize(
    "n_dev",
    [pytest.param(2, marks=pytest.mark.slow),
     pytest.param(4, marks=pytest.mark.slow),
     pytest.param(8, marks=pytest.mark.slow)])
def test_btd_solve_sharded_matches_thomas(n_dev):
    """The SPIKE interface solve is exact: agrees with single-device block
    Thomas to f32 round-off on a random SPD Schur system."""
    from gato_tpu.direct import btd_solve
    from gato_tpu.parallel.sharded import btd_solve_sharded

    spec = ProblemSpec(4, 2, 32)
    blocks = random_blocks(spec, seed=91)
    sys = condense(*(jnp.asarray(a) for a in blocks), rho=jnp.float32(0.01))

    x_single = btd_solve(sys.S, sys.gamma)
    x_sharded = btd_solve_sharded(_mesh(n_dev), sys.S, sys.gamma)
    np.testing.assert_allclose(
        np.asarray(x_sharded), np.asarray(x_single), rtol=2e-4, atol=2e-5
    )


def test_btd_solve_sharded_rejects_thin_shards():
    from gato_tpu.parallel.sharded import btd_solve_sharded

    spec = ProblemSpec(3, 1, 8)
    blocks = random_blocks(spec, seed=5)
    sys = condense(*(jnp.asarray(a) for a in blocks), rho=jnp.float32(0.01))
    with pytest.raises(ValueError, match="2 rows per shard"):
        btd_solve_sharded(_mesh(8), sys.S, sys.gamma)


@pytest.mark.parametrize("n_dev", [2, 8])
def test_solve_sharded_direct_matches_single(n_dev):
    """Full exact knot-sharded solve: lam/dz agree with the single-device
    method='direct' path; converged derives from the true residual."""
    spec = ProblemSpec(4, 2, 32)
    blocks = random_blocks(spec, seed=23)
    rho = 0.01
    res, dz_x, dz_u = solve_sharded(
        _mesh(n_dev), *(jnp.asarray(a) for a in blocks),
        rho=rho, method="direct",
    )
    single = solve(spec, blocks, SolverOptions(rho=rho, method="direct"),
                   pcg_backend="jax")
    assert bool(res.converged)
    assert int(res.iters) == 0
    np.testing.assert_allclose(
        np.asarray(res.lam), np.asarray(single.lam), rtol=2e-4, atol=2e-5
    )
    np.testing.assert_allclose(
        np.asarray(dz_x), np.asarray(single.dz_x), rtol=2e-4, atol=2e-5
    )
    np.testing.assert_allclose(
        np.asarray(dz_u), np.asarray(single.dz_u), rtol=2e-4, atol=2e-5
    )


def test_solve_sharded_direct_thin_shards_fall_back():
    """K == mesh size: no interior rows — the core solves the (tiny) whole
    system in place instead of substructuring."""
    spec = ProblemSpec(3, 2, 8)
    blocks = random_blocks(spec, seed=31)
    res, dz_x, dz_u = solve_sharded(
        _mesh(8), *(jnp.asarray(a) for a in blocks),
        rho=0.01, method="direct",
    )
    single = solve(spec, blocks, SolverOptions(rho=0.01, method="direct"),
                   pcg_backend="jax")
    assert bool(res.converged)
    np.testing.assert_allclose(
        np.asarray(res.lam), np.asarray(single.lam), rtol=2e-4, atol=2e-5
    )


def test_solve_sharded_rejects_unknown_method():
    spec = ProblemSpec(4, 2, 16)
    blocks = random_blocks(spec, seed=3)
    with pytest.raises(ValueError, match="method"):
        solve_sharded(_mesh(2), *(jnp.asarray(a) for a in blocks),
                      rho=0.01, method="thomas")

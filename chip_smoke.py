"""Smoke test of the solver's main path on a CUDA GPU, in one process.

    python chip_smoke.py           # one card: every public entry point
    python chip_smoke.py --four    # four cards: the mesh phases only

One card, at the widths users run (IIWA: state 14, control 7):

* the card-only tests (``pytest -m gpu``, in a child that finishes before
  this process touches the card);
* ``linsys_solve`` from CSR lists — pendulum (2, 1, 5) and IIWA K=50 — the
  reference's own entry point, through the host packer (native or NumPy,
  printed);
* ``solve``, PCG and exact, at K = 50, 1024 and 4096;
* ``solve_batched``, PCG and exact, at B = 1024;
* the Triton PCG kernel as compiled for the card against XLA's while loop;
* ``solve_sequence`` (T=16) and ``solve_sequence_batched`` (T=16, B=256);
* ``diff.kkt_solve_batched``, forward and adjoint under ``jax.grad``, B=64;
* the packed surface: ``pack``, ``solve_packed``, ``update_vectors``,
  ``pack_sequence``, ``solve_packed_sequence``.

Four cards (a flat 4-device mesh — NVLink joins every pair at one rate):
``solve_sharded`` (PCG and exact, K=4096 over the knots), ``solve_batched_dp``
(B=1024) and ``solve_packed_dp``, each against the same solve on one card, and
each checked to hold one shard on every card.

Every phase prints its shapes, iteration counts, largest error beside its
tolerance and the compiled step's ``memory_analysis()``; any miss raises, and
the script then exits nonzero without the final line.  The last line is
``{"ok": true, "device": {...}}``.  With no GPU it exits nonzero at once.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np

# ---- Tolerances, each the one the CPU tests use for the same comparison.
# Against the float64 oracle, relative to max(1, |reference|): PCG runs to
# exit_tol=1e-12, so this is float32 condensation and recovery error
# (tests/test_solver.py _check, tests/test_direct.py).  Every product on the
# XLA path asks for Precision.HIGHEST and the kernel does float32 FMAs, so
# no TF32 enters; only the order of sums differs from the CPU.
TOL_ORACLE = 2e-3
# Kernel against XLA's loop, both at exit_tol=1e-6: solutions agree to the
# exit tolerance (tests/test_pcg_triton.py).
TOL_KERNEL = 1e-4
# Sequences against the oracle (tests/test_mpc.py: rtol = atol = 2e-3).
TOL_SEQUENCE = 2e-3
# Gradients against the oracle adjoint (tests/test_diff.py: 2e-3 * scale).
TOL_GRAD = 2e-3
# Packed surface against solve_batched: one compiled core, but XLA's GPU
# reductions may order sums differently run to run (tests/test_packed.py
# demands bitwise equality on the CPU).
TOL_PACKED = 1e-5
# Four cards against one: the same algorithm with sums ordered per shard,
# or for exact solves substructuring against cyclic reduction
# (tests/test_sharded.py: rtol 2e-4 against the single-device solve).
TOL_MESH = 2e-4
EXIT_TOL = 1e-12        # oracle comparisons
SERVE_TOL = 1e-6        # kernel and packed comparisons (the API default)
RHO = 1e-3
IIWA = (14, 7)


@dataclasses.dataclass(frozen=True)
class Sizes:
    """Shapes of every phase; FULL is what the card runs, the CPU tests run
    a tiny copy."""

    K: int = 50
    Ks: tuple = (50, 1024, 4096)
    B: int = 1024
    T: int = 16
    B_seq: int = 256
    B_grad: int = 64
    n_check: int = 8          # batch members compared with the oracle
    K_mesh: int = 4096
    B_mesh: int = 1024


FULL = Sizes()


class PhaseFailure(AssertionError):
    pass


def say(phase: str, **fields) -> None:
    print(f"[{phase}] " + json.dumps(fields, default=str), flush=True)


def rel_err(got, ref) -> float:
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    scale = max(1.0, float(np.max(np.abs(ref))))
    err = float(np.max(np.abs(got - ref))) / scale
    return err if np.isfinite(err) and np.all(np.isfinite(got)) else np.inf


# Per phase, the check whose error came closest to its tolerance.
WORST: dict = {}


def check(phase: str, what: str, err: float, tol: float) -> None:
    ok = err <= tol
    say(phase, check=what, err=err, tol=tol, ok=ok)
    if phase not in WORST or err / tol > WORST[phase]["err"] / WORST[phase][
            "tol"]:
        WORST[phase] = {"check": what, "err": err, "tol": tol}
    if not ok:
        raise PhaseFailure(f"{phase}: {what} error {err:.3e} > {tol:.1e}")


def require(phase: str, what: str, cond: bool) -> None:
    say(phase, check=what, ok=bool(cond))
    if not cond:
        raise PhaseFailure(f"{phase}: {what}")


def memory(fn, *args) -> dict:
    """memory_analysis() of ``fn`` compiled for these arguments."""
    import jax

    m = jax.jit(fn).lower(*args).compile().memory_analysis()
    if m is None:
        return {}
    return {k: getattr(m, k) for k in (
        "argument_size_in_bytes", "output_size_in_bytes",
        "temp_size_in_bytes", "generated_code_size_in_bytes")
        if hasattr(m, k)}


def oracle(spec, blocks, rho):
    """(lam, dz) in float64: dense below a few thousand unknowns, the same
    system solved sparse beyond (the dense matrix of K=1024 is ~10 GB)."""
    from gato_tpu.testing import dense_oracle, sparse_oracle

    fn = dense_oracle if spec.nz + spec.nl <= 4000 else sparse_oracle
    return fn(spec, blocks, rho=rho)


def problems(K: int, B: int, seed: int = 0):
    """B IIWA-width problems (leading batch axis), made from a seed: one
    random problem per seed mixed so members differ in data and counts."""
    from gato_tpu.formats import KKTBlocks
    from gato_tpu.problem import ProblemSpec
    from gato_tpu.testing import random_blocks

    spec = ProblemSpec(IIWA[0], IIWA[1], K)
    base = [random_blocks(spec, seed=seed + i) for i in range(min(B, 4))]
    rng = np.random.default_rng(seed)
    arrs = []
    for f in range(7):
        a = np.stack([np.asarray(base[i % len(base)][f]) for i in range(B)])
        if f >= 4:  # vary the right-hand sides per member
            a = a * (1.0 + 0.1 * rng.normal(size=a.shape))
        arrs.append(a.astype(np.float32))
    return spec, KKTBlocks(*arrs)


def member(blocks, i):
    return type(blocks)(*(np.asarray(a)[i] for a in blocks))


def sample(n: int, B: int):
    return sorted(set(np.linspace(0, B - 1, min(n, B)).astype(int).tolist()))


# ---- One-card phases ------------------------------------------------------


def phase_linsys(sz: Sizes) -> None:
    import jax

    import gato_tpu
    from gato_tpu import SolverOptions, native, solve
    from gato_tpu.testing import blocks_to_csr, pendulum_problem

    name = "linsys_solve"
    native.build()  # make -C csrc; the NumPy packer runs if it cannot
    say(name, packer="native" if native.available() else "numpy")
    spec_i, bi = problems(sz.K, 1, seed=11)
    cases = [("pendulum", pendulum_problem())]
    cases.append(("iiwa", blocks_to_csr(spec_i, member(bi, 0))))
    for label, p in cases:
        # verbose: linsys_solve prints its own iteration count and time.
        lam, dz = gato_tpu.linsys_solve(
            p.G_row, p.G_col, p.G_val, p.C_row, p.C_col, p.C_val,
            p.g, p.c, [0.0] * p.spec.nl, 1, EXIT_TOL, 500, False, RHO)
        blocks = gato_tpu.pack_kkt(p.spec, p.G_row, p.G_col, p.G_val,
                                   p.C_row, p.C_col, p.C_val, p.g, p.c)
        lam_ref, dz_ref = oracle(p.spec, blocks, RHO)
        opts = SolverOptions(rho=RHO, exit_tol=EXIT_TOL, max_iters=500)
        say(name, case=label, spec=dataclasses.astuple(p.spec),
            memory=memory(lambda b: solve(p.spec, b, opts),
                          jax.device_put(blocks)))
        check(name, f"{label} lam vs oracle", rel_err(lam, lam_ref),
              TOL_ORACLE)
        check(name, f"{label} dz vs oracle", rel_err(dz, dz_ref), TOL_ORACLE)


def phase_solve(sz: Sizes) -> None:
    import jax

    from gato_tpu import SolverOptions, solve
    from gato_tpu.dispatch import choose_backend

    name = "solve"
    for K in sz.Ks:
        spec, bb = problems(K, 1, seed=K)
        blocks = member(bb, 0)
        lam_ref, dz_ref = oracle(spec, blocks, RHO)
        for method in ("pcg", "direct"):
            opts = SolverOptions(rho=RHO, exit_tol=EXIT_TOL, max_iters=2000,
                                 method=method)
            t0 = time.perf_counter()
            res = jax.block_until_ready(solve(spec, blocks, opts))
            say(name, K=K, method=method,
                backend=choose_backend(method, None, dtype="float32", K=K),
                lam_shape=res.lam.shape, iters=int(res.iters),
                converged=bool(res.converged),
                first_call_s=time.perf_counter() - t0,
                memory=memory(lambda b: solve(spec, b, opts),
                              jax.device_put(blocks)))
            require(name, f"K={K} {method} converged", bool(res.converged))
            check(name, f"K={K} {method} lam vs oracle",
                  rel_err(res.lam_flat(), lam_ref), TOL_ORACLE)
            check(name, f"K={K} {method} dz vs oracle",
                  rel_err(res.dz_flat(), dz_ref), TOL_ORACLE)


def phase_solve_batched(sz: Sizes) -> None:
    import jax

    from gato_tpu import SolverOptions, solve_batched
    from gato_tpu.formats import interleave_dz

    name = "solve_batched"
    spec, bb = problems(sz.K, sz.B, seed=21)
    bd = jax.device_put(bb)
    for method in ("pcg", "direct"):
        opts = SolverOptions(rho=RHO, exit_tol=EXIT_TOL, max_iters=2000,
                             method=method)
        res = jax.block_until_ready(solve_batched(spec, bd, opts))
        iters = np.asarray(res.iters)
        say(name, B=sz.B, K=sz.K, method=method, lam_shape=res.lam.shape,
            iters_min=int(iters.min()), iters_max=int(iters.max()),
            memory=memory(lambda b: solve_batched(spec, b, opts), bd))
        require(name, f"{method} all converged",
                bool(np.all(np.asarray(res.converged))))
        for i in sample(sz.n_check, sz.B):
            lam_ref, dz_ref = oracle(spec, member(bb, i), RHO)
            dz = interleave_dz(spec, np.asarray(res.dz_x[i]),
                               np.asarray(res.dz_u[i]))
            check(name, f"{method} member {i} lam vs oracle",
                  rel_err(np.asarray(res.lam[i]).reshape(-1), lam_ref),
                  TOL_ORACLE)
            check(name, f"{method} member {i} dz vs oracle",
                  rel_err(dz, dz_ref), TOL_ORACLE)


def phase_kernel(sz: Sizes, interpret: bool = False) -> None:
    """The Triton kernel as compiled for the card (interpret only in the CPU
    tests) against pcg.pcg on the same condensed systems."""
    import jax
    import jax.numpy as jnp

    from gato_tpu import assemble, pcg as pcg_mod
    from gato_tpu.kernels.pcg_triton import pcg_triton
    from gato_tpu.problem import Preconditioner

    name = "pcg_triton"
    stair, block = Preconditioner.SYMMETRIC_STAIR, Preconditioner.BLOCK_JACOBI
    cases = ((sz.K, 1, stair, 1), (sz.K, sz.B, stair, 1),
             (sz.Ks[1], 1, stair, 1), (sz.K, 1, stair, 2),
             (sz.K, sz.B, stair, 2), (sz.K, sz.B, block, 1),
             (sz.K, sz.B, block, 2))
    for K, B, precond, degree in cases:
        spec, bb = problems(K, B, seed=31)
        sys_ = jax.jit(jax.vmap(lambda *x: assemble.condense(
            *x, RHO, precond)))(*bb)
        lam0 = jnp.zeros_like(sys_.gamma)
        ref = jax.jit(jax.vmap(lambda S, P, g, l: pcg_mod.pcg(
            S, P, g, l, exit_tol=SERVE_TOL, max_iters=2000,
            poly_degree=degree)))(sys_.S, sys_.Pinv, sys_.gamma, lam0)

        def kern(S, P, g, l):
            return pcg_triton(S, P, g, l, SERVE_TOL, 2000,
                              poly_degree=degree, interpret=interpret)

        got = jax.block_until_ready(kern(sys_.S, sys_.Pinv, sys_.gamma, lam0))
        gi, ri = np.asarray(got.iters), np.asarray(ref.iters)
        case = f"K={K} B={B} {precond.value} degree {degree}"
        say(name, K=K, B=B, precond=precond.value, poly_degree=degree,
            S_shape=sys_.S.shape, iters_min=int(gi.min()),
            iters_max=int(gi.max()), xla_iters_max=int(ri.max()),
            memory=memory(kern, sys_.S, sys_.Pinv, sys_.gamma, lam0))
        flips = np.flatnonzero(gi != ri)
        early = np.where(gi < ri, np.asarray(got.eta), np.asarray(ref.eta))
        require(name, f"{case} iteration counts equal (+-1 at an exit_tol "
                      f"tie)",
                bool(np.all(np.abs(gi - ri) <= 1)
                     and np.all(early[flips] >= 0.9 * SERVE_TOL)))
        require(name, f"{case} converged",
                bool(np.all(np.asarray(got.converged))))
        check(name, f"{case} lam vs pcg.pcg", rel_err(got.lam, ref.lam),
              TOL_KERNEL)


def phase_sequence(sz: Sizes) -> None:
    import jax

    from gato_tpu import SolverOptions, solve_sequence, solve_sequence_batched
    from gato_tpu.formats import KKTBlocks

    name = "sequence"
    opts = SolverOptions(rho=RHO, exit_tol=EXIT_TOL, max_iters=2000)
    # A slowly varying linearization: one problem per stream, rhs drifting.
    for T, B in ((sz.T, 1), (sz.T, sz.B_seq)):
        spec, bb = problems(sz.K, B, seed=41)
        drift = 1.0 + 0.01 * np.arange(T, dtype=np.float32)
        seq = KKTBlocks(*(np.broadcast_to(a, (T,) + a.shape)
                          for a in bb))._replace(
            q=(drift[:, None, None, None] * bb.q[None]).astype(np.float32))
        if B == 1:
            seq1 = KKTBlocks(*(a[:, 0] for a in seq))
            res = jax.block_until_ready(solve_sequence(spec, seq1, opts))
            lam, iters = np.asarray(res.lam)[:, None], np.asarray(res.iters)
            iters = iters[:, None]
            fn, arg = (lambda b: solve_sequence(spec, b, opts)), seq1
        else:
            res = jax.block_until_ready(
                solve_sequence_batched(spec, seq, opts))
            lam, iters = np.asarray(res.lam), np.asarray(res.iters)
            fn, arg = (lambda b: solve_sequence_batched(spec, b, opts)), seq
        say(name, T=T, B=B, lam_shape=lam.shape,
            iters_first=int(iters[0].max()), iters_rest_max=int(
                iters[1:].max()),
            memory=memory(fn, jax.device_put(arg)))
        require(name, f"T={T} B={B} all converged",
                bool(np.all(np.asarray(res.converged))))
        require(name, f"T={T} B={B} warm start cuts iterations",
                float(iters[1:].mean()) < float(iters[0].mean()))
        for t in (0, T - 1):
            for i in sample(2, B):
                step = type(bb)(*(np.asarray(a)[t, i] for a in seq))
                lam_ref, _ = oracle(spec, step, RHO)
                check(name, f"T={T} B={B} step {t} member {i} lam vs oracle",
                      rel_err(lam[t, i].reshape(-1), lam_ref), TOL_SEQUENCE)


def phase_grad(sz: Sizes) -> None:
    """Gradient of a linear loss through kkt_solve_batched: by the implicit
    function theorem dL/dq is the z-part of the adjoint solution y of
    M y = dL/d(dz, lam) — the same saddle system, so the oracle solves it
    with the cotangents as right-hand side."""
    import jax
    import jax.numpy as jnp

    from gato_tpu.diff import kkt_solve_batched

    name = "kkt_solve_batched"
    spec, bb = problems(sz.K, sz.B_grad, seed=51)
    rng = np.random.default_rng(5)
    w_lam = rng.normal(size=bb.q.shape).astype(np.float32)
    w_x = rng.normal(size=bb.q.shape).astype(np.float32)
    w_u = rng.normal(size=bb.r.shape).astype(np.float32)

    def loss(q, *rest):
        Q, R, A, B_, r, c = rest
        lam, dz_x, dz_u = kkt_solve_batched(Q, R, A, B_, q, r, c,
                                            jnp.float32(RHO))
        return (jnp.sum(lam * w_lam) + jnp.sum(dz_x * w_x)
                + jnp.sum(dz_u * w_u))

    args = jax.device_put((bb.q, bb.Q, bb.R, bb.A, bb.B, bb.r, bb.c))
    grad = jax.jit(jax.grad(loss))
    g = np.asarray(jax.block_until_ready(grad(*args)))
    fwd = kkt_solve_batched(*args[1:5], args[0], *args[5:],
                            jnp.float32(RHO))
    say(name, B=sz.B_grad, K=sz.K, grad_shape=g.shape,
        memory=memory(jax.grad(loss), *args))
    for i in sample(sz.n_check, sz.B_grad):
        p = member(bb, i)
        lam_ref, dz_ref = oracle(spec, p, RHO)
        sc = spec.state_size + spec.control_size
        dzx_ref = np.concatenate([dz_ref[: (spec.knot_points - 1) * sc]
                                  .reshape(-1, sc)[:, :spec.state_size]
                                  .reshape(-1), dz_ref[-spec.state_size:]])
        check(name, f"member {i} forward lam vs oracle",
              rel_err(np.asarray(fwd[0][i]).reshape(-1), lam_ref), TOL_GRAD)
        check(name, f"member {i} forward dz_x vs oracle",
              rel_err(np.asarray(fwd[1][i]).reshape(-1), dzx_ref), TOL_GRAD)
        adj = p._replace(q=w_x[i], r=w_u[i], c=w_lam[i])
        _, y_z = oracle(spec, adj, RHO)
        y_x = np.concatenate([y_z[: (spec.knot_points - 1) * sc]
                              .reshape(-1, sc)[:, :spec.state_size]
                              .reshape(-1), y_z[-spec.state_size:]])
        check(name, f"member {i} dL/dq vs oracle adjoint",
              rel_err(g[i].reshape(-1), y_x), TOL_GRAD)


def phase_packed(sz: Sizes) -> None:
    import jax

    from gato_tpu import (SolverOptions, pack, pack_sequence, solve_batched,
                          solve_packed, solve_packed_sequence,
                          solve_sequence_batched, update_vectors)
    from gato_tpu.formats import KKTBlocks

    name = "packed"
    opts = SolverOptions(rho=RHO, exit_tol=SERVE_TOL, max_iters=2000)
    spec, bb = problems(sz.K, sz.B, seed=61)
    packed = pack(spec, bb)
    res = jax.block_until_ready(solve_packed(packed, opts))
    ref = solve_batched(spec, bb, opts)
    say(name, B=sz.B, K=sz.K, lam_shape=res.lam_p.shape,
        iters_max=int(np.asarray(res.iters).max()),
        memory=memory(lambda p: solve_packed(p, opts), packed))
    require(name, "solve_packed iterations == solve_batched",
            bool(np.all(np.abs(np.asarray(res.iters)
                               - np.asarray(ref.iters)) <= 1)))
    check(name, "solve_packed lam vs solve_batched",
          rel_err(res.unpack().lam, ref.lam), TOL_PACKED)
    again = solve_packed(packed, opts, lam0=res.lam_packed)
    require(name, "warm-start carry re-solves in <= 1 iteration",
            int(np.asarray(again.iters).max()) <= 1)
    _, bb2 = problems(sz.K, sz.B, seed=62)
    fresh = update_vectors(packed, bb2.q, bb2.r, bb2.c)
    mixed = bb._replace(q=bb2.q, r=bb2.r, c=bb2.c)
    r2 = solve_packed(fresh, opts)
    check(name, "update_vectors lam vs solve_batched",
          rel_err(r2.unpack().lam, solve_batched(spec, mixed, opts).lam),
          TOL_PACKED)
    i = sample(1, sz.B)[0]
    lam_ref, _ = oracle(spec, member(mixed, i), RHO)
    check(name, f"update_vectors member {i} lam vs oracle",
          rel_err(np.asarray(r2.lam_p[i]).reshape(-1), lam_ref), TOL_ORACLE)

    B = sz.B_seq
    _, sb = problems(sz.K, B, seed=63)
    seq = KKTBlocks(*(np.broadcast_to(a, (sz.T,) + a.shape) for a in sb))
    ps = pack_sequence(spec, seq)
    rs = jax.block_until_ready(solve_packed_sequence(ps, opts))
    ref_s = solve_sequence_batched(spec, seq, opts)
    say(name, T=sz.T, B=B, lam_shape=rs.lam_p.shape,
        memory=memory(lambda p: solve_packed_sequence(p, opts), ps))
    check(name, "solve_packed_sequence lam vs solve_sequence_batched",
          rel_err(rs.unpack().lam, ref_s.lam), TOL_PACKED)
    nxt = solve_packed_sequence(ps, opts, lam0=rs.lam_tail_packed)
    require(name, "window carry restarts warm",
            int(np.asarray(nxt.iters)[0].max())
            <= int(np.asarray(rs.iters)[0].max()))


ONE_CARD = (phase_linsys, phase_solve, phase_solve_batched, phase_kernel,
            phase_sequence, phase_grad, phase_packed)


# ---- Four-card phases -----------------------------------------------------


def _spread(x, n: int) -> bool:
    """True when ``x`` has one shard on each of ``n`` distinct devices."""
    return len({s.device for s in x.addressable_shards}) == n


def phase_mesh(sz: Sizes, n: int = 4) -> None:
    import jax
    from jax.sharding import Mesh

    from gato_tpu import (SolverOptions, pack, solve, solve_batched,
                          solve_packed)
    from gato_tpu.parallel.sharded import (solve_batched_dp, solve_packed_dp,
                                           solve_sharded)

    name = f"mesh{n}"
    devs = jax.devices()[:n]
    require(name, f"{n} devices", len(devs) == n)
    knot = Mesh(np.array(devs), ("knot",))
    dp = Mesh(np.array(devs), ("dp",))

    spec, bb = problems(sz.K_mesh, 1, seed=71)
    blocks = member(bb, 0)
    for method in ("pcg", "direct"):
        opts = SolverOptions(rho=RHO, exit_tol=EXIT_TOL, max_iters=2000,
                             method=method)
        one = solve(spec, blocks, opts)
        res, dz_x, _ = solve_sharded(knot, *blocks, rho=RHO,
                                     exit_tol=EXIT_TOL, max_iters=2000,
                                     method=method)
        jax.block_until_ready(res.lam)
        say(name, entry="solve_sharded", method=method, K=sz.K_mesh,
            iters=int(res.iters), one_card_iters=int(one.iters),
            lam_sharding=str(res.lam.sharding))
        require(name, f"solve_sharded {method} lam on {n} devices",
                _spread(res.lam, n))
        require(name, f"solve_sharded {method} converged",
                bool(res.converged))
        check(name, f"solve_sharded {method} lam vs one card",
              rel_err(res.lam, one.lam), TOL_MESH)
        check(name, f"solve_sharded {method} dz_x vs one card",
              rel_err(dz_x, one.dz_x), TOL_MESH)

    spec, bb = problems(sz.K, sz.B_mesh, seed=72)
    for method in ("pcg", "direct"):
        opts = SolverOptions(rho=RHO, exit_tol=SERVE_TOL, max_iters=2000,
                             method=method)
        one = solve_batched(spec, bb, opts)
        res, _, _ = solve_batched_dp(dp, *bb, rho=RHO, exit_tol=SERVE_TOL,
                                     max_iters=2000, method=method)
        jax.block_until_ready(res.lam)
        say(name, entry="solve_batched_dp", method=method, B=sz.B_mesh,
            iters_max=int(np.asarray(res.iters).max()))
        require(name, f"solve_batched_dp {method} lam on {n} devices",
                _spread(res.lam, n))
        require(name, f"solve_batched_dp {method} iterations == one card "
                      f"(+-1 tie)",
                bool(np.all(np.abs(np.asarray(res.iters)
                                   - np.asarray(one.iters)) <= 1)))
        check(name, f"solve_batched_dp {method} lam vs one card",
              rel_err(res.lam, one.lam), TOL_MESH)

    opts = SolverOptions(rho=RHO, exit_tol=SERVE_TOL, max_iters=2000)
    packed = pack(spec, bb)
    one = solve_packed(packed, opts)
    res = solve_packed_dp(dp, packed, opts)
    jax.block_until_ready(res.lam_p)
    say(name, entry="solve_packed_dp", B=sz.B_mesh,
        iters_max=int(np.asarray(res.iters).max()))
    require(name, f"solve_packed_dp lam on {n} devices", _spread(res.lam_p, n))
    check(name, "solve_packed_dp lam vs one card",
          rel_err(res.lam_p, one.lam_p), TOL_MESH)
    again = solve_packed_dp(dp, packed, opts, lam0=res.lam_packed)
    require(name, "solve_packed_dp carry re-solves in <= 1 iteration",
            int(np.asarray(again.iters).max()) <= 1)


# ---- Driver ---------------------------------------------------------------


def card_lines() -> str:
    """``name, power.limit`` of every card, from nvidia-smi in a child that
    does not import JAX."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True)
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable: {e}"
    return out.stdout.strip()


def run_gpu_tests() -> int:
    """The repo's card-only tests in a child, before this process opens the
    card (a second JAX process could not reserve its memory)."""
    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, JAX_PLATFORMS="cuda")
    return subprocess.run(
        [sys.executable, "-m", "pytest", "-q", "-m", "gpu", "-p",
         "no:cacheprovider", os.path.join(here, "tests")],
        cwd=here, env=env, timeout=600).returncode


def require_gpu(device) -> None:
    if device.platform != "gpu":
        raise SystemExit(
            f"chip_smoke.py needs a CUDA GPU; the default device is "
            f"{device.platform!r}")


def run(sizes: Sizes, *, four: bool = False, check_platform=require_gpu,
        interpret: bool = False) -> dict:
    """Run the phases; return the device line's payload.  Raises on the
    first failed phase."""
    import jax

    from gato_tpu import compile_cache

    compile_cache.enable()
    d = jax.devices()[0]
    check_platform(d)
    device = {"platform": d.platform, "kind": d.device_kind,
              "count": len(jax.devices())}
    say("device", **device, jax=jax.__version__)
    phases = (phase_mesh,) if four else ONE_CARD
    for phase in phases:
        t0 = time.perf_counter()
        if phase is phase_kernel:
            phase(sizes, interpret=interpret)
        else:
            phase(sizes)
        say(phase.__name__, seconds=round(time.perf_counter() - t0, 3))
        jax.clear_caches()
    say("largest error against tolerance, per phase", **WORST)
    return device


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    four = "--four" in argv
    print(card_lines(), flush=True)
    if not four:
        rc = run_gpu_tests()
        say("pytest -m gpu", returncode=rc)
        if rc != 0:
            return 1
    device = run(FULL, four=four)
    if four and device["count"] != 4:
        raise PhaseFailure(f"--four needs 4 devices, found {device['count']}")
    print(json.dumps({"ok": True, "device": device}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Implicit differentiation: VJP correctness vs finite differences and vs
native AD through the (differentiable) direct-solver composition."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gato_tpu import ProblemSpec
from gato_tpu.diff import kkt_solve, kkt_solve_batched, _solve_kkt
from gato_tpu.testing import random_blocks

SPEC = ProblemSpec(3, 2, 6)


def _args(seed=11, rho=0.05):
    b = random_blocks(SPEC, seed=seed)
    return tuple(jnp.asarray(a) for a in b) + (jnp.float32(rho),)


def _loss(lam, dz_x, dz_u):
    return (jnp.sum(lam * jnp.cos(lam)) + jnp.sum(dz_x ** 2)
            + jnp.sum(jnp.sin(dz_u)))


def test_primal_matches_direct():
    args = _args()
    out1 = kkt_solve(*args)
    out2 = _solve_kkt(*args)
    for a, b in zip(out1, out2):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=1e-6)


# slow tier: the default-tier finite-difference sweep below already pins
# the implicit VJP's correctness per argument; this is the second
# (native-AD) oracle for the same gradients.
@pytest.mark.slow
def test_grads_match_native_ad():
    """Native AD differentiates through condense+scan; the implicit VJP must
    give the same gradients without touching solver internals."""
    args = _args()

    def f_implicit(*a):
        return _loss(*kkt_solve(*a))

    def f_native(*a):
        return _loss(*_solve_kkt(*a))

    g_imp = jax.grad(f_implicit, argnums=tuple(range(8)))(*args)
    g_nat = jax.grad(f_native, argnums=tuple(range(8)))(*args)
    names = ["Q", "R", "A", "B", "q", "r", "c", "rho"]

    def sym(M):
        return 0.5 * (np.asarray(M) + np.swapaxes(np.asarray(M), -1, -2))

    for name, gi, gn in zip(names, g_imp, g_nat):
        if name in ("Q", "R"):
            # Hessian blocks live on the symmetric manifold: only the
            # symmetrized cotangent is well defined (see diff.py), and
            # native AD's antisymmetric component reflects condense's
            # internal formulas, not the saddle system.
            gi, gn = sym(gi), sym(gn)
        scale = max(1.0, float(np.abs(np.asarray(gn)).max()))
        np.testing.assert_allclose(
            np.asarray(gi), np.asarray(gn), rtol=2e-3, atol=2e-3 * scale,
            err_msg=name,
        )


@pytest.mark.parametrize("argnum,name", [(4, "q"), (6, "c"), (7, "rho")])
def test_grads_match_finite_differences(argnum, name):
    args = list(_args())

    def f(x):
        a = list(args)
        a[argnum] = x
        return _loss(*kkt_solve(*a))

    g = jax.grad(f)(args[argnum])
    x0 = np.asarray(args[argnum], np.float64)
    eps = 1e-3
    if x0.ndim == 0:
        fd = (f(jnp.float32(x0 + eps)) - f(jnp.float32(x0 - eps))) / (2 * eps)
        np.testing.assert_allclose(float(g), float(fd), rtol=3e-2,
                                   err_msg=name)
    else:
        idx = tuple(np.unravel_index(x0.size // 2, x0.shape))
        xp = x0.copy(); xp[idx] += eps
        xm = x0.copy(); xm[idx] -= eps
        fd = (f(jnp.asarray(xp, jnp.float32))
              - f(jnp.asarray(xm, jnp.float32))) / (2 * eps)
        np.testing.assert_allclose(float(g[idx]), float(fd), rtol=3e-2,
                                   err_msg=name)


def test_grad_Q_symmetric_finite_difference():
    """Q stays on the symmetric manifold: perturb (i,j) and (j,i) together
    and compare against g[i,j] + g[j,i]."""
    args = list(_args())

    def f(Qx):
        a = list(args)
        a[0] = Qx
        return _loss(*kkt_solve(*a))

    g = jax.grad(f)(args[0])
    Q0 = np.asarray(args[0], np.float64)
    eps = 1e-3
    k, i, j = 2, 1, 0
    Qp = Q0.copy(); Qp[k, i, j] += eps; Qp[k, j, i] += eps
    Qm = Q0.copy(); Qm[k, i, j] -= eps; Qm[k, j, i] -= eps
    fd = (f(jnp.asarray(Qp, jnp.float32))
          - f(jnp.asarray(Qm, jnp.float32))) / (2 * eps)
    np.testing.assert_allclose(float(g[k, i, j] + g[k, j, i]), float(fd),
                               rtol=3e-2)


def test_vmap_and_jit_compose():
    B = 3
    problems = [_args(seed=20 + i) for i in range(B)]
    stacked = tuple(jnp.stack([p[i] for p in problems]) for i in range(8))

    @jax.jit
    def batched_loss_grad(*a):
        f = lambda *x: _loss(*kkt_solve(*x))
        return jax.vmap(jax.grad(f, argnums=4))(*a)

    g = batched_loss_grad(*stacked)
    assert g.shape == (B, SPEC.knot_points, SPEC.state_size)
    assert np.all(np.isfinite(np.asarray(g)))


def _batched_args(B=3, rho=0.05, seed0=50):
    problems = [_args(seed=seed0 + i, rho=rho) for i in range(B)]
    return tuple(jnp.stack([p[i] for p in problems])
                 for i in range(7)) + (jnp.float32(rho),)


@pytest.mark.slow
def test_batched_matches_vmapped_single():
    """kkt_solve_batched (explicit batch axis) == vmap(kkt_solve): same
    primal and same gradients — the batched API only changes the dispatch,
    not the math.  (slow tier: batched custom-VJP traces are minutes-scale
    on CPU; test_vmap_and_jit_compose keeps the diff path in the fast
    tier.)"""
    args = _batched_args()
    rho = args[-1]
    out_b = kkt_solve_batched(*args)
    out_v = jax.vmap(lambda *xs: kkt_solve(*xs, rho))(*args[:7])
    for a, b in zip(out_b, out_v):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=1e-5, atol=1e-5)

    def f_b(q, rho_):
        a = list(args)
        a[4], a[7] = q, rho_
        return _loss(*kkt_solve_batched(*a))

    def f_v(q, rho_):
        a = list(args[:7])
        a[4] = q
        return _loss(*jax.vmap(lambda *xs: kkt_solve(*xs, rho_))(*a))

    gq_b, gr_b = jax.grad(f_b, argnums=(0, 1))(args[4], rho)
    gq_v, gr_v = jax.grad(f_v, argnums=(0, 1))(args[4], rho)
    scale = max(1.0, float(np.abs(np.asarray(gq_v)).max()))
    np.testing.assert_allclose(np.asarray(gq_b), np.asarray(gq_v),
                               rtol=2e-3, atol=2e-3 * scale)
    np.testing.assert_allclose(float(gr_b), float(gr_v), rtol=2e-3,
                               atol=2e-3 * max(1.0, abs(float(gr_v))))


@pytest.mark.slow
def test_batched_cr_branch(as_h100):
    """Cyclic reduction (the H100's exact-solve choice) must produce the
    same primal and gradients as block Thomas (the CPU's) through the
    batched custom VJP.  slow tier: batched custom-VJP traces are
    minutes-scale on CPU."""
    args = _batched_args(seed0=90)

    def f(q, rho_):
        a = list(args)
        a[4], a[7] = q, rho_
        return _loss(*kkt_solve_batched(*a))

    cr_out = kkt_solve_batched(*args)
    cr_g = jax.grad(f, argnums=(0, 1))(args[4], args[-1])
    as_h100()
    ref_out = kkt_solve_batched(*args)
    ref_g = jax.grad(f, argnums=(0, 1))(args[4], args[-1])

    for a, b in zip(cr_out, ref_out):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=1e-4, atol=1e-4)
    scale = max(1.0, float(np.abs(np.asarray(ref_g[0])).max()))
    np.testing.assert_allclose(np.asarray(cr_g[0]), np.asarray(ref_g[0]),
                               rtol=2e-3, atol=2e-3 * scale)
    np.testing.assert_allclose(float(cr_g[1]), float(ref_g[1]), rtol=2e-3,
                               atol=2e-3 * max(1.0, abs(float(ref_g[1]))))

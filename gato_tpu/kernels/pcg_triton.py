"""PCG as one Pallas kernel through Triton: one program per problem.

The XLA path (pcg.pcg) is a data-dependent ``lax.while_loop``: on a GPU every
trip launches a handful of small kernels and reads the loop predicate back to
the host.  The reference fuses its whole loop into one cooperative CUDA kernel
(``parallelPCG``, gato_pcg.cuh:270-470) with ``grid.sync()`` barriers and
``atomicAdd`` reductions.  Pallas has no grid-wide barrier, so this kernel
gives each problem ONE program and runs the whole convergence loop inside it:

* the loop is a ``lax.while_loop`` in the program, so each problem exits on
  its own iteration count (no lockstep across a batch);
* the operators S and Pinv stay in device memory and are streamed in knot
  tiles of ``KT`` rows every iteration (a problem's S + Pinv at the IIWA
  shape is ~235 KB, more than a block's shared memory; the L2 cache holds
  a few hundred problems' operators);
* the vectors live in per-program scratch rows with one zero halo row on
  each side, so the block-tridiagonal neighbours x_{k-1}, x_{k+1} are plain
  offset loads; a block barrier separates a phase that writes a vector from
  the next phase that reads its neighbours;
* all products are float32 FMAs (broadcast-multiply-reduce; no ``pl.dot``,
  which could run in TF32).

State sizes are padded to ``SP`` (16 or the next power of two) and knots to a
multiple of the tile ``KT``; the zero padding is inert (zero operator blocks
and zero right-hand sides keep every padded entry at zero).  Iterates match
pcg.pcg up to the order of float32 sums.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from ..pcg import PCGResult

# Elements of one (KT, SP, SP) operator tile: 4096 floats is 32 registers a
# thread at 4 warps.
_TILE_ELEMS = 4096


def _next_pow2(n: int) -> int:
    return 1 << max(0, (n - 1).bit_length())


def plan(K: int, s: int):
    """(SP, KT, KP, KH): padded state width, knot tile, padded knots, and the
    halo scratch rows (one zero row before the trajectory, at least one after)."""
    SP = max(16, _next_pow2(s))
    KT = max(1, min(_TILE_ELEMS // (SP * SP), _next_pow2(K)))
    KP = -(-K // KT) * KT
    KH = KP + max(KT, 2)
    return SP, KT, KP, KH


def _kernel(tol_ref, mi_ref, S_ref, M_ref, g_ref, l0_ref,
            lam_ref, it_ref, cv_ref, eta_ref, r_ref, p_ref, y_ref, rt_ref,
            *poly_refs, KT: int, KP: int, KH: int, SP: int, poly_degree: int,
            interpret: bool):
    nt = KP // KT
    f32 = jnp.float32

    def barrier():
        # Interpret mode runs a program's phases in order; on the card the
        # block's threads must all finish a phase before its neighbours read.
        if not interpret:
            plgpu.debug_barrier()

    def rows(ref, k0):
        return ref[pl.ds(k0, KT), :]

    def center(ref, k0):  # halo layout: row k+1 holds knot k
        return ref[pl.ds(k0 + 1, KT), :]

    def tile_mv(op_ref, xh_ref, k0):
        """Rows k0..k0+KT of btd(op) @ x, with x in halo layout."""
        acc = jnp.zeros((KT, SP), f32)
        for j in range(3):
            blk = op_ref[pl.ds(k0, KT), j, :, :]
            xj = xh_ref[pl.ds(k0 + j, KT), :]
            acc = acc + jnp.sum(blk * xj[:, None, :], axis=-1)
        return acc

    def tiles(body, init):
        return jax.lax.fori_loop(0, nt, lambda t, c: body(t * KT, c), init)

    zero_rows = jnp.zeros((KT, SP), f32)
    halo_refs = (r_ref, p_ref) + poly_refs
    for ref in halo_refs:
        for t in range(KH // KT):
            ref[pl.ds(t * KT, KT), :] = zero_rows
    barrier()

    def apply_precond():
        """rt = M_d r (Horner form, pcg.pcg's apply_P); returns r . rt."""
        if poly_degree == 1:
            src = None
        else:
            w_ref, v_ref = poly_refs

            def first(k0, c):
                w_ref[pl.ds(k0 + 1, KT), :] = tile_mv(M_ref, r_ref, k0)
                return c

            tiles(first, 0)
            barrier()
            for _ in range(poly_degree - 1):
                def resid(k0, c):
                    v_ref[pl.ds(k0 + 1, KT), :] = (
                        center(r_ref, k0) - tile_mv(S_ref, w_ref, k0))
                    return c

                tiles(resid, 0)
                barrier()

                def step(k0, c):
                    w_ref[pl.ds(k0 + 1, KT), :] = (
                        center(w_ref, k0) + tile_mv(M_ref, v_ref, k0))
                    return c

                tiles(step, 0)
                barrier()
            src = w_ref

        def finish(k0, acc):
            z = tile_mv(M_ref, r_ref, k0) if src is None else center(src, k0)
            rt_ref[pl.ds(k0, KT), :] = z
            return acc + jnp.sum(center(r_ref, k0) * z)

        eta = tiles(finish, f32(0))
        barrier()
        return eta

    # r0 = gamma - S lam0;  lam = lam0.
    def init_r(k0, c):
        r_ref[pl.ds(k0 + 1, KT), :] = rows(g_ref, k0) - tile_mv(S_ref, l0_ref, k0)
        lam_ref[pl.ds(k0, KT), :] = center(l0_ref, k0)
        return c

    tiles(init_r, 0)
    barrier()
    eta0 = apply_precond()

    def init_p(k0, c):
        p_ref[pl.ds(k0 + 1, KT), :] = rows(rt_ref, k0)
        return c

    tiles(init_p, 0)
    barrier()

    tol = tol_ref[0]
    max_iters = mi_ref[0]

    def cond(st):
        it, _, conv, _ = st
        return (it < max_iters) & (conv == 0)

    def body(st):
        it, n_iters, conv, eta = st

        def upsilon(k0, acc):
            y = tile_mv(S_ref, p_ref, k0)
            y_ref[pl.ds(k0, KT), :] = y
            return acc + jnp.sum(center(p_ref, k0) * y)

        nu = tiles(upsilon, f32(0))
        barrier()
        alpha = jnp.where(nu != 0, eta / nu, f32(0))

        def update(k0, c):
            lam_ref[pl.ds(k0, KT), :] = rows(lam_ref, k0) + alpha * center(p_ref, k0)
            r_ref[pl.ds(k0 + 1, KT), :] = center(r_ref, k0) - alpha * rows(y_ref, k0)
            return c

        tiles(update, 0)
        barrier()
        eta_new = apply_precond()
        conv_now = jnp.abs(eta_new) < tol
        beta = jnp.where(eta != 0, eta_new / eta, f32(0))

        def direction(k0, c):
            p_ref[pl.ds(k0 + 1, KT), :] = rows(rt_ref, k0) + beta * center(p_ref, k0)
            return c

        tiles(direction, 0)
        barrier()
        n_iters = jnp.where(conv_now, it, n_iters)
        return it + 1, n_iters, conv_now.astype(jnp.int32), eta_new

    _, n_iters, conv, eta = jax.lax.while_loop(
        cond, body, (jnp.int32(0), max_iters, jnp.int32(0), eta0))
    it_ref[...] = jnp.full((1,), n_iters, jnp.int32)
    cv_ref[...] = jnp.full((1,), conv, jnp.int32)
    eta_ref[...] = jnp.full((1,), jnp.abs(eta), f32)


@functools.partial(jax.jit, static_argnames=("poly_degree", "interpret"))
def pcg_triton(S, Pinv, gamma, lam0, exit_tol, max_iters, *,
               poly_degree: int = 1, interpret: bool = False) -> PCGResult:
    """Batched PCG on (B, K, 3, s, s) operators, one program per problem.

    Same contract as ``jax.vmap(pcg.pcg)`` with a float32 ``lam0`` (B, K, s):
    per-problem (B,) ``iters``/``converged``/``eta`` with the reference's
    iteration counting."""
    Bn, K, _, s, _ = S.shape
    SP, KT, KP, KH = plan(K, s)
    f32 = jnp.float32
    op_pad = ((0, 0), (0, KP - K), (0, 0), (0, SP - s), (0, SP - s))
    Sp = jnp.pad(S.astype(f32), op_pad)
    Mp = jnp.pad(Pinv.astype(f32), op_pad)
    gp = jnp.pad(gamma.astype(f32), ((0, 0), (0, KP - K), (0, SP - s)))
    lh = jnp.pad(lam0.astype(f32), ((0, 0), (1, KH - K - 1), (0, SP - s)))
    tol = jnp.reshape(jnp.asarray(exit_tol, f32), (1,))
    mi = jnp.reshape(jnp.asarray(max_iters, jnp.int32), (1,))

    def vec(rows_):
        return pl.BlockSpec((None, rows_, SP), lambda b: (b, 0, 0))

    op = pl.BlockSpec((None, KP, 3, SP, SP), lambda b: (b, 0, 0, 0, 0))
    scalar = pl.BlockSpec((1,), lambda b: (0,))
    stat = pl.BlockSpec((None, 1), lambda b: (b, 0))
    n_poly = 2 if poly_degree > 1 else 0
    out_shape = (
        [jax.ShapeDtypeStruct((Bn, KP, SP), f32),
         jax.ShapeDtypeStruct((Bn, 1), jnp.int32),
         jax.ShapeDtypeStruct((Bn, 1), jnp.int32),
         jax.ShapeDtypeStruct((Bn, 1), f32)]
        + [jax.ShapeDtypeStruct((Bn, KH, SP), f32)] * 2       # r, p
        + [jax.ShapeDtypeStruct((Bn, KP, SP), f32)] * 2       # y, rt
        + [jax.ShapeDtypeStruct((Bn, KH, SP), f32)] * n_poly  # w, v
    )
    out_specs = ([vec(KP), stat, stat, stat, vec(KH), vec(KH), vec(KP),
                  vec(KP)] + [vec(KH)] * n_poly)
    outs = pl.pallas_call(
        functools.partial(_kernel, KT=KT, KP=KP, KH=KH, SP=SP,
                          poly_degree=poly_degree, interpret=interpret),
        out_shape=out_shape,
        grid=(Bn,),
        in_specs=[scalar, scalar, op, op, vec(KP), vec(KH)],
        out_specs=out_specs,
        backend="triton",
        # 4 warps, no software pipelining: 8 warps and 2-3 stages measured
        # within a few per cent either way on an H100 (PERF.md).
        compiler_params=plgpu.CompilerParams(num_warps=4, num_stages=1),
        interpret=interpret,
        name="gato_pcg_triton",
    )(tol, mi, Sp, Mp, gp, lh)
    lam, iters, conv, eta = outs[:4]
    return PCGResult(lam=lam[:, :K, :s].astype(gamma.dtype), iters=iters[:, 0],
                     converged=conv[:, 0] != 0, eta=eta[:, 0])

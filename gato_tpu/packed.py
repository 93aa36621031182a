"""Packed-input serving API: stage a problem on the device once, solve it
many times.

``solve``/``solve_batched`` accept host or device arrays of any float type
and, on every call, cast them, check every block shape and pick a backend.
A serving loop that solves the same arrays again (rho/tolerance sweeps,
repeated serving of a fixed linearization) or changes only the small
right-hand-side vectors (MPC tracking with frozen dynamics) pays that per
call for nothing.  This module makes the staged problem a reusable value:

    packed = pack(spec, blocks)                    # cast + check + stage once
    res = solve_packed(packed, options)            # one jitted solve
    packed = update_vectors(packed, q, r, c)       # restage ONLY the rhs
    res = solve_packed(packed, options, lam0=res.lam_packed)   # warm start
                                                   # carried on the device

``solve_packed`` returns a :class:`PackedSolveResult` whose arrays keep the
packed batch axis; ``.unpack()`` converts to the public
:class:`~gato_tpu.solver.SolveResult` shapes, and ``.lam_packed`` feeds the
next call's warm start without a host round trip.  Arrays are stored in the
public block layout (formats.KKTBlocks) with a leading batch axis, in the
dtype ``pack`` casts them to (float32 unless asked otherwise); a solve runs in
that dtype, and ``options.dtype`` must name it.

No reference equivalent: the CUDA solver re-runs its CSR->custom conversion
per ``linsys_solve`` call and keeps inputs device-resident only inside the
one-call testiters loop (gpu_library.cu:140-157).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

from .formats import KKTBlocks, check_block_shapes
from .problem import ProblemSpec, SolverOptions
from .solver import SolveResult, _cached_const, _solve_batched_core


class PackPlan(NamedTuple):
    """Static description of a pack (hashable: jit-static metadata).

    ``batched`` records whether the caller supplied a leading batch axis
    (``unpack`` restores the caller's shape convention); ``batch`` is the
    number of problems packed (1 when not batched); ``dtype`` is the name
    of the staged arrays' dtype."""

    batched: bool
    batch: int
    K: int
    s: int
    c: int
    dtype: str = "float32"


_DATA = ["Q", "R", "A", "B", "q", "r", "c"]


@functools.partial(jax.tree_util.register_dataclass, data_fields=_DATA,
                   meta_fields=["plan"])
@dataclasses.dataclass(frozen=True)
class PackedKKT:
    """KKT blocks staged on the device: formats.KKTBlocks fields with a
    leading batch axis, in ``plan.dtype``.  A pytree whose structure carries the static
    :class:`PackPlan`."""

    Q: jnp.ndarray
    R: jnp.ndarray
    A: jnp.ndarray
    B: jnp.ndarray
    q: jnp.ndarray
    r: jnp.ndarray
    c: jnp.ndarray
    plan: PackPlan

    def blocks(self) -> KKTBlocks:
        return KKTBlocks(*(getattr(self, f) for f in _DATA))


_RESULT = ["lam_p", "dzx_p", "dzu_p", "iters", "converged", "eta"]


@functools.partial(jax.tree_util.register_dataclass, data_fields=_RESULT,
                   meta_fields=["plan"])
@dataclasses.dataclass(frozen=True)
class PackedSolveResult:
    """Solve outputs with the packed batch axis kept: ``lam_p``/``dzx_p``
    ``(B, K, s)``, ``dzu_p`` ``(B, K-1, c)``, ``iters``/``converged``/
    ``eta`` ``(B,)`` (scalars after ``unpack`` when the pack was
    unbatched)."""

    lam_p: jnp.ndarray
    dzx_p: jnp.ndarray
    dzu_p: jnp.ndarray
    iters: jnp.ndarray
    converged: jnp.ndarray
    eta: jnp.ndarray
    plan: PackPlan

    @property
    def lam_packed(self) -> jnp.ndarray:
        """Multipliers with the packed batch axis — feed as
        ``solve_packed(lam0=...)`` to warm-start the next solve."""
        return self.lam_p

    def unpack(self) -> SolveResult:
        """Public SolveResult shapes ((B, K, s) batched, (K, s) otherwise)."""
        res = SolveResult(*(getattr(self, f) for f in _RESULT))
        if self.plan.batched:
            return res
        return SolveResult(*(x[0] for x in res))


def _staged(blocks, dtype) -> KKTBlocks:
    return KKTBlocks(*(jnp.asarray(a, dtype) for a in blocks))


def pack(spec: ProblemSpec, blocks: KKTBlocks,
         dtype="float32") -> PackedKKT:
    """Cast, check and stage KKT blocks on the device for repeated solves.

    ``blocks`` (formats.pack_kkt layout) may carry a leading batch axis
    (``Q.ndim == 4`` means batched).  ``dtype`` is the precision every solve
    of this pack runs in (float64 needs ``jax_enable_x64``).  Raises
    ValueError on a shape that does not match ``spec``."""
    b = _staged(blocks, dtype)
    batched = b.Q.ndim == 4
    if not batched:
        b = KKTBlocks(*(a[None] for a in b))
    Bn = b.Q.shape[0]
    check_block_shapes(spec, b, lead=(Bn,))
    plan = PackPlan(batched=batched, batch=Bn, K=spec.knot_points,
                    s=spec.state_size, c=spec.control_size,
                    dtype=b.Q.dtype.name)
    return PackedKKT(*jax.device_put(tuple(b)), plan=plan)


def update_vectors(packed: PackedKKT, q, r, c) -> PackedKKT:
    """Return a PackedKKT with fresh rhs vectors (q, r, c) and the SAME
    matrices — the cheap refresh for serving a frozen linearization."""
    plan = packed.plan
    q, r, c = (jnp.asarray(x, plan.dtype) for x in (q, r, c))
    if not plan.batched:
        q, r, c = q[None], r[None], c[None]
    expect = {
        "q": (plan.batch, plan.K, plan.s),
        "r": (plan.batch, plan.K - 1, plan.c),
        "c": (plan.batch, plan.K, plan.s),
    }
    for name, arr in (("q", q), ("r", r), ("c", c)):
        if arr.shape != expect[name]:
            batched_note = "" if plan.batched else " (unbatched pack)"
            raise ValueError(
                f"{name} shape {arr.shape} does not match the packed plan's "
                f"{expect[name]}{batched_note}")
    return dataclasses.replace(packed, q=q, r=r, c=c)


def _check_options(options: SolverOptions, plan: PackPlan,
                   what: str) -> None:
    if jnp.dtype(options.dtype) != jnp.dtype(plan.dtype):
        raise ValueError(
            f"{what}: the pack holds {plan.dtype} arrays but "
            f"options.dtype={options.dtype!r}; pack with dtype="
            f"{options.dtype!r} to solve in that precision")


def _packed_lam0(lam0, plan: PackPlan, lead=()) -> jnp.ndarray:
    """Warm start as ``lead + (B, K, s)``: a packed carry, the public
    unbatched (K, s) form, or zeros when None."""
    full = lead + (plan.batch, plan.K, plan.s)
    if lam0 is None:
        return _cached_const(0, plan.dtype, full)
    lam0 = jnp.asarray(lam0, plan.dtype)
    if lam0.shape == full:
        return lam0
    if not plan.batched and lam0.shape == lead + (plan.K, plan.s):
        return lam0[..., None, :, :]
    raise ValueError(f"lam0 shape {lam0.shape} does not match the packed "
                     f"carry {full}")


def solve_packed(
    packed: PackedKKT,
    options: SolverOptions = SolverOptions(),
    lam0: Optional[jnp.ndarray] = None,
) -> PackedSolveResult:
    """Solve from staged inputs: the backend choice and one jitted solve.

    ``options.method`` selects PCG or the exact solver per call.  ``lam0``
    is a previous result's ``lam_packed`` (or the public ``(K, s)`` array
    of an unbatched pack); like the MPC sequence APIs, a supplied ``lam0``
    is USED regardless of ``options.warm_start`` — chaining is the point of
    this API.  Returns a :class:`PackedSolveResult`; call ``.unpack()`` for
    public shapes."""
    from .solver import resolve_backend

    plan = packed.plan
    _check_options(options, plan, "solve_packed")
    spec = ProblemSpec(plan.s, plan.c, plan.K)
    backend = resolve_backend(None, options, spec)
    dt = plan.dtype
    res = _solve_batched_core(
        *packed.blocks(), _packed_lam0(lam0, plan),
        _cached_const(options.rho, dt),
        _cached_const(options.exit_tol, dt),
        _cached_const(options.max_iters, jnp.int32),
        options.preconditioner, backend, options.method,
        options.precond_poly_degree,
    )
    return PackedSolveResult(*res, plan=plan)


# ---------------------------------------------------------------------------
# Sequence farms: stage the whole (T, B) stream once.


@functools.partial(jax.tree_util.register_dataclass, data_fields=_DATA,
                   meta_fields=["plan"])
@dataclasses.dataclass(frozen=True)
class PackedKKTSequence:
    """A (T, B) MPC-farm input stream staged on the device: KKTBlocks fields
    with leading (T, B) axes, in ``plan.dtype``.  A long-session serving loop packs
    each window once and carries the warm start on the device
    (``PackedSequenceResult.lam_tail_packed`` -> the next window's
    ``lam0``)."""

    Q: jnp.ndarray
    R: jnp.ndarray
    A: jnp.ndarray
    B: jnp.ndarray
    q: jnp.ndarray
    r: jnp.ndarray
    c: jnp.ndarray
    plan: PackPlan

    @property
    def T(self) -> int:
        return self.Q.shape[0]

    def blocks(self) -> KKTBlocks:
        return KKTBlocks(*(getattr(self, f) for f in _DATA))


@functools.partial(jax.tree_util.register_dataclass, data_fields=_RESULT,
                   meta_fields=["plan"])
@dataclasses.dataclass(frozen=True)
class PackedSequenceResult:
    """Farm outputs: trajectories ``(T, B, K, ·)``, ``iters``/``converged``/
    ``eta`` ``(T, B)``."""

    lam_p: jnp.ndarray
    dzx_p: jnp.ndarray
    dzu_p: jnp.ndarray
    iters: jnp.ndarray
    converged: jnp.ndarray
    eta: jnp.ndarray
    plan: PackPlan

    @property
    def lam_tail_packed(self) -> jnp.ndarray:
        """The final step's multipliers ``(B, K, s)`` — feed as the next
        window's ``solve_packed_sequence(lam0=...)``."""
        return self.lam_p[-1]

    def unpack(self) -> SolveResult:
        """Public shapes: lam/dz_x ``(T, B, K, s)``, dz_u
        ``(T, B, K-1, c)``, aux ``(T, B)``."""
        return SolveResult(*(getattr(self, f) for f in _RESULT))


def pack_sequence(spec: ProblemSpec, blocks: KKTBlocks,
                  dtype="float32") -> PackedKKTSequence:
    """Cast, check and stage a (T, B) farm stream once, for
    solve_packed_sequence (``dtype`` as in :func:`pack`).

    ``blocks`` arrays carry leading (T, B) axes (the
    mpc.solve_sequence_batched convention).  Only the warm-started PCG farm
    is served this way: the EXACT farm has no warm-start carry, so its
    (T, B) grid folds into ONE batch of T*B solves — ``pack`` that folded
    batch and call ``solve_packed`` with ``method='direct'``."""
    b = _staged(blocks, dtype)
    if b.Q.ndim != 5:
        raise ValueError(
            f"pack_sequence expects leading (T, B) axes on every array "
            f"(Q is {b.Q.ndim}-d); for a single sequence add a B=1 axis")
    T, Bn = b.Q.shape[:2]
    check_block_shapes(spec, b, lead=(T, Bn))
    plan = PackPlan(batched=True, batch=Bn, K=spec.knot_points,
                    s=spec.state_size, c=spec.control_size,
                    dtype=b.Q.dtype.name)
    return PackedKKTSequence(*jax.device_put(tuple(b)), plan=plan)


def solve_packed_sequence(
    packed: PackedKKTSequence,
    options: SolverOptions = SolverOptions(),
    lam0: Optional[jnp.ndarray] = None,
) -> PackedSequenceResult:
    """Run the whole warm-started farm window from staged inputs.

    Semantics of mpc.solve_sequence_batched (one scan over T, every step a
    batched PCG solve warm-started from the previous step).  ``lam0``: a
    previous window's ``lam_tail_packed`` ``(B, K, s)``, or None (cold
    start); a supplied ``lam0`` is used unconditionally — chaining windows
    is the point of this API."""
    from .mpc import _solve_sequence_batched_core
    from .solver import resolve_backend

    plan = packed.plan
    if options.method != "pcg":
        raise ValueError(
            "solve_packed_sequence is the warm-started PCG farm; "
            "method='direct' sequences fold into one batch (pack + "
            "solve_packed on the folded batch)")
    _check_options(options, plan, "solve_packed_sequence")
    spec = ProblemSpec(plan.s, plan.c, plan.K)
    backend = resolve_backend(None, options, spec)
    dt = plan.dtype
    res = _solve_sequence_batched_core(
        *packed.blocks(), _packed_lam0(lam0, plan),
        _cached_const(options.rho, dt, (packed.T,)),
        _cached_const(options.exit_tol, dt),
        _cached_const(options.max_iters, jnp.int32),
        options.preconditioner, backend, options.precond_poly_degree,
    )
    return PackedSequenceResult(*res, plan=plan)

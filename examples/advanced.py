"""Capabilities tour: polynomial preconditioning, long horizons, exact
direct solves, MPC chains and farms, packed serving, differentiable batches,
and multi-device batches.

Runs anywhere: on a CUDA GPU dispatch picks the measured-fastest backend
(gato_tpu.dispatch), elsewhere the XLA path runs; the multi-device section uses
however many devices exist.

Run:  python examples/advanced.py
"""

import jax
import jax.numpy as jnp
import numpy as np

from gato_tpu import ProblemSpec, SolverOptions, solve, solve_sequence
from gato_tpu.formats import KKTBlocks
from gato_tpu.testing import random_blocks

iiwa = ProblemSpec(state_size=14, control_size=7, knot_points=50)
blocks = random_blocks(iiwa, seed=0)

# --- polynomial preconditioner composition ----------------------------------
# precond_poly_degree=d applies M_d r = P sum_{i<d} (I - S P)^i r: wider
# effective bandwidth with no extra stored blocks.  Fewer iterations whenever
# iterations are the scarce resource (streamed horizons, sharded meshes).
for d in (1, 2, 3):
    res = solve(iiwa, blocks, SolverOptions(rho=1e-3, exit_tol=1e-6,
                                            max_iters=200,
                                            precond_poly_degree=d))
    print(f"poly degree {d}: {int(res.iters)} PCG iterations")

# --- long horizons -----------------------------------------------------------
# Dispatch picks the backend by horizon: the Triton PCG kernel streams its
# operators per iteration from one program, so long horizons run XLA's
# batched while loop instead (the measured crossover, PERF.md).
long_spec = ProblemSpec(14, 7, 1024)
res = solve(long_spec, random_blocks(long_spec, seed=1),
            SolverOptions(rho=1e-2, exit_tol=1e-6, max_iters=300))
print(f"K=1024: {int(res.iters)} iterations, "
      f"converged={bool(res.converged)}")

# --- exact direct solve ------------------------------------------------------
# Condense + block cyclic reduction (or the Thomas scan, as dispatch picks) +
# recovery: no tolerance, no iterations — also the robust option when PCG
# stalls.
res = solve(iiwa, blocks, SolverOptions(rho=1e-3, method="direct"))
print(f"direct: iters={int(res.iters)} residual^2={float(res.eta):.2e}")

# --- MPC chain, one device program ------------------------------------------
T = 16
seq = KKTBlocks(*(jnp.broadcast_to(jnp.asarray(a), (T,) + a.shape)
                  for a in blocks))
seq = seq._replace(q=seq.q * (1.0 + 0.01 * jnp.arange(T)[:, None, None]))
out = solve_sequence(iiwa, seq, SolverOptions(rho=1e-3, exit_tol=1e-6,
                                              max_iters=200))
iters = [int(x) for x in np.asarray(out.iters)]
print(f"MPC chain: first {iters[0]} iters, warm-started rest "
      f"{float(np.mean(iters[1:])):.1f} mean")

# --- MPC FARM: B warm-started streams in lockstep ----------------------------
# Leading (T, B) axes; every step is ONE batched solve advancing all streams
# with their own warm-start carries — the serving deployment for fleets of
# controllers.
from gato_tpu import solve_sequence_batched

Bf = 4
farm = KKTBlocks(*(jnp.broadcast_to(jnp.asarray(a), (T, Bf) + a.shape)
                   for a in blocks))
farm = farm._replace(q=farm.q * (1.0 + 0.01 * jnp.arange(T)[:, None, None, None]
                                 + 0.1 * jnp.arange(Bf)[None, :, None, None]))
out = solve_sequence_batched(iiwa, farm, SolverOptions(rho=1e-3,
                                                       exit_tol=1e-6,
                                                       max_iters=200))
it = np.asarray(out.iters)
print(f"MPC farm ({Bf} streams): first-step mean {float(it[0].mean()):.1f} "
      f"iters, warm-started rest {float(it[1:].mean()):.1f} mean")

# --- packed serving: stage once, solve repeatedly ----------------------------
# pack() checks and stages the blocks on the device once; solve_packed skips
# the per-call casts and checks, update_vectors refreshes only the rhs
# (frozen linearization), and the warm-start carry stays on the device.
from gato_tpu import pack, solve_packed, update_vectors

opts = SolverOptions(rho=1e-3, exit_tol=1e-6, max_iters=200)
packed = pack(iiwa, blocks)
first = solve_packed(packed, opts)
packed = update_vectors(packed, np.asarray(blocks.q) * 1.01,
                        blocks.r, blocks.c)
warm = solve_packed(packed, opts, lam0=first.lam_packed)
print(f"packed serving: cold {int(first.unpack().iters)} iters, rhs-refresh "
      f"warm {int(warm.unpack().iters)} iters")

# --- differentiable batched solves ------------------------------------------
# kkt_solve_batched: implicit-function-theorem gradients, the forward AND
# adjoint exact solves batched over the leading axis.
from gato_tpu import kkt_solve_batched

Bd = 3
dprobs = [random_blocks(iiwa, seed=40 + i) for i in range(Bd)]
dargs = tuple(jnp.asarray(np.stack([np.asarray(p[f]) for p in dprobs]))
              for f in range(7))
gQ = jax.grad(
    lambda Q: jnp.sum(kkt_solve_batched(Q, *dargs[1:], jnp.float32(1e-3))[0] ** 2)
)(dargs[0])
print(f"differentiable batch: dloss/dQ shape {gQ.shape}, "
      f"finite={bool(np.all(np.isfinite(np.asarray(gQ))))}")

# --- multi-device: batch sharded over a mesh, batched solve per device -------
from jax.sharding import Mesh
from gato_tpu.parallel.sharded import solve_batched_dp

n_dev = max(1, len(jax.devices()))
B = 4 * n_dev
small = ProblemSpec(4, 2, 10)
probs = [random_blocks(small, seed=10 + i) for i in range(B)]
bb = KKTBlocks(*(jnp.asarray(np.stack([np.asarray(p[f]) for p in probs]))
                 for f in range(7)))
mesh = Mesh(np.array(jax.devices()), ("dp",))
res_dp, _, _ = solve_batched_dp(mesh, *bb, rho=1e-2, exit_tol=1e-8,
                                max_iters=200)
print(f"dp-sharded batch ({B} problems / {n_dev} devices): "
      f"all converged={bool(np.all(np.asarray(res_dp.converged)))}")

"""Serving-deployment tour: the packed API from one device to a fleet.

A production MPC/QP serving loop re-solves the same SHAPE thousands of times
per second.  The standard `solve_batched` casts, checks and stages its inputs
on every call; this example shows the three serving levels that remove it:

  1. pack once + rhs refresh         (one device, frozen linearization)
  2. warm-start carry                (the solution stays on the device)
  3. fleet serving over a mesh       (the same packed value, batch sharded)

Runs anywhere (the mesh section uses however many devices exist).
Run:  python examples/serving.py
"""

import jax
import jax.numpy as jnp
import numpy as np

from gato_tpu import (ProblemSpec, SolverOptions, pack, solve_packed,
                      update_vectors)
from gato_tpu.formats import KKTBlocks
from gato_tpu.testing import random_blocks

spec = ProblemSpec(state_size=4, control_size=2, knot_points=12)
opts = SolverOptions(rho=1e-3, exit_tol=1e-8, max_iters=200)

B = 8
problems = [random_blocks(spec, seed=i) for i in range(B)]
blocks = KKTBlocks(*(jnp.asarray(np.stack([np.asarray(p[f])
                                           for p in problems]))
                     for f in range(7)))

# --- 1. pack once, then serve ----------------------------------------------
packed = pack(spec, blocks)
res = solve_packed(packed, opts)
print(f"cold solve: iters {np.asarray(res.iters).tolist()}")

# Frozen linearization, fresh rhs every tick: refresh ONLY the vectors
# (O(s) per knot instead of O(s^2) for the four matrix stacks).
for tick in range(3):
    q_new = np.asarray(blocks.q) * (1.0 + 0.02 * (tick + 1))
    packed = update_vectors(packed, q_new, blocks.r, blocks.c)
    # --- 2. the warm-start carry stays on the device across calls -----------
    res = solve_packed(packed, opts, lam0=res.lam_packed)
    print(f"tick {tick}: warm iters {np.asarray(res.iters).tolist()}")

out = res.unpack()          # public (B, K, s) shapes only when needed
print(f"unpacked lam shape {out.lam.shape}, all converged "
      f"{bool(np.all(np.asarray(out.converged)))}")

# --- 3. fleet serving: the same packed value sharded over a mesh -------------
# The batch axis shards over the devices (B must divide by the mesh size).
from jax.sharding import Mesh
from gato_tpu.parallel.sharded import solve_packed_dp

n_use = max(n for n in (1, 2, 4, 8) if n <= len(jax.devices()) and B % n == 0)
mesh = Mesh(np.array(jax.devices()[:n_use]), ("dp",))
res_dp = solve_packed_dp(mesh, packed, opts, lam0=res.lam_packed)
print(f"fleet ({n_use} devices): iters {np.asarray(res_dp.iters).tolist()}")

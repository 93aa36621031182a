"""IIWA-scale (14,7,50) solves: single, batched, and MPC sequence.

The working version of what the reference's broken test_IIWA50.py intended
(it imports from an absent private repo, test_IIWA50.py:6-9), plus the batch
and MPC modes the reference does not have.

Run:  python examples/iiwa_batch.py
"""

import time

import jax
import jax.numpy as jnp
import numpy as np

from gato_tpu import (KKTBlocks, ProblemSpec, SolverOptions, solve,
                      solve_batched, solve_sequence)
from gato_tpu.testing import dense_oracle, random_blocks

spec = ProblemSpec(state_size=14, control_size=7, knot_points=50)
opts = SolverOptions(exit_tol=1e-6, max_iters=200, rho=1e-3)

# --- single solve, checked against the dense oracle -------------------------
blocks = random_blocks(spec, seed=0)
res = solve(spec, blocks, opts)
lam_ref, _ = dense_oracle(spec, blocks, rho=1e-3)
err = np.max(np.abs(res.lam_flat() - lam_ref))
print(f"single solve: {int(res.iters)} PCG iters, max |err| vs oracle {err:.2e}")

# --- 256 independent problems in one batched solve --------------------------
B = 256
problems = [random_blocks(spec, seed=100 + i) for i in range(B)]
batch = KKTBlocks(*(jnp.asarray(np.stack([np.asarray(p[f]) for p in problems]))
                    for f in range(7)))
bres = solve_batched(spec, batch, opts)
jax.block_until_ready(bres.lam)
t0 = time.perf_counter()
bres = solve_batched(spec, batch, opts)
jax.block_until_ready(bres.lam)
dt = time.perf_counter() - t0
print(f"batch {B}: all converged={bool(jnp.all(bres.converged))}, "
      f"{dt * 1e6 / B:.1f} us/solve")

# --- MPC: 32 warm-started dependent solves in one device program ------------
T = 32
seq = KKTBlocks(*(jnp.broadcast_to(jnp.asarray(a), (T,) + a.shape)
                  for a in blocks))
sres = solve_sequence(spec, seq, opts)
print(f"MPC sequence: first solve {int(sres.iters[0])} iters, "
      f"warm-started rest mean {float(jnp.mean(sres.iters[1:])):.1f} iters")

"""gato_tpu.timing: the library form of the bench methodology (smoke-level —
real latency numbers need hardware; here we check the machinery: chaining,
differencing, perturbation, and the solver-surface wrapper)."""

import numpy as np

import jax.numpy as jnp

from gato_tpu.problem import ProblemSpec, SolverOptions
from gato_tpu.testing import random_blocks
from gato_tpu.timing import chain_time, perturb, time_solve


def test_perturb_changes_q_and_Q():
    spec = ProblemSpec(2, 1, 5)
    blocks = random_blocks(spec, seed=0)
    b = type(blocks)(*(jnp.asarray(np.asarray(a)) for a in blocks))
    Q1, q1 = perturb(b, b.q, jnp.ones_like(b.q), jnp.float32(1.0))
    Q2, q2 = perturb(b, b.q, jnp.ones_like(b.q), jnp.float32(2.0))
    # Both the operator and the rhs must vary with t (hoisting breaker).
    assert float(jnp.max(jnp.abs(Q1 - Q2))) > 0
    assert float(jnp.max(jnp.abs(q1 - q2))) > 0


def test_time_solve_single_and_batched():
    spec = ProblemSpec(2, 1, 5)
    blocks = random_blocks(spec, seed=1)
    ms, info = time_solve(spec, blocks, SolverOptions(rho=1e-3), T=4,
                          reps=2, n_independent=2, min_diff_ms=0.0)
    # CPU timings here are pure jitter: extra re-measure rounds may fire
    # (capped at n_independent + max_extra estimates) and T may double on a
    # negative pilot difference (up to three times).
    assert ms > 0 and info["T"] in (4, 8, 16, 32)
    assert 2 <= len(info["reps_ms"]) <= 6
    # BASELINE.md protocol: first run (includes compile) reported alongside
    # the steady-state average.
    assert info["first_call_ms"] > 0

    batch = type(blocks)(*(np.stack([np.asarray(a)] * 3) for a in blocks))
    ms_b, info_b = time_solve(spec, batch, SolverOptions(rho=1e-3), T=4,
                              reps=2, n_independent=2, min_diff_ms=0.0)
    assert ms_b > 0


def test_chain_time_doubles_on_noise():
    calls = []

    def step(q0, lam_carry, t):
        return q0 * (1.0 + 0.0 * t) + lam_carry * 0.0

    q0 = jnp.ones((4, 2))
    ms, info = chain_time(step, q0, T=2, reps=2, n_independent=2,
                          min_diff_ms=1e9, log=calls.append)
    # Impossible noise floor: T doubled three times (the cap), warning
    # recorded, log called.
    assert info["T"] == 16 and "noise_warning" in info and calls


def test_best_cluster_rejects_transient():
    from gato_tpu.timing import _best_cluster

    # A one-off 40x stall must not pollute the reported value.
    ms, spread = _best_cluster([0.39, 15.6, 0.41], 2)
    assert abs(ms - 0.40) < 0.02 and spread < 0.03


def _scripted_chain_time(monkeypatch, timed_values, **kw):
    """Run chain_time against a scripted sequence of _timed readings (pairs
    consumed as t1, t2 per estimate) with the chain build/compile stubbed."""
    from gato_tpu import timing

    monkeypatch.setattr(timing, "_chain_fn",
                        lambda step_fn, q0, length: (lambda q: 0.0))
    vals = iter(timed_values)
    monkeypatch.setattr(timing, "_timed",
                        lambda chain, q0, rep: next(vals))
    return timing.chain_time(lambda q0, lam, t: q0, jnp.zeros(()), T=2,
                             reps=1, **kw)


def test_chain_time_drops_corrupted_differences(monkeypatch):
    """A stall can make a T-vs-2T difference non-positive; such an
    estimate must be DROPPED and re-measured — floor-clamping it would let
    two stalls form a fake zero-spread 'tightest cluster' of identical floor
    values (the silent-corruption bug this pins)."""
    # est0: 30-10 = 20 ms (good); est1: 48-50 = -2 ms (corrupted, dropped;
    # gate median([20,-2]) = 9 >= 8 still passes); extra: 31-10 = 21 (good).
    ms, info = _scripted_chain_time(
        monkeypatch, [10.0, 30.0, 50.0, 48.0, 10.0, 31.0])
    assert info["reps_ms"] == [10.0, 10.5]      # 20/T, 21/T with T=2
    assert ms == 10.25                          # cluster median, no floor
    assert "noise_warning" not in info


def test_chain_time_warns_when_estimates_stay_corrupted(monkeypatch):
    """If re-measurement cannot recover enough usable estimates, the result
    must carry a noise warning instead of a silently-tiny clean-looking
    number."""
    # est0 good (diff 20), est1 + all 4 extras corrupted (diff -1 each).
    vals = [10.0, 30.0, 50.0, 49.0] + [10.0, 9.0] * 4
    ms, info = _scripted_chain_time(monkeypatch, vals)
    assert info["reps_ms"] == [10.0]
    assert ms == 10.0
    assert "usable estimates" in info["noise_warning"]

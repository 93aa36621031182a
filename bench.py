"""Benchmark: time the solver's public entry points on the attached GPU.

    python bench.py                 # every row
    python bench.py --rows b256     # rows whose name contains "b256"
    python bench.py --rows k96,k128 # rows of either horizon

Each row times one public call (``solve`` or ``solve_batched``) end to end:
the call and ``jax.block_until_ready`` on its result, after a warm-up call
that compiles.  It prints one JSON object per row to stdout, stamped with
the device (platform, device_kind, device count) and the card's name and
power limit as ``nvidia-smi`` reports them, then one summary line.  Rows run
in pairs of backends in the order A, B, B, A so that a drift of the card's
clocks does not favour either side; with ``--pairs N`` both backends of a
pair are compiled first and then timed in N alternating rounds (A B, B A,
...), each round the median of ``--reps`` calls, and every row reports its
per-round medians and how many rounds it won.

    python bench.py --rows pcg --pairs 10 --reps 10 --poly-degree 2

The roofline fields divide by the peak table below, keyed by
``device_kind``; a device not in the table is an error.  A run that finds no
GPU exits nonzero and prints no row.  Everything runs in this one process:
the ``nvidia-smi`` child never touches the card through JAX.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np

# Published peaks, dense, without sparsity (NVIDIA H100 SXM data sheet):
# float32 outside the tensor cores and HBM3 bandwidth.  The solver's work is
# float32 FMAs on (s, s) blocks, so the tensor-core rates do not apply.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {
        "f32_flops": 67e12,
        "hbm_Bps": 3.35e12,
        "source": "NVIDIA H100 SXM5 data sheet: 67 TFLOP/s FP32, "
                  "3.35 TB/s HBM3",
    },
}


def peak_for(device_kind: str) -> dict:
    """The peak-table entry for ``device_kind``; unknown devices raise."""
    try:
        return PEAKS[device_kind]
    except KeyError:
        raise ValueError(
            f"no peak rates for device_kind {device_kind!r}; add it to "
            f"bench.PEAKS with its source") from None


# ---- Analytic work model (FMA = 2 flops; Gauss-Jordan inverse of n x n =
# 2n^3; (n,m)x(m,k) product = 2nmk).  Estimates are +-20% by design: they
# bucket rows into latency-, bandwidth- or compute-bound, not cycles.


def _gj(n):
    return 2 * n ** 3


def _flops_condense(s, c, K, precond="symmetric_stair"):
    per = (_gj(s) + _gj(c)                    # Qinv, Rinv
           + 2 * s ** 3 + 2 * s * c * c      # phi, B Rinv
           + 2 * s ** 3 + 2 * s * s * c      # phi A^T, BR B^T
           + 6 * s * s + 4 * s * c)          # gamma / vector terms
    if precond == "symmetric_stair":
        per += _gj(s) + 2 * (2 * s ** 3)     # theta inv + stair products
    elif precond == "block_jacobi":
        per += _gj(s)
    return K * per


def _flops_pcg(s, K, iters, poly_degree=1):
    mv = 2 * 3 * s * s * K                   # one block-tridiag matvec
    per_iter = (2 + 2 * (poly_degree - 1)) * mv + 10 * s * K
    return iters * per_iter + 2 * mv         # + r0 / r~0 setup


def _flops_recover(s, c, K):
    return K * (4 * s * s + 2 * s * c + 2 * c * c + 6 * s)


def _flops_direct_cr(s, K):
    # Per eliminated row: one GJ + 6 (s,s) products (direct.btd_solve_cr);
    # back-substitution 3 matvecs per row.
    return K * (_gj(s) + 6 * 2 * s ** 3) + K * 3 * 2 * s * s


def _flops_direct_thomas(s, K):
    # Per knot one GJ and two (s,s) products forward, two matvecs back.
    return K * (_gj(s) + 2 * 2 * s ** 3 + 2 * 2 * s * s)


def _bytes_io(s, c, K):
    """Problem blocks in + (lam, dz) out, once — the floor every backend
    pays."""
    ins = K * (2 * s * s + c * c + s * c + 2 * s + c)
    outs = 3 * K * s
    return 4 * (ins + outs)


def _bytes_op(s, K):
    """One pass over one (K, 3, s, s) operator (S or Pinv)."""
    return 4 * 3 * s * s * K


def solve_flops_bytes(kind, s, c, K, iters, poly_degree=1):
    """(flops, bytes_floor, bytes_restream) per solve.

    ``floor``: every operand crosses device memory once each way (problem
    in, results out, the condensed operators written once and read once).
    ``restream``: the zero-reuse model, where every per-iteration operator
    pass goes to device memory.  Measured times land between the two; the
    gap is what the caches kept.  Exact solves have floor == restream.
    """
    io = _bytes_io(s, c, K)
    if kind == "pcg":
        fl = (_flops_condense(s, c, K) + _flops_pcg(s, K, iters, poly_degree)
              + _flops_recover(s, c, K))
        floor = io + 4 * _bytes_op(s, K)
        per_iter = 2 * poly_degree * _bytes_op(s, K) + 6 * 4 * K * s
        return fl, floor, floor + iters * per_iter
    if kind in ("direct_cr", "direct_thomas"):
        solve_fl = (_flops_direct_cr if kind == "direct_cr"
                    else _flops_direct_thomas)(s, K)
        fl = (_flops_condense(s, c, K, precond=None) + solve_fl
              + _flops_recover(s, c, K))
        b = io + 2 * _bytes_op(s, K)
        return fl, b, b
    raise ValueError(kind)


def annotate_roofline(entry, s, c, K, kind, device_kind, *, iters=0,
                      batch=1, poly_degree=1):
    """Attach the work model and the roofline share to a measured row.

    The least time is the larger of flops over peak float32 rate and the
    floor bytes over peak bandwidth; ``pct_of_roofline`` is that time over
    the measured time, and ``bound`` names which of the two set it.  Rows
    without a positive time are returned unchanged."""
    ms = entry.get("ms_median")
    if not ms or ms <= 0:
        return entry
    peak = peak_for(device_kind)
    fl, floor, restream = solve_flops_bytes(kind, s, c, K, iters,
                                            poly_degree)
    fl, floor, restream = fl * batch, floor * batch, restream * batch
    t_fl = fl / peak["f32_flops"] * 1e3
    t_by = floor / peak["hbm_Bps"] * 1e3
    roof = max(t_fl, t_by)
    entry["roofline"] = {
        "flops": fl,
        "bytes_floor": floor,
        "bytes_restream": restream,
        "achieved_gflops": fl / ms / 1e6,
        "achieved_gbps": floor / ms / 1e6,
        "roofline_ms": roof,
        "pct_of_roofline": 100.0 * roof / ms,
        "bound": "compute" if t_fl >= t_by else "bandwidth",
        "peak_source": peak["source"],
    }
    return entry


def _jsonable(obj):
    """Recursively cast NumPy scalars/arrays so json.dumps never fails."""
    if isinstance(obj, dict):
        return {k: _jsonable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_jsonable(v) for v in obj]
    if isinstance(obj, np.ndarray):
        return obj.tolist()
    if isinstance(obj, np.generic):
        return obj.item()
    return obj


def card_name_and_power_limit() -> str:
    """``name, power.limit`` of the card, from an nvidia-smi child (which
    does not import JAX), or a note saying why it could not be read."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True)
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable: {e}"
    return out.stdout.strip()


def device_stamp() -> dict:
    import jax

    d = jax.devices()[0]
    return {"platform": d.platform, "kind": d.device_kind,
            "count": len(jax.devices())}


IIWA = (14, 7)

# (name, K, batch, method, pcg_backend); consecutive pairs share a shape and
# run in the order A, B, B, A.
ROWS = [
    ("iiwa_b1_pcg_triton", 50, 1, "pcg", "triton"),
    ("iiwa_b1_pcg_jax", 50, 1, "pcg", "jax"),
    ("iiwa_b256_pcg_triton", 50, 256, "pcg", "triton"),
    ("iiwa_b256_pcg_jax", 50, 256, "pcg", "jax"),
    ("iiwa_b1024_pcg_triton", 50, 1024, "pcg", "triton"),
    ("iiwa_b1024_pcg_jax", 50, 1024, "pcg", "jax"),
    ("iiwa_k96_b1_pcg_triton", 96, 1, "pcg", "triton"),
    ("iiwa_k96_b1_pcg_jax", 96, 1, "pcg", "jax"),
    ("iiwa_k96_b256_pcg_triton", 96, 256, "pcg", "triton"),
    ("iiwa_k96_b256_pcg_jax", 96, 256, "pcg", "jax"),
    ("iiwa_k96_b1024_pcg_triton", 96, 1024, "pcg", "triton"),
    ("iiwa_k96_b1024_pcg_jax", 96, 1024, "pcg", "jax"),
    ("iiwa_k128_b1_pcg_triton", 128, 1, "pcg", "triton"),
    ("iiwa_k128_b1_pcg_jax", 128, 1, "pcg", "jax"),
    ("iiwa_k128_b256_pcg_triton", 128, 256, "pcg", "triton"),
    ("iiwa_k128_b256_pcg_jax", 128, 256, "pcg", "jax"),
    ("iiwa_k128_b1024_pcg_triton", 128, 1024, "pcg", "triton"),
    ("iiwa_k128_b1024_pcg_jax", 128, 1024, "pcg", "jax"),
    ("iiwa_k256_b1_pcg_triton", 256, 1, "pcg", "triton"),
    ("iiwa_k256_b1_pcg_jax", 256, 1, "pcg", "jax"),
    ("iiwa_k1024_b1_pcg_triton", 1024, 1, "pcg", "triton"),
    ("iiwa_k1024_b1_pcg_jax", 1024, 1, "pcg", "jax"),
    ("iiwa_b1_direct", 50, 1, "direct", None),
    ("iiwa_b1024_direct", 50, 1024, "direct", None),
    ("iiwa_k4096_b1_direct", 4096, 1, "direct", None),
]


def _problem(K: int, batch: int, seed: int = 1):
    """IIWA-width problems: one random problem, right-hand sides varied per
    batch member (so per-problem iteration counts differ)."""
    from gato_tpu.formats import KKTBlocks
    from gato_tpu.problem import ProblemSpec
    from gato_tpu.testing import random_blocks

    spec = ProblemSpec(IIWA[0], IIWA[1], K)
    base = random_blocks(spec, seed=seed)
    if batch == 1:
        return spec, base
    rng = np.random.default_rng(seed)
    out = []
    for f, a in enumerate(base):
        a = np.broadcast_to(np.asarray(a), (batch,) + np.shape(a)).copy()
        if f >= 4:
            a *= (1.0 + 0.1 * rng.normal(size=a.shape)).astype(np.float32)
        out.append(a)
    return spec, KKTBlocks(*out)


def _caller(K, batch, method, backend, poly_degree, precond):
    """A zero-argument call of the public entry point that blocks until its
    result is ready."""
    import jax

    from gato_tpu.problem import Preconditioner, SolverOptions
    from gato_tpu.solver import solve, solve_batched

    spec, blocks = _problem(K, batch)
    blocks = jax.device_put(blocks)
    opts = SolverOptions(rho=1e-3, exit_tol=1e-6, max_iters=1000,
                         method=method, precond_poly_degree=poly_degree,
                         preconditioner=Preconditioner(precond))
    fn = solve if batch == 1 else solve_batched
    return lambda: jax.block_until_ready(
        fn(spec, blocks, opts, pcg_backend=backend))


def _times_ms(call, reps):
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        call()
        ts.append((time.perf_counter() - t0) * 1e3)
    return ts


def _first_call(call):
    t0 = time.perf_counter()
    res = call()
    return res, (time.perf_counter() - t0) * 1e3


def _entry(row, res, first_ms, reps, poly_degree, precond):
    name, K, batch, method, backend = row
    iters = np.asarray(res.iters)
    return {
        "row": name, "K": K, "batch": batch, "method": method,
        "pcg_backend": backend, "poly_degree": poly_degree,
        "precond": precond, "first_call_ms": first_ms, "reps": reps,
        "iters_min": int(iters.min()), "iters_max": int(iters.max()),
        "converged": bool(np.all(np.asarray(res.converged))),
    }


def time_row(row, reps, poly_degree=1, precond="symmetric_stair"):
    call = _caller(*row[1:], poly_degree, precond)
    res, first_ms = _first_call(call)
    ts = _times_ms(call, reps)
    entry = _entry(row, res, first_ms, reps, poly_degree, precond)
    entry.update(ms_median=float(np.median(ts)),
                 ms_p10=float(np.percentile(ts, 10)),
                 ms_p90=float(np.percentile(ts, 90)))
    return entry


def time_pair(a, b, reps, rounds, poly_degree=1, precond="symmetric_stair"):
    """Rows ``a`` and ``b`` (one shape, two backends), both compiled, then
    timed in ``rounds`` alternating rounds; each round is the median of
    ``reps`` calls."""
    calls = [_caller(*r[1:], poly_degree, precond) for r in (a, b)]
    firsts = [_first_call(c) for c in calls]
    per_round = ([], [])
    for i in range(rounds):
        for j in ((0, 1) if i % 2 == 0 else (1, 0)):
            per_round[j].append(float(np.median(_times_ms(calls[j], reps))))
    out = []
    for j, row in enumerate((a, b)):
        mine, other = per_round[j], per_round[1 - j]
        entry = _entry(row, *firsts[j], reps, poly_degree, precond)
        entry.update(ms_median=float(np.median(mine)), ms_rounds=mine,
                     rounds=rounds,
                     rounds_won=int(sum(x < y for x, y in zip(mine, other))))
        out.append(entry)
    return out


def _groups(rows):
    """Consecutive rows of one shape and method (a backend pair) as one
    group; every other row alone."""
    out, i = [], 0
    while i < len(rows):
        a = rows[i]
        b = rows[i + 1] if i + 1 < len(rows) else None
        if b is not None and a[1:4] == b[1:4]:
            out.append((a, b))
            i += 2
        else:
            out.append((a,))
            i += 1
    return out


def _ordered(rows):
    """Pairs (A, B) -> A, B, B, A; single rows once."""
    return [r for g in _groups(rows)
            for r in (g + g[::-1] if len(g) == 2 else g)]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", default="",
                    help="run only rows whose name contains one of these "
                         "comma-separated strings")
    ap.add_argument("--reps", type=int, default=30)
    ap.add_argument("--pairs", type=int, default=0,
                    help="time each backend pair in this many alternating "
                         "rounds of --reps calls (0: A, B, B, A once each)")
    ap.add_argument("--poly-degree", type=int, default=1)
    ap.add_argument("--precond", default="symmetric_stair",
                    help="a gato_tpu.problem.Preconditioner value")
    args = ap.parse_args(argv)

    card = card_name_and_power_limit()
    from gato_tpu import compile_cache

    compile_cache.enable()
    import jax

    dev = device_stamp()
    if dev["platform"] != "gpu":
        print(f"bench.py measures a GPU; the default device is "
              f"{dev['platform']!r}", file=sys.stderr)
        return 1
    peak_for(dev["kind"])  # an unknown card fails before any timing

    rows = [r for r in ROWS
            if any(p in r[0] for p in args.rows.split(","))]
    kw = dict(poly_degree=args.poly_degree, precond=args.precond)
    if args.pairs:
        entries = (e for g in _groups(rows) for e in (
            time_pair(*g, args.reps, args.pairs, **kw) if len(g) == 2
            else [time_row(g[0], args.reps, **kw)]))
    else:
        entries = (time_row(r, args.reps, **kw) for r in _ordered(rows))
    for entry in entries:
        K, batch, method = entry["K"], entry["batch"], entry["method"]
        if method == "direct":
            from gato_tpu.dispatch import choose_backend

            kind = "direct_" + choose_backend(
                "direct", None, dtype="float32", K=K)
        else:
            kind = "pcg"
        annotate_roofline(entry, IIWA[0], IIWA[1], K, kind, dev["kind"],
                          iters=entry["iters_max"], batch=batch,
                          poly_degree=args.poly_degree)
        entry["device"] = dev
        entry["card"] = card
        print(json.dumps(_jsonable(entry)), flush=True)
        jax.clear_caches()
    print(json.dumps({"rows": len(rows), "device": dev, "card": card}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

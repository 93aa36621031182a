"""Problem generators and oracles shared by tests and benchmarks.

Includes the reference's pendulum integration problem verbatim as test data
(test_pendulum_5.py:9-24 — this is the parity gate) and random trajectory-QP
generators shaped like the reference's default IIWA build (install.bash:6:
STATE_SIZE=14, CONTROL_SIZE=7, KNOT_POINTS=50) and the BASELINE.json configs.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .formats import KKTBlocks, blocks_to_dense_kkt
from .problem import ProblemSpec


@dataclasses.dataclass
class CSRProblem:
    """A KKT problem in the reference's raw-CSR API form."""

    spec: ProblemSpec
    G_row: list
    G_col: list
    G_val: list
    C_row: list
    C_col: list
    C_val: list
    g: list
    c: list


def pendulum_problem() -> CSRProblem:
    """The (2,1,5) pendulum KKT system from the reference integration test
    (test_pendulum_5.py:9-18), data reproduced as the parity fixture."""
    spec = ProblemSpec(state_size=2, control_size=1, knot_points=5)
    G_row = [0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14]
    G_col = [0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13]
    G_val = [1., 1., 0.1, 1., 1., 0.1, 1., 1., 0.1, 1., 1., 0.1, 100., 100.]
    C_row = [0, 1, 2, 5, 9, 12, 16, 19, 23, 26, 30]
    C_col = [0, 1, 0, 1, 3, 0, 1, 2, 4, 3, 4, 6, 3, 4, 5, 7, 6, 7, 9, 6, 7, 8,
             10, 9, 10, 12, 9, 10, 11, 13]
    C_val = [1., 1., -1., -0.1, 1., 0.981, -1., -0.1, 1., -1., -0.1, 1., 0.981,
             -1., -0.1, 1., -1., -0.1, 1., 0.981, -1., -0.1, 1., -1., -0.1, 1.,
             0.981, -1., -0.1, 1.]
    g = [-3.1416, 0., 0., -3.1416, 0., 0., -3.1416, 0., 0., -3.1416, 0., 0.,
         -314.159, 0.]
    c = [0.] * 10
    return CSRProblem(spec, G_row, G_col, G_val, C_row, C_col, C_val, g, c)


def random_blocks(
    spec: ProblemSpec,
    seed: int = 0,
    *,
    diag_G: bool = False,
    c_zero: bool = False,
    dtype=np.float32,
) -> KKTBlocks:
    """Random well-conditioned trajectory QP in block form.

    Q/R are SPD (random factor + diagonal shift); A approximates a
    discrete-dynamics Jacobian (-(I + dt*M), matching the sign convention the
    reference's packing produces for x_{k+1} - A x_k - B u_k = c).
    """
    rng = np.random.default_rng(seed)
    s, c, K = spec.state_size, spec.control_size, spec.knot_points

    def spd(n, count):
        if diag_G:
            d = rng.uniform(0.5, 2.0, size=(count, n))
            out = np.zeros((count, n, n))
            out[:, np.arange(n), np.arange(n)] = d
            return out
        F = rng.normal(size=(count, n, n)) * 0.3
        return F @ F.transpose(0, 2, 1) + np.eye(n)[None] * np.linspace(
            1.0, 2.0, count
        )[:, None, None]

    Q = spd(s, K)
    R = spd(c, K - 1)
    dt = 0.1
    A = -(np.eye(s)[None] + dt * rng.normal(size=(K - 1, s, s)) * 0.2)
    B = -dt * rng.normal(size=(K - 1, s, c))
    q = rng.normal(size=(K, s))
    r = rng.normal(size=(K - 1, c))
    cc = np.zeros((K, s)) if c_zero else rng.normal(size=(K, s)) * 0.1
    return KKTBlocks(*(x.astype(dtype) for x in (Q, R, A, B, q, r, cc)))


def blocks_to_csr(spec: ProblemSpec, blocks: KKTBlocks) -> CSRProblem:
    """Emit a block problem in the reference's raw-CSR API form (dense blocks
    stored explicitly — exercises the full packing path)."""
    s, c, K = spec.state_size, spec.control_size, spec.knot_points
    sc = s + c
    nz, nl = spec.nz, spec.nl

    # G: block diagonal [Q_0, R_0, ..., Q_{K-1}]
    G_row, G_col, G_val = [0], [], []
    for row in range(nz):
        k, i = row // sc, row % sc
        if i < s:
            cols = range(k * sc, k * sc + s)
            vals = blocks.Q[k][i]
        else:
            cols = range(k * sc + s, (k + 1) * sc)
            vals = blocks.R[k][i - s]
        G_col.extend(cols)
        G_val.extend(map(float, vals))
        G_row.append(len(G_col))

    # C: identity block then [A_k B_k I] rows
    C_row, C_col, C_val = [0], [], []
    for row in range(nl):
        if row < s:
            C_col.append(row)
            C_val.append(1.0)
        else:
            k, i = row // s - 1, row % s
            C_col.extend(range(k * sc, (k + 1) * sc))
            C_val.extend(map(float, blocks.A[k][i]))
            C_val.extend(map(float, blocks.B[k][i]))
            C_col.append((k + 1) * sc + i)
            C_val.append(1.0)
        C_row.append(len(C_col))

    g = np.zeros(nz)
    for k in range(K):
        g[k * sc : k * sc + s] = blocks.q[k]
        if k < K - 1:
            g[k * sc + s : (k + 1) * sc] = blocks.r[k]
    return CSRProblem(
        spec,
        G_row, G_col, G_val,
        C_row, C_col, C_val,
        list(map(float, g)),
        list(map(float, np.asarray(blocks.c).reshape(-1))),
    )


def dense_oracle(spec: ProblemSpec, blocks: KKTBlocks, rho: float = 0.0):
    """Exact (lam, dz_flat) via the dense saddle-point solve — the NumPy oracle
    the reference test uses (test_pendulum_5.py:28-34), generalized to include
    rho on the G diagonal."""
    KKT, rhs = blocks_to_dense_kkt(spec, blocks, rho=rho)
    x = np.linalg.solve(KKT.astype(np.float64), rhs.astype(np.float64))
    dz = x[: spec.nz]
    lam = x[spec.nz :]
    return lam, dz


def kkt_sparse(spec: ProblemSpec, blocks: KKTBlocks, rho: float = 0.0):
    """The saddle-point matrix of :func:`formats.blocks_to_dense_kkt` as a
    float64 ``scipy.sparse`` CSC matrix, with its rhs — for horizons where
    the dense matrix does not fit (K=1024 at the IIWA width is already
    ~10 GB dense)."""
    import scipy.sparse as sp

    s, c, K = spec.state_size, spec.control_size, spec.knot_points
    sc = s + c
    nz, nl = spec.nz, spec.nl
    Q = np.asarray(blocks.Q, np.float64) + rho * np.eye(s)
    R = np.asarray(blocks.R, np.float64) + rho * np.eye(c)
    rows, cols, vals = [], [], []

    def put(r0, c0, M):
        """Scatter a stack of blocks M (n, a, b) at offsets r0/c0 (n,)."""
        n, a, b = M.shape
        ii, jj = np.meshgrid(np.arange(a), np.arange(b), indexing="ij")
        rows.append((r0[:, None, None] + ii).ravel())
        cols.append((c0[:, None, None] + jj).ravel())
        vals.append(M.ravel())

    k = np.arange(K)
    ki = np.arange(K - 1)
    put(k * sc, k * sc, Q)                                   # G: Q blocks
    put(ki * sc + s, ki * sc + s, R)                         # G: R blocks
    eye_s = np.broadcast_to(np.eye(s), (K, s, s))
    Cr = nz + (ki + 1) * s                                   # C rows, k >= 1
    put(np.array([nz]), np.array([0]), eye_s[:1])            # C: x_0 = ...
    put(Cr, ki * sc, np.asarray(blocks.A, np.float64))
    put(Cr, ki * sc + s, np.asarray(blocks.B, np.float64))
    put(Cr, (ki + 1) * sc, eye_s[1:])
    # C^T blocks: the transposes, mirrored across the diagonal.
    put(np.array([0]), np.array([nz]), eye_s[:1])
    put(ki * sc, Cr, np.swapaxes(np.asarray(blocks.A, np.float64), 1, 2))
    put(ki * sc + s, Cr, np.swapaxes(np.asarray(blocks.B, np.float64), 1, 2))
    put((ki + 1) * sc, Cr, eye_s[1:])
    n = nz + nl
    KKT = sp.csc_matrix((np.concatenate(vals),
                         (np.concatenate(rows), np.concatenate(cols))),
                        shape=(n, n))
    g = np.zeros(nz)
    g_knots = g[: (K - 1) * sc].reshape(K - 1, sc)   # a view into g
    g_knots[:, :s] = np.asarray(blocks.q, np.float64)[:-1]
    g_knots[:, s:] = np.asarray(blocks.r, np.float64)
    g[(K - 1) * sc:] = np.asarray(blocks.q, np.float64)[-1]
    rhs = np.concatenate([g, np.asarray(blocks.c, np.float64).reshape(-1)])
    return KKT, rhs


def sparse_oracle(spec: ProblemSpec, blocks: KKTBlocks, rho: float = 0.0):
    """:func:`dense_oracle` for long horizons: the same saddle system, built
    sparse (:func:`kkt_sparse`) and solved exactly by scipy's sparse LU in
    float64."""
    from scipy.sparse.linalg import spsolve

    KKT, rhs = kkt_sparse(spec, blocks, rho=rho)
    x = spsolve(KKT, rhs)
    return x[spec.nz:], x[: spec.nz]

"""CSR ingestion: sparse KKT inputs -> per-knot block arrays.

The reference converts CSR G and C into a packed per-knot dense layout on the GPU
(``csr_to_custom_G`` / ``csr_to_custom_C``, gato_schur.cuh:675-756).  Here the
packing runs on the host in vectorized NumPy (an optional C++ fast path lives in
``gato_tpu.native``), producing the struct-of-blocks layout the solver
consumes:

  * ``Q``: (K, s, s)    per-knot state cost Hessians
  * ``R``: (K-1, c, c)  per-interval control cost Hessians (no control at knot K-1)
  * ``A``: (K-1, s, s)  constraint-Jacobian state blocks, packed exactly as the
                        reference does — i.e. the raw CSR values, which for a
                        dynamics constraint  x_{k+1} - f(x_k,u_k) = c  are the
                        *negated* dynamics Jacobians
  * ``B``: (K-1, s, c)  constraint-Jacobian control blocks
  * ``q``: (K, s), ``r``: (K-1, c)  gradient segments
  * ``c``: (K, s)       constraint residual per knot

Semantics notes vs the reference:

* The first ``s`` rows of C (the initial-condition identity block) are skipped,
  as are entries right of the current knot's column block — the implicit +I on
  x_{k+1} (reference: gato_schur.cuh:725,735).
* rho regularization is NOT applied here; it is added to the Q/R diagonals at
  assembly time so rho sweeps don't require repacking.  (The reference adds rho
  during packing, but only where the CSR pattern contains an explicit diagonal
  entry — gato_schur.cuh:697,700.  Adding it at assembly regularizes the full
  diagonal unconditionally, which is the intended semantics of rho; for any
  Hessian with a stored diagonal the two coincide.)
* CSR entries that fall outside the trajectory-QP sparsity pattern (cross
  state/control terms, off-block entries) are rejected with ``ValueError``.
  The reference would silently corrupt adjacent memory (the packing index
  arithmetic in gato_schur.cuh:697-700 overflows the Q slot for such entries).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

from .problem import ProblemSpec


class KKTBlocks(NamedTuple):
    """Struct-of-blocks KKT data (all NumPy or JAX arrays, leading knot axis)."""

    Q: np.ndarray  # (K, s, s)
    R: np.ndarray  # (K-1, c, c)
    A: np.ndarray  # (K-1, s, s)
    B: np.ndarray  # (K-1, s, c)
    q: np.ndarray  # (K, s)
    r: np.ndarray  # (K-1, c)
    c: np.ndarray  # (K, s)


def check_block_shapes(spec: ProblemSpec, blocks: KKTBlocks,
                       lead: tuple = ()) -> None:
    """Validate EVERY KKTBlocks field against ``spec`` (plus optional leading
    batch/time axes).  The kernel path zero-pads whatever it is given
    (kernels/pcg_triton.py pads to its tiles), so a malformed field — e.g. a
    (K-1)-row ``c``, an easy slip since ``r`` IS (K-1, c) — must be rejected
    at the API surface, not padded into a silently-wrong system."""
    K, s, c = spec.knot_points, spec.state_size, spec.control_size
    lead = tuple(lead)
    expect = {
        "Q": lead + (K, s, s), "R": lead + (K - 1, c, c),
        "A": lead + (K - 1, s, s), "B": lead + (K - 1, s, c),
        "q": lead + (K, s), "r": lead + (K - 1, c), "c": lead + (K, s),
    }
    for name, arr in zip(expect, blocks):
        if tuple(arr.shape) != expect[name]:
            raise ValueError(
                f"blocks.{name} shape {tuple(arr.shape)} does not match "
                f"{expect[name]} for {spec}")


def _csr_to_coo(indptr: np.ndarray, indices: np.ndarray, data: np.ndarray):
    """Expand CSR to (rows, cols, vals) without scipy."""
    indptr = np.asarray(indptr, dtype=np.int64)
    counts = np.diff(indptr)
    rows = np.repeat(np.arange(len(counts), dtype=np.int64), counts)
    return rows, np.asarray(indices, dtype=np.int64), np.asarray(data)


# Use the C++ packer (gato_tpu.native / csrc) when built; the NumPy path below
# is the always-available fallback and the semantics oracle.
USE_NATIVE = True


def pack_G(
    spec: ProblemSpec,
    G_indptr,
    G_indices,
    G_data,
    dtype=np.float32,
):
    """Pack the CSR cost Hessian G into (Q, R) block arrays.

    Reference semantics: ``csr_to_custom_G`` (gato_schur.cuh:675-704), minus the
    in-pack rho add (see module docstring).
    """
    if USE_NATIVE and dtype == np.float32:
        from . import native

        out = native.pack_G_native(spec, G_indptr, G_indices, G_data)
        if out is not None:
            return out
    s, c, K = spec.state_size, spec.control_size, spec.knot_points
    sc = s + c
    rows, cols, vals = _csr_to_coo(G_indptr, G_indices, G_data)

    nz = spec.nz
    if rows.size and (rows.max() >= nz or cols.max() >= nz):
        raise ValueError(f"G entry out of range for nz={nz}")
    if np.any(rows // sc != cols // sc):
        raise ValueError("G has entries coupling different knot points; the "
                         "trajectory-QP Hessian must be block-diagonal per knot")

    knot = rows // sc
    i = rows % sc
    j = cols % sc
    in_state = (i < s) & (j < s)
    in_ctrl = (i >= s) & (j >= s)
    if not np.all(in_state | in_ctrl):
        raise ValueError("G has state-control cross terms; the reference layout "
                         "supports only block-diagonal [Q_k, R_k] Hessians")

    Q = np.zeros((K, s, s), dtype=dtype)
    R = np.zeros((K - 1, c, c), dtype=dtype)
    m = in_state
    Q[knot[m], i[m], j[m]] = vals[m].astype(dtype)
    m = in_ctrl
    if np.any(knot[m] >= K - 1):
        raise ValueError("G has a control block at the final knot (the final knot "
                         "has no control)")
    R[knot[m], i[m] - s, j[m] - s] = vals[m].astype(dtype)
    return Q, R


def pack_C(
    spec: ProblemSpec,
    C_indptr,
    C_indices,
    C_data,
    dtype=np.float32,
):
    """Pack the CSR constraint Jacobian C into (A, B) block arrays.

    Reference semantics: ``csr_to_custom_C`` (gato_schur.cuh:707-743): skip the
    first ``s`` rows (initial-condition identity) and any entry whose column
    block lies right of the row's interval (the implicit +I on x_{k+1}).
    """
    if USE_NATIVE and dtype == np.float32:
        from . import native

        out = native.pack_C_native(spec, C_indptr, C_indices, C_data)
        if out is not None:
            return out
    s, c, K = spec.state_size, spec.control_size, spec.knot_points
    sc = s + c
    rows, cols, vals = _csr_to_coo(C_indptr, C_indices, C_data)

    keep = rows >= s
    rows, cols, vals = rows[keep], cols[keep], vals[keep]
    k = rows // s - 1  # interval index
    cb = cols // sc
    if np.any(cb > k + 1):
        # Only column block k+1 (the implicit +I on x_{k+1}) is skippable;
        # anything further right is out-of-pattern garbage and must be a
        # hard error (module docstring contract), not a silent drop.
        raise ValueError("C has entries right of the x_{k+1} identity "
                         "block; only block-bidiagonal constraint Jacobians "
                         "are supported")
    keep = cb <= k  # drop the identity block on x_{k+1}
    rows, cols, vals, k = rows[keep], cols[keep], vals[keep], k[keep]
    if np.any(cols // sc != k):
        raise ValueError("C has entries left of the current interval's column "
                         "block; only block-bidiagonal constraint Jacobians are "
                         "supported")

    i = rows % s
    j = cols % sc
    A = np.zeros((K - 1, s, s), dtype=dtype)
    B = np.zeros((K - 1, s, c), dtype=dtype)
    m = j < s
    A[k[m], i[m], j[m]] = vals[m].astype(dtype)
    m = ~m
    B[k[m], i[m], j[m] - s] = vals[m].astype(dtype)
    return A, B


def pack_vectors(spec: ProblemSpec, g, c_vec, dtype=np.float32):
    """Split the interleaved gradient g = [q_0,r_0,q_1,r_1,...,q_{K-1}] and the
    constraint residual c into per-knot segments.

    Reference: the assembly kernel reads g at strides of STATES_S_CONTROLS
    (gato_schur.cuh:194-196) and c at strides of STATE_SIZE (gato_schur.cuh:312).
    """
    s, c, K = spec.state_size, spec.control_size, spec.knot_points
    sc = s + c
    g = np.asarray(g, dtype=dtype)
    c_vec = np.asarray(c_vec, dtype=dtype)
    if g.shape != (spec.nz,):
        raise ValueError(f"g must have shape ({spec.nz},), got {g.shape}")
    if c_vec.shape != (spec.nl,):
        raise ValueError(f"c must have shape ({spec.nl},), got {c_vec.shape}")
    gq = np.zeros((K, s), dtype=dtype)
    gr = np.zeros((K - 1, c), dtype=dtype)
    for kk in range(K - 1):
        gq[kk] = g[kk * sc : kk * sc + s]
        gr[kk] = g[kk * sc + s : (kk + 1) * sc]
    gq[K - 1] = g[(K - 1) * sc :]
    return gq, gr, c_vec.reshape(K, s)


def pack_kkt(
    spec: ProblemSpec,
    G_indptr, G_indices, G_data,
    C_indptr, C_indices, C_data,
    g, c_vec,
    dtype=np.float32,
) -> KKTBlocks:
    """Full CSR -> KKTBlocks ingestion (the reference's gato_convert_kkt_format,
    gato_schur.cuh:745-756, plus the vector splits)."""
    Q, R = pack_G(spec, G_indptr, G_indices, G_data, dtype)
    A, B = pack_C(spec, C_indptr, C_indices, C_data, dtype)
    q, r, cc = pack_vectors(spec, g, c_vec, dtype)
    return KKTBlocks(Q=Q, R=R, A=A, B=B, q=q, r=r, c=cc)


def pack_kkt_sparse(
    spec: ProblemSpec, G, C, g, c_vec, dtype=np.float32
) -> KKTBlocks:
    """Convenience ingestion from scipy.sparse matrices (or any object with
    CSR ``indptr``/``indices``/``data`` attributes, converted via ``tocsr``
    when available).

    The reference API takes raw CSR index arrays (gpu_library.cu:85-87);
    users who already hold ``scipy.sparse`` operators can skip the manual
    unpacking."""
    if hasattr(G, "tocsr"):
        G = G.tocsr()
    if hasattr(C, "tocsr"):
        C = C.tocsr()
    for name, M in (("G", G), ("C", C)):
        if not all(hasattr(M, a) for a in ("indptr", "indices", "data")):
            raise TypeError(
                f"{name} must be a scipy.sparse matrix or expose CSR "
                "indptr/indices/data attributes"
            )
    return pack_kkt(spec, G.indptr, G.indices, G.data,
                    C.indptr, C.indices, C.data, g, c_vec, dtype)


def interleave_dz(spec: ProblemSpec, dz_x: np.ndarray, dz_u: np.ndarray) -> np.ndarray:
    """Merge (K,s) state steps and (K-1,c) control steps into the flat
    [dz_x0, dz_u0, dz_x1, ..., dz_x_{K-1}] layout the reference returns
    (gpu_library.cu:225-228)."""
    s, c, K = spec.state_size, spec.control_size, spec.knot_points
    out = np.zeros(spec.nz, dtype=dz_x.dtype)
    sc = s + c
    for k in range(K - 1):
        out[k * sc : k * sc + s] = dz_x[k]
        out[k * sc + s : (k + 1) * sc] = dz_u[k]
    out[(K - 1) * sc :] = dz_x[K - 1]
    return out


def blocks_to_dense_kkt(spec: ProblemSpec, blocks: KKTBlocks, rho: float = 0.0):
    """Rebuild the dense saddle-point matrix [[G+rho*I, C^T], [C, 0]] and rhs
    [g; c] from block form.  Test oracle only (the integration test builds this
    from the raw CSR instead, mirroring test_pendulum_5.py:28-34)."""
    s, c, K = spec.state_size, spec.control_size, spec.knot_points
    sc = s + c
    nz, nl = spec.nz, spec.nl
    G = np.zeros((nz, nz))
    C = np.zeros((nl, nz))
    g = np.zeros(nz)
    for k in range(K):
        o = k * sc
        G[o : o + s, o : o + s] = blocks.Q[k] + rho * np.eye(s)
        g[o : o + s] = blocks.q[k]
        if k < K - 1:
            G[o + s : o + sc, o + s : o + sc] = blocks.R[k] + rho * np.eye(c)
            g[o + s : o + sc] = blocks.r[k]
    C[0:s, 0:s] = np.eye(s)
    for k in range(K - 1):
        ro = (k + 1) * s
        co = k * sc
        C[ro : ro + s, co : co + s] = blocks.A[k]
        C[ro : ro + s, co + s : co + sc] = blocks.B[k]
        C[ro : ro + s, co + sc : co + sc + s] = np.eye(s)
    KKT = np.block([[G, C.T], [C, np.zeros((nl, nl))]])
    rhs = np.concatenate([g, np.asarray(blocks.c).reshape(-1)])
    return KKT, rhs

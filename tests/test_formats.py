"""CSR packing oracles: pack CSR -> blocks -> dense must reproduce the CSR
matrices (on the supported sparsity pattern), mirroring the semantics of
csr_to_custom_G / csr_to_custom_C (gato_schur.cuh:675-756)."""

import numpy as np
import pytest
from scipy import sparse

from gato_tpu import ProblemSpec
from gato_tpu.formats import blocks_to_dense_kkt, pack_kkt, interleave_dz
from gato_tpu.testing import blocks_to_csr, pendulum_problem, random_blocks


@pytest.mark.parametrize("spec,seed", [
    (ProblemSpec(2, 1, 5), 0),
    (ProblemSpec(3, 2, 7), 1),
    (ProblemSpec(14, 7, 50), 2),
])
def test_pack_roundtrip(spec, seed):
    blocks = random_blocks(spec, seed=seed)
    prob = blocks_to_csr(spec, blocks)
    packed = pack_kkt(spec, prob.G_row, prob.G_col, prob.G_val,
                      prob.C_row, prob.C_col, prob.C_val, prob.g, prob.c)
    for a, b, name in zip(packed, blocks, packed._fields):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-6, err_msg=name)


def test_pendulum_pack_matches_scipy_dense():
    prob = pendulum_problem()
    spec = prob.spec
    blocks = pack_kkt(spec, prob.G_row, prob.G_col, prob.G_val,
                      prob.C_row, prob.C_col, prob.C_val, prob.g, prob.c)
    KKT, rhs = blocks_to_dense_kkt(spec, blocks, rho=0.0)

    G = sparse.csr_matrix((prob.G_val, prob.G_col, prob.G_row)).todense()
    C = sparse.csr_matrix((prob.C_val, prob.C_col, prob.C_row)).todense()
    A = np.block([[G, C.T], [C, np.zeros((C.shape[0], C.shape[0]))]])
    np.testing.assert_allclose(KKT, A, atol=1e-6)
    np.testing.assert_allclose(rhs, np.concatenate([prob.g, prob.c]), atol=1e-6)


def test_pack_rejects_cross_terms():
    spec = ProblemSpec(2, 1, 3)
    # G entry coupling state row 0 with control col 2 (same knot): unsupported.
    G_row = [0, 1] + [1] * (spec.nz - 1)
    G_col = [2]
    G_val = [1.0]
    from gato_tpu.formats import pack_G

    with pytest.raises(ValueError):
        pack_G(spec, G_row, G_col, G_val)


def test_pack_rejects_cross_knot():
    spec = ProblemSpec(2, 1, 3)
    G_row = [0, 1] + [1] * (spec.nz - 1)
    G_col = [4]  # knot-1 column on a knot-0 row
    G_val = [1.0]
    from gato_tpu.formats import pack_G

    with pytest.raises(ValueError):
        pack_G(spec, G_row, G_col, G_val)


def test_interleave_dz_layout():
    spec = ProblemSpec(2, 1, 3)
    dz_x = np.array([[1, 2], [4, 5], [7, 8]], dtype=np.float32)
    dz_u = np.array([[3], [6]], dtype=np.float32)
    np.testing.assert_array_equal(
        interleave_dz(spec, dz_x, dz_u),
        np.array([1, 2, 3, 4, 5, 6, 7, 8], dtype=np.float32),
    )


def test_pack_kkt_sparse_matches_raw_csr():
    """scipy.sparse ingestion (pack_kkt_sparse) equals the raw-CSR path."""
    import scipy.sparse as sp

    from gato_tpu.formats import pack_kkt, pack_kkt_sparse
    from gato_tpu.problem import ProblemSpec
    from gato_tpu.testing import blocks_to_csr, random_blocks

    spec = ProblemSpec(4, 2, 6)
    p = blocks_to_csr(spec, random_blocks(spec, seed=5))
    G = sp.csr_matrix((p.G_val, p.G_col, p.G_row))
    C = sp.csr_matrix((p.C_val, p.C_col, p.C_row))
    ref = pack_kkt(spec, p.G_row, p.G_col, p.G_val,
                   p.C_row, p.C_col, p.C_val, p.g, p.c)
    got = pack_kkt_sparse(spec, G, C, p.g, p.c)
    for a, b in zip(ref, got):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    # COO input is converted via tocsr
    got2 = pack_kkt_sparse(spec, G.tocoo(), C.tocoo(), p.g, p.c)
    for a, b in zip(ref, got2):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))

    with pytest.raises(TypeError, match="scipy.sparse"):
        pack_kkt_sparse(spec, object(), C, p.g, p.c)


@pytest.mark.parametrize("use_native", [False, True])
def test_pack_C_rejects_entries_right_of_identity_block(use_native,
                                                        monkeypatch):
    """Only column block k+1 (the implicit +I on x_{k+1}) is skippable; an
    entry further right is out-of-pattern garbage and must raise (module
    docstring contract) on BOTH the NumPy and native paths — previously it
    was silently dropped."""
    from gato_tpu import formats

    monkeypatch.setattr(formats, "USE_NATIVE", use_native)
    spec = ProblemSpec(2, 1, 3)  # s=2, c=1, K=3 -> sc=3, nl=6, nz=8
    indptr = np.array([0, 1, 2, 4, 5, 6, 7])
    indices = np.array([0, 1, 0, 6, 1, 3, 4])  # col 6 = block 2 on row k=0
    data = np.array([1.0, 1.0, 1.0, 99.0, 1.0, 1.0, 1.0], np.float32)
    with pytest.raises(ValueError, match="right of the x_.k.1. identity"):
        formats.pack_C(spec, indptr, indices, data)


@pytest.mark.parametrize("use_native", [False, True])
def test_pack_C_still_skips_identity_block(use_native, monkeypatch):
    """The legitimate +I entries at column block k+1 (cols sc*(k+1)+i) are
    skipped, not errors, on both paths."""
    from gato_tpu import formats

    monkeypatch.setattr(formats, "USE_NATIVE", use_native)
    spec = ProblemSpec(2, 1, 3)
    # Rows 2,3 (interval 0): A entries at cols 0/1 plus the identity at
    # cols 3,4 (= sc*1 + i); rows 4,5 (interval 1): A at cols 3/4, identity
    # at cols 6,7.
    indptr = np.array([0, 1, 2, 4, 6, 8, 10])
    indices = np.array([0, 1, 0, 3, 1, 4, 3, 6, 4, 7])
    data = np.ones(10, np.float32)
    A, B = formats.pack_C(spec, indptr, indices, data)
    assert A[0, 0, 0] == 1.0 and A[0, 1, 1] == 1.0
    assert A[1, 0, 0] == 1.0 and A[1, 1, 1] == 1.0
    assert np.all(np.asarray(B) == 0.0)


@pytest.mark.parametrize("spec,rho", [(ProblemSpec(2, 1, 5), 0.0),
                                      (ProblemSpec(14, 7, 6), 1e-3),
                                      (ProblemSpec(3, 5, 2), 1e-2)])
def test_sparse_oracle_matches_dense(spec, rho):
    """The sparse float64 oracle builds the same saddle system as the dense
    one (entry for entry) and returns the same solution."""
    from gato_tpu.testing import dense_oracle, kkt_sparse, sparse_oracle

    blocks = random_blocks(spec, seed=7)
    KKT, rhs = blocks_to_dense_kkt(spec, blocks, rho=rho)
    KKT_s, rhs_s = kkt_sparse(spec, blocks, rho=rho)
    np.testing.assert_array_equal(KKT_s.toarray(), KKT)
    np.testing.assert_array_equal(rhs_s, rhs)
    lam_d, dz_d = dense_oracle(spec, blocks, rho=rho)
    lam_s, dz_s = sparse_oracle(spec, blocks, rho=rho)
    np.testing.assert_allclose(lam_s, lam_d, rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(dz_s, dz_d, rtol=1e-9, atol=1e-9)

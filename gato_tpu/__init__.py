"""gato_tpu: a JAX trajectory-QP KKT linear-system solver.

A ground-up JAX/XLA/Pallas rebuild of the capabilities of
MiloniAtal/gato-python (a single-GPU cooperative-CUDA PCG solver for the
block-tridiagonal Schur complement of a trajectory-optimization KKT system).

Public surface:
  * :func:`linsys_solve`  — reference-identical entry point (lists in/out)
  * :func:`solve`, :func:`solve_batched` — idiomatic structured API
  * :func:`pack`, :func:`solve_packed` — packed-input serving API (inputs
    staged on the device once; :mod:`gato_tpu.packed`)
  * :class:`ProblemSpec`, :class:`SolverOptions`, :class:`Preconditioner`
  * :mod:`gato_tpu.formats` — CSR ingestion / block packing
  * :mod:`gato_tpu.dispatch` — the one place that chooses a backend
  * :mod:`gato_tpu.kernels` — the Triton PCG kernel (Pallas, CUDA GPUs)
  * :mod:`gato_tpu.parallel` — shard_map multi-device paths
"""

from .api import infer_spec, linsys_solve
from .diff import kkt_solve, kkt_solve_batched
from .direct import btd_solve
from .formats import KKTBlocks, pack_kkt, pack_kkt_sparse
from .mpc import solve_sequence, solve_sequence_batched
from .packed import (PackedKKT, PackedKKTSequence, PackedSequenceResult,
                     PackedSolveResult, pack, pack_sequence, solve_packed,
                     solve_packed_sequence, update_vectors)
from .problem import DEFAULT_OPTIONS, Preconditioner, ProblemSpec, SolverOptions
from .solver import SolveResult, solve, solve_batched

__version__ = "0.1.0"

__all__ = [
    "linsys_solve",
    "infer_spec",
    "solve",
    "solve_batched",
    "solve_sequence",
    "solve_sequence_batched",
    "pack",
    "solve_packed",
    "pack_sequence",
    "solve_packed_sequence",
    "update_vectors",
    "PackedKKT",
    "PackedSolveResult",
    "PackedKKTSequence",
    "PackedSequenceResult",
    "btd_solve",
    "kkt_solve",
    "kkt_solve_batched",
    "SolveResult",
    "KKTBlocks",
    "pack_kkt",
    "pack_kkt_sparse",
    "ProblemSpec",
    "SolverOptions",
    "Preconditioner",
    "DEFAULT_OPTIONS",
]

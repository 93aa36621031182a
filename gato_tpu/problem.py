"""Problem specification and solver options.

The reference (MiloniAtal/gato-python) bakes the problem shape into the binary as
compile-time constants (``-DSTATE_SIZE -DCONTROL_SIZE -DKNOT_POINTS``, see
CMakeLists.txt:18, install.bash:6,16); a shape change is a full
``nvcc`` rebuild.  Here the shape is a static argument of ``jax.jit`` — a shape
change is a retrace, not a rebuild (reference: include/gato_defines.h:32-37 derives
all buffer sizes from those three constants; here :class:`ProblemSpec` plays that
role and is hashable so it can be a ``static_argnums`` jit argument).

Algorithm flags that the reference fixes at compile time in gato_defines.h:9-11
(``BLOCK_J_PRECON``, ``SS_PRECON``, ``PRECONDITIONER_BANDWIDTH``) are runtime
options here (:class:`SolverOptions.preconditioner`).
"""

from __future__ import annotations

import dataclasses
import enum


class Preconditioner(enum.Enum):
    """Preconditioner family for the block-tridiagonal Schur system.

    Mirrors the reference's compile-time selectors (gato_defines.h:9-11):

    * ``JACOBI``     — scalar Jacobi, 1/diag(S)     (reference: neither flag set,
      gato_schur.cuh:423-429)
    * ``BLOCK_JACOBI`` — block Jacobi, theta_k^{-1} on the main diagonal
      (reference: ``BLOCK_J_PRECON``, gato_schur.cuh:407-422)
    * ``SYMMETRIC_STAIR`` — bandwidth-3 approximate inverse: block-Jacobi main
      diagonal plus off-diagonals -theta_k^{-1} phi_k theta_{k-1}^{-1}
      (reference: ``SS_PRECON``, gato_schur.cuh:496-671).  This is the
      reference's default build (both flags on => SS wins).
    """

    JACOBI = "jacobi"
    BLOCK_JACOBI = "block_jacobi"
    SYMMETRIC_STAIR = "symmetric_stair"


@dataclasses.dataclass(frozen=True)
class ProblemSpec:
    """Static trajectory-QP shape: the analog of the reference's #defines.

    Attributes:
      state_size:   per-knot state dimension (reference ``STATE_SIZE``).
      control_size: per-knot control dimension (reference ``CONTROL_SIZE``).
      knot_points:  trajectory length (reference ``KNOT_POINTS``).
    """

    state_size: int
    control_size: int
    knot_points: int

    def __post_init__(self):
        if self.state_size < 1 or self.control_size < 1 or self.knot_points < 2:
            raise ValueError(
                f"invalid ProblemSpec {self}: need state_size>=1, control_size>=1,"
                " knot_points>=2"
            )

    # Derived sizes (reference: gato_defines.h:32-37).
    @property
    def nx(self) -> int:
        return self.state_size

    @property
    def nu(self) -> int:
        return self.control_size

    @property
    def nk(self) -> int:
        return self.knot_points

    @property
    def nz(self) -> int:
        """Primal dimension: K*(nx+nu) - nu (no control at the last knot)."""
        return (self.state_size + self.control_size) * self.knot_points - self.control_size

    @property
    def nl(self) -> int:
        """Dual (multiplier) dimension: K*nx — one constraint block per knot."""
        return self.state_size * self.knot_points


@dataclasses.dataclass(frozen=True)
class SolverOptions:
    """Runtime solver options.

    These were per-call arguments in the reference API (gpu_library.cu:85-87:
    ``exit_tol``, ``max_iters``, ``warm_start``, ``rho``) plus the compile-time
    preconditioner flags.

    Attributes:
      exit_tol:  PCG termination threshold on |r.Pinv.r| (the preconditioned
        residual dot product — NOT a norm; this matches the reference's exit
        test at gato_pcg.cuh:404).
      max_iters: PCG iteration cap.  On exhaustion the reported iteration count
        equals ``max_iters`` (reference initializes the count to maxIters,
        gato_pcg.cuh:311-313).
      warm_start: start PCG from the supplied lambda.  NOTE: the reference
        accepts this flag and copies lambda to the device (gpu_library.cu:46-47)
        but its kernels unconditionally reset lambda to zero
        (gato_pcg.cuh:296-304), so warm starting is dead code there.  Here it
        actually works; the default (False) reproduces reference behavior.
      rho: Tikhonov regularizer added to the diagonal of the cost Hessian blocks
        before condensation (reference: gato_schur.cuh:697,700).
      preconditioner: see :class:`Preconditioner`.
      method: 'pcg' (the reference's algorithm) or 'direct' (exact block
        Thomas elimination, see direct.py — no reference equivalent; ignores
        exit_tol/max_iters/warm_start/preconditioner and reports iters=0).
      precond_poly_degree: polynomial composition of the preconditioner —
        PCG applies  M_d r = P sum_{i<d} (I - S P)^i r  instead of P r
        (Horner form, pcg.py).  Degree 1 (default) is the reference's plain
        application; degree d costs 2(d-1) extra block-tridiag matvecs per
        iteration and cuts iterations (measured on IIWA (14,7,50), rho=1e-3,
        tol=1e-6: 27 -> 19 -> 16 for d=1,2,3).  An extension in the spirit of
        the reference's compile-time PRECONDITIONER_BANDWIDTH knob
        (gato_defines.h:11) — wider effective bandwidth without storing
        wider-band blocks.  Note the composed operator is SPD for any d when
        the spectrum of P S stays below 2 (true for the stair preconditioner
        on these systems); degree 1 never has the caveat.
      dtype: compute dtype; the reference is float32 throughout.  'float64'
        works end to end (oracle agreement to ~1e-14) but requires JAX's x64
        mode (``jax.enable_x64(True)`` / ``jax.config.update('jax_enable_x64',
        True)``) — without it JAX silently truncates to f32.
    """

    exit_tol: float = 1e-6
    max_iters: int = 100
    warm_start: bool = False
    rho: float = 0.0
    preconditioner: Preconditioner = Preconditioner.SYMMETRIC_STAIR
    method: str = "pcg"
    precond_poly_degree: int = 1
    dtype: str = "float32"

    def __post_init__(self):
        if self.method not in ("pcg", "direct"):
            raise ValueError(f"method must be 'pcg' or 'direct', got "
                             f"{self.method!r}")
        if not isinstance(self.preconditioner, Preconditioner):
            # Accept the enum's string values too — the dp APIs
            # (parallel.sharded) take exactly these strings, so
            # SolverOptions(preconditioner='symmetric_stair') is a natural
            # spelling; an unknown name raises here (clear, at construction)
            # instead of as an AttributeError deep in the solve.
            object.__setattr__(self, "preconditioner",
                               Preconditioner(self.preconditioner))
        if not isinstance(self.precond_poly_degree, int) \
                or self.precond_poly_degree < 1:
            # Degree 0 would be the empty Horner sum (M_0 = 0, meaningless)
            # and would otherwise silently run as degree 1.
            raise ValueError(
                f"precond_poly_degree must be an int >= 1, got "
                f"{self.precond_poly_degree!r}"
            )


DEFAULT_OPTIONS = SolverOptions()

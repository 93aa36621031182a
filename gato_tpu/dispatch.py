"""The one place that chooses how a solve runs.

Every entry point (solver, mpc, diff, packed, parallel) asks
:func:`choose_backend`, with the shapes it is about to run, before it traces:

* ``method='pcg'``: ``'jax'`` (pcg.pcg, XLA's ``lax.while_loop``) or
  ``'triton'`` (kernels/pcg_triton.py, the whole loop in one Pallas program
  per problem);
* ``method='direct'``: ``'thomas'`` (direct.btd_solve, a length-K scan) or
  ``'cr'`` (direct.btd_solve_cr, log-depth cyclic reduction).

Automatic choices are keyed on the device's ``platform`` and ``device_kind``
and follow what was measured on that device (PERF.md): dtype, horizon and
preconditioner polynomial degree; anywhere else the portable XLA path runs.
An explicit ``pcg_backend`` that this platform cannot honour raises
``ValueError`` — it is never emulated.
"""

from __future__ import annotations

from typing import Optional, Tuple

import jax
import jax.numpy as jnp

VALID_PCG_BACKENDS = ("jax", "triton")

# Devices on which the Triton PCG kernel beat XLA's while loop end to end,
# and, per preconditioner polynomial degree, the longest horizon K at which
# it won every alternating round at every batch measured (PERF.md,
# Findings).  H100, degree 1: won at K=50, 96 and 128 for B=1, 256 and 1024,
# lost at K=256 and 1024 (B=1).  Degree 2: won at K=50 (B=1, 1024), lost at
# K=128 B=1.  One program streams its operator tile by tile, so its time
# grows with K and with the operator passes per iteration, while XLA's loop
# spreads each pass over the card.  Degrees not listed were not measured and
# run on XLA.
_TRITON_PCG_MAX_K = {"NVIDIA H100 80GB HBM3": {1: 128, 2: 50}}

# Devices on which XLA's cyclic reduction beat the Thomas scan at every
# batch width and horizon measured (H100: B=1..1024 at K=50, K up to 4096
# at B=1; PERF.md, Findings).  The Thomas scan runs K dependent steps, each
# a launch of its own on a GPU.
_CR_DEVICES = frozenset({"NVIDIA H100 80GB HBM3"})


def current_device() -> Tuple[str, str]:
    """(platform, device_kind) of the default device."""
    d = jax.devices()[0]
    return d.platform, d.device_kind


def choose_backend(
    method: str,
    requested: Optional[str],
    *,
    dtype,
    K: int,
    poly_degree: int = 1,
    device: Optional[Tuple[str, str]] = None,
) -> str:
    """Backend for one solve call (see module docstring for the values).

    ``K`` is the horizon, ``poly_degree`` the preconditioner polynomial's
    degree; ``device`` is (platform, device_kind), the default device when
    None.
    """
    if requested is not None and requested not in VALID_PCG_BACKENDS:
        raise ValueError(
            f"unknown pcg_backend {requested!r}; valid choices are "
            f"{VALID_PCG_BACKENDS} or None for auto-selection")
    platform, kind = device if device is not None else current_device()
    f32 = jnp.dtype(dtype) == jnp.float32
    if method == "direct":
        if requested == "triton":
            raise ValueError(
                "pcg_backend='triton' is the PCG kernel; method='direct' "
                "runs on XLA (pcg_backend None or 'jax')")
        return "cr" if platform == "gpu" and kind in _CR_DEVICES else "thomas"
    if method != "pcg":
        raise ValueError(f"unknown method {method!r}")
    if requested == "triton":
        if platform != "gpu":
            raise ValueError(
                f"pcg_backend='triton' compiles for a CUDA GPU only; this "
                f"device is {platform!r} (use None or 'jax')")
        if not f32:
            raise ValueError(
                f"pcg_backend='triton' runs a float32 kernel; dtype="
                f"{jnp.dtype(dtype).name} needs pcg_backend None or 'jax'")
        return "triton"
    if requested == "jax":
        return "jax"
    measured = _TRITON_PCG_MAX_K.get(kind, {}) if platform == "gpu" else {}
    max_k = measured.get(poly_degree)
    if f32 and max_k is not None and K <= max_k:
        return "triton"
    return "jax"

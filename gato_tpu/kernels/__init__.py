"""Hand-written Pallas kernels.

Numerics match the plain XLA path in pcg.py (which is also the portable
fallback and the test oracle); every kernel here has an ``interpret=True``
CPU test, and dispatch.choose_backend decides where each one runs.
"""

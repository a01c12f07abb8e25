"""jaybenne_tpu_torch — the PyTorch + CUDA port of ``jaybenne_tpu``.

Implicit Monte Carlo thermal photon transport on one NVIDIA GPU. The module layout
mirrors the JAX package (``jaybenne_tpu``), which stays the reference: every module
here has a counterpart of the same name there, and ``bridge.py`` moves states
between the two for the tests.

This package imports ``torch`` and never ``jax``. The census kernel is hand-written
CUDA C++ (``csrc/``), compiled with ``nvcc`` at first use; on CPU tensors every
kernel runs its plain PyTorch version instead.

Scope of this slice: the stepdiff main path — 1D, single device, gray IMC with pure
scattering, thermal initial radiation, no emission and no feedback. Other
configurations raise ``NotImplementedError`` naming the ROADMAP item that ports
them.
"""

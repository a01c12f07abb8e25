"""jaybenne_tpu_torch — the PyTorch + CUDA port of ``jaybenne_tpu``.

Implicit Monte Carlo thermal photon transport on one NVIDIA GPU. The module layout
mirrors the JAX package (``jaybenne_tpu``), which stays the reference: every module
here has a counterpart of the same name there but ``graph.py`` (the step as a CUDA
graph, where the JAX package jits it) and ``utils/device.py`` (constants made once
on the device), and ``bridge.py`` moves states between the two for the tests.

This package imports ``torch`` and never ``jax``. The census kernel is hand-written
CUDA C++ (``csrc/``), compiled with ``nvcc`` at first use; on CPU tensors every
kernel runs its plain PyTorch version instead.

Scope so far: IMC and hybrid IMC/DDMC on uniform and statically refined meshes in
1D, 2D and 3D, with thermal initial radiation, emission, absorption, fluid
feedback, the external volume source, and every model of the JAX package (gray,
tabulated and frequency-dependent ``EPBremss`` opacities, gray and Thomson
scattering, the ideal-gas and power-law-cv equations of state), on one device or
under either decomposition (``parallel/``: the particle one, and the spatial one
with migration), with every shard in one process or one shard per rank of a
``torch.distributed`` group; with the JAX package's dumps and checkpoints
(``io.py``: each package restarts from the other's), restart at any shard count,
``debug_checks`` and profiling; in float32 or, with ``precision = f64``, in
float64 throughout (a ``double`` instantiation of the census kernel). A step
queues its device work without waiting for it, and on a GPU the single-device
step runs as a CUDA graph.
"""

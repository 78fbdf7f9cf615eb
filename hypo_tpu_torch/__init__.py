"""hypo_tpu_torch — the PyTorch / CUDA port of hypo_tpu's device path.

The device polish paths of ``hypo_tpu`` rebuilt on PyTorch for an
NVIDIA H100: mode ``full`` (the tile program of
``hypo_tpu.poa.device_full`` driven by
``hypo_tpu.poa.full_runner.FullDeviceRunner``, with or without the
native host library) and mode ``exact`` (``hypo_tpu.poa.batch``'s
device DP and traceback with host graph merges).  The two Pallas
kernels of the JAX package and exact mode's traceback are written by
hand in CUDA C++ (``csrc/``).  The host layer — IO, k-mer counting,
segmentation, arm extraction, the native tile-job builder and the host
POA engines — is imported from ``hypo_tpu`` unchanged; nothing in this
package imports ``jax``.

Module names follow the JAX package so each counterpart is easy to
find: ``poa.device_full`` (tile program), ``poa.full_runner`` and
``poa.batch`` (runners), ``pipeline.polish`` and ``cli``.  The kernels
are built with ``nvcc`` at first use into the git-ignored ``_build/``
directory (``_build.py``).
"""

__version__ = "0.1.0"

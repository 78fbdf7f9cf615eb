"""hypo_tpu_torch — the PyTorch / CUDA port of hypo_tpu for an NVIDIA H100.

The device polish paths of ``hypo_tpu`` rebuilt on PyTorch: mode
``full`` (the tile program ``poa.device_full`` driven by
``poa.full_runner.FullDeviceRunner``, with or without the native host
library) and mode ``exact`` (``poa.batch``: device DP and traceback
with host graph merges).  The two Pallas kernels of the JAX package and
exact mode's traceback are written by hand in CUDA C++ (``csrc/``).

The package stands alone: it imports neither jax nor anything of
``hypo_tpu``.  Its host layer — config, dna, io, kmers, segment, utils,
pipeline (alignment, contig, window), the host POA engines, the
``ColPoa`` spec, sim, eval_qv and the native libraries' sources — is a
copy of hypo_tpu's under the same paths and names; each copy's
docstring names its original.  The CUDA kernels and the native host
libraries are built at first use into the git-ignored ``_build/``
directory (``_build.py``).  ``bench`` measures the device path's
pipeline throughput against the host engine, and ``tools`` holds the
profile tool and the long-window statistics.
"""

__version__ = "0.1.0"

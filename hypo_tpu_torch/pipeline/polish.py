"""The polishing orchestrator with window consensus on a PyTorch device.

``Polisher`` is hypo_tpu's orchestrator (hypo_tpu.pipeline.polish,
jax-free) with its two device hooks replaced: ``_resolve_device_poa``
(auto keeps the host engine; the JAX package's auto needed a TPU and an
opt-in) and ``_make_device_runner``: mode ``full`` builds the tile
runner of poa.full_runner, mode ``exact`` the runner of poa.batch, both
on a CUDA device.  The inherited ``_polish_batch`` then drives the full
runner through ``run_polish_batch`` when hypo_tpu's native host library
is available and through ``run_windows`` when it is not, and the exact
runner always through ``run_windows``, as in the JAX package.  Asking
for the device path without CUDA exits with an error: nothing moves to
the CPU quietly.
"""
from __future__ import annotations

import torch

from hypo_tpu.config import InputFlags
from hypo_tpu.pipeline import polish as _host_polish

from ..poa.batch import DeviceConsensusRunner
from ..poa.full_runner import FullDeviceRunner


def cuda_device() -> torch.device:
    """The current CUDA device; exits with an error when there is none."""
    if not torch.cuda.is_available():
        raise SystemExit("hypo_tpu_torch: --device-poa needs a CUDA device, "
                         "and torch.cuda.is_available() is false")
    return torch.device("cuda", torch.cuda.current_device())


class Polisher(_host_polish.Polisher):
    """``device`` is where the device runner computes: None means the
    current CUDA device; tests pass torch.device("cpu") to run the
    kernels' plain versions."""

    def __init__(self, flags: InputFlags, device=None):
        super().__init__(flags)
        self.device = device

    def _resolve_device_poa(self) -> None:
        if self.flags.use_device_poa is None:
            self.flags.use_device_poa = False

    def _make_device_runner(self):
        f = self.flags
        if not f.use_device_poa:
            return None
        device = self.device if self.device is not None else cuda_device()
        if f.device_poa_mode == "full":
            runner = FullDeviceRunner(f.score_params, device,
                                      threads=f.threads)
        else:
            runner = DeviceConsensusRunner(f.score_params, device)
        runner.warm()
        return runner


def polish(flags: InputFlags, device=None) -> Polisher:
    """Polish per ``flags``; returns the Polisher (its ``device_runner``
    holds the device path's stats)."""
    p = Polisher(flags, device)
    p.polish()
    return p

"""The polishing orchestrator with window consensus on a PyTorch device.

``Polisher`` is hypo_tpu's orchestrator (hypo_tpu.pipeline.polish,
jax-free) with its two device hooks replaced: ``_resolve_device_poa``
(auto keeps the host engine; the JAX package's auto needed a TPU and an
opt-in) and ``_make_device_runner`` (the tile runner of
poa.full_runner on a CUDA device).  Asking for the device path without
CUDA exits with an error: nothing moves to the CPU quietly.
"""
from __future__ import annotations

import torch

from hypo_tpu.config import InputFlags
from hypo_tpu.native import host_api
from hypo_tpu.pipeline import polish as _host_polish

from ..poa.full_runner import FullDeviceRunner


def cuda_device() -> torch.device:
    """The current CUDA device; exits with an error when there is none."""
    if not torch.cuda.is_available():
        raise SystemExit("hypo_tpu_torch: --device-poa needs a CUDA device, "
                         "and torch.cuda.is_available() is false")
    return torch.device("cuda", torch.cuda.current_device())


class Polisher(_host_polish.Polisher):
    """``device`` is where the tile program computes: None means the
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
        if f.device_poa_mode != "full":
            raise SystemExit(f"hypo_tpu_torch: --device-poa-mode "
                             f"{f.device_poa_mode} is not ported; use full")
        device = self.device if self.device is not None else cuda_device()
        if not host_api.available():
            raise SystemExit("hypo_tpu_torch: the device path needs the "
                             "native host library (hypo_tpu/native), which "
                             "failed to build or load")
        runner = FullDeviceRunner(f.score_params, device, threads=f.threads)
        runner.warm()
        return runner


def polish(flags: InputFlags, device=None) -> Polisher:
    """Polish per ``flags``; returns the Polisher (its ``device_runner``
    holds the device path's stats)."""
    p = Polisher(flags, device)
    p.polish()
    return p

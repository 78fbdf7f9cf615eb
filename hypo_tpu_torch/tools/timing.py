"""Timing helpers shared by ``hypo_tpu_torch.bench`` and
``hypo_tpu_torch.tools.profile_device``.

A device time comes only from the card: ``event_ms`` times calls
between CUDA events there, ``profiled_ms`` sums the device kernels that
torch.profiler traced.  On the CPU (the tests) ``event_ms`` falls to
the host clock and ``profiled_ms`` returns None: a CPU time is never
reported as a device time.
"""
from __future__ import annotations

import subprocess
import time
from typing import Callable, Optional, Tuple

import numpy as np
import torch


def device_for(name: str) -> torch.device:
    """``cuda`` (the current CUDA device; exits without one) or
    ``cpu``."""
    if name == "cpu":
        return torch.device("cpu")
    if name != "cuda":
        raise SystemExit(f"--device must be cuda or cpu, not {name!r}")
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device (torch.cuda.is_available() is "
                         "false); pass --device cpu for a CPU run")
    return torch.device("cuda", torch.cuda.current_device())


def card(dev: torch.device) -> str:
    """The device a result was measured on: the card's name and power
    limit as nvidia-smi reports them, or ``cpu``."""
    if dev.type != "cuda":
        return "cpu"
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader", "-i", str(dev.index)],
                           capture_output=True, text=True, check=True)
        return r.stdout.strip().splitlines()[0]
    except (OSError, subprocess.CalledProcessError, IndexError):
        return f"{torch.cuda.get_device_name(dev)}, power limit not read"


def sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def event_ms(fn: Callable[[], object], dev: torch.device, reps: int = 5,
             inner: int = 10) -> float:
    """Median over ``reps`` samples of the milliseconds per call of fn(),
    after one warm-up call; a sample is ``inner`` back-to-back calls
    between two CUDA events on the card (so it holds the host's issue
    work too, where that is longer than the device's), on the host clock
    to a synchronize elsewhere."""
    fn()
    sync(dev)
    ts = []
    for _ in range(reps):
        if dev.type == "cuda":
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            for _ in range(inner):
                fn()
            e.record()
            e.synchronize()
            ts.append(s.elapsed_time(e) / inner)
        else:
            t0 = time.perf_counter()
            for _ in range(inner):
                fn()
            ts.append((time.perf_counter() - t0) * 1e3 / inner)
    return float(np.median(ts))


def profiled_ms(fn: Callable[[], object], dev: torch.device,
                calls: int = 10, tries: int = 3
                ) -> Tuple[Optional[float], Optional[float]]:
    """(device ms per call, device kernels and copies per call) of fn()
    under torch.profiler (CUDA activity only), after one warm-up call:
    the summed durations of the device activities that ``calls`` calls
    launch, over the calls.  (None, None) off the card; raises if
    ``tries`` traces in a row saw no device activity (the profiler's
    device activity is sometimes lost, so one empty trace is retried)."""
    if dev.type != "cuda":
        return None, None
    from torch.profiler import ProfilerActivity, profile
    fn()
    sync(dev)
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            sync(dev)
        spans = [e.time_range.end - e.time_range.start
                 for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA]
        if spans:
            return sum(spans) / 1e3 / calls, len(spans) / calls
    raise RuntimeError("torch.profiler saw no device activity")


def fmt(x: Optional[float], digits: int = 4) -> str:
    return "not measured" if x is None else f"{x:.{digits}f}"

"""Carry a POA graph state between the JAX package and the port.

The system has no weights: what one run hands to another is the
per-window graph state of a tile (``PoaState``).  ``state_from_numpy``
builds the port's state from any object with the PoaState fields as
attributes whose leaves convert to numpy (a
hypo_tpu.poa.device_full.PoaState with a leading batch dimension);
``state_to_numpy``
returns the port's state as a dict of numpy arrays.  Tests use them to
feed one mid-run graph to both ``_arm_step_batch`` implementations.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from .poa.device_full import PoaState

FIELDS = PoaState._fields


def state_from_numpy(st, device) -> PoaState:
    out = {}
    for f in FIELDS:
        dtype = torch.bool if f == "ovf" else torch.int32
        out[f] = torch.tensor(np.asarray(getattr(st, f)), dtype=dtype,
                              device=device)
    return PoaState(**out)


def state_to_numpy(st: PoaState) -> Dict[str, np.ndarray]:
    return {f: getattr(st, f).cpu().numpy() for f in FIELDS}

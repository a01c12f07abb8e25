"""Constants on the run's device, made once.

``torch.tensor(value, device="cuda")`` copies from host memory and waits for the
copy, so a step that made its constants so would wait for the device at each
one, and a CUDA graph cannot capture it at all. ``device_const`` makes each
(value, dtype, device) once, by that same call, and hands back the same tensor
after: the bits are those of the call it replaces. The eager first step of a run
makes every constant its step needs, so a captured or replayed step makes none.
"""

from __future__ import annotations

import numpy as np
import torch

_CONSTS: dict = {}


def device_const(value, dtype, device) -> torch.Tensor:
    """``torch.tensor(value, dtype=dtype, device=device)``, made at the first call
    for these bits of ``value`` (a number, a nested tuple or a numpy array) and
    kept. The tensor is shared: read it, never write it."""
    arr = np.asarray(value)
    key = (arr.tobytes(), arr.shape, arr.dtype.str, dtype, torch.device(device))
    t = _CONSTS.get(key)
    if t is None:
        t = _CONSTS[key] = torch.tensor(value, dtype=dtype, device=device)
    return t


def as_device(value, dtype, device) -> torch.Tensor:
    """``torch.as_tensor(value, dtype=dtype, device=device)`` without a host copy:
    a tensor converted where it lies, a number through ``device_const``."""
    if isinstance(value, torch.Tensor):
        return value.to(device=device, dtype=dtype)
    return device_const(value, dtype, device)

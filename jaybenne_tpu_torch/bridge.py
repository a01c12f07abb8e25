"""Numpy bridge between the JAX package's states and this port's.

A test flattens a JAX ``SimState``, ``MeshGeometry``, ``TransportCoefs``,
``ParticleLedger`` or ``Fields`` into a dict of numpy arrays (nested dicts for
nested dataclasses, plain Python values for static metadata);
``state_from_numpy`` builds the port's counterpart on a device, and
``state_to_numpy`` goes the other way. One initial state can then run through both
packages. This module never imports jax: the dicts carry only numpy arrays and
Python values.

Keys the port has no field for (the JAX coefficients' ``packed`` rows and model
objects, the PRNG key) are ignored, and a field with a default (the ledger's
``leak`` column among them) may be left out. A ``SimState`` needs an integer
``seed`` in place of the JAX PRNG key.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .mesh import MeshGeometry
from .ops.transport import TransportCoefs
from .particles import ParticleLedger
from .state import Fields, SimState

# the JAX coefficients' model object belongs to the JAX package: the port's
# counterpart is built from the port's own models
_MODEL_FIELDS = ("opacity",)

# each kind is recognised by a key only it has
_KINDS = (
    ("particles", SimState),
    ("block_origin", MeshGeometry),
    ("sigma_s", TransportCoefs),
    ("alive", ParticleLedger),
    ("energy_tally", Fields),
)


def _kind(d: dict):
    for key, cls in _KINDS:
        if key in d:
            return cls
    raise ValueError(f"state_from_numpy: cannot tell the kind of a dict with keys {sorted(d)}")


def _convert(v, device):
    if isinstance(v, dict):
        return state_from_numpy(v, device)
    if isinstance(v, np.ndarray) and v.ndim > 0:
        return torch.from_numpy(np.array(v)).to(device)  # a writable copy
    if isinstance(v, np.ndarray) or isinstance(v, np.generic):
        return v.item()
    return v


def state_from_numpy(d: dict, device="cpu"):
    """The port's counterpart of a flattened JAX state object, on ``device``."""
    cls = _kind(d)
    kwargs = {}
    for f in dataclasses.fields(cls):
        if f.name not in d or (cls is TransportCoefs and f.name in _MODEL_FIELDS):
            if f.default is not dataclasses.MISSING:
                continue
            raise KeyError(f"state_from_numpy: {cls.__name__} needs {f.name!r}")
        kwargs[f.name] = _convert(d[f.name], device)
    return cls(**kwargs)


def state_to_numpy(obj) -> dict:
    """A port state object as a dict of numpy arrays (nested for nested objects)."""
    out = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if dataclasses.is_dataclass(v):
            v = state_to_numpy(v)
        elif isinstance(v, torch.Tensor):
            v = v.detach().cpu().numpy()
        out[f.name] = v
    return out

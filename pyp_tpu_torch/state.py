"""State exchange between the JAX package and the port.

`from_jax` turns state the JAX package produced — maps, half maps,
accumulators, refinement results and pose arrays, handed over as numpy
arrays — into the port's tensors on a device; `to_numpy` goes the other
way. Both packages write the same durable files (accumulator `.npz` with
keys num1/den1/num2/den2, `maps/*.mrc`, `.cistem` tables), so a run started
by one package resumes in the other.
"""

from __future__ import annotations

import numpy as np
import torch

from pyp_tpu_torch import resolve_device
from pyp_tpu_torch.ops.reconstruct import Accumulators, Reconstruction
from pyp_tpu_torch.ops.refine3d import RefineResult

_TUPLES = (Accumulators, Reconstruction, RefineResult)


def _tensor(x, dev):
    a = np.array(x)  # a private, writable copy: JAX hands out read-only views
    if a.dtype == np.float64:
        a = a.astype(np.float32)
    elif a.dtype == np.complex128:
        a = a.astype(np.complex64)
    return torch.from_numpy(a).to(dev)


def _port_type(x):
    """The port's NamedTuple with the same fields as `x` (the JAX package's
    Accumulators, Reconstruction and RefineResult share them), or None."""
    fields = getattr(x, "_fields", None)
    return next((t for t in _TUPLES if t._fields == fields), None)


def from_jax(arrays, device="cpu"):
    """numpy state -> tensors on `device`. `arrays` is a single array, a
    dict of name -> array, or an Accumulators / Reconstruction /
    RefineResult (either package's) holding arrays; float64/complex128
    become float32/complex64, the JAX package's working types."""
    dev = resolve_device(device)
    kind = _port_type(arrays)
    if kind is not None:
        return kind(*(_tensor(a, dev) for a in arrays))
    if isinstance(arrays, dict):
        return {k: from_jax(v, dev) for k, v in arrays.items()}
    return _tensor(arrays, dev)


def to_numpy(state):
    """Tensors (alone, in a dict, or in one of the port's NamedTuples) ->
    numpy arrays on the host, in the same structure."""
    kind = _port_type(state)
    if kind is not None:
        return kind(*(to_numpy(a) for a in state))
    if isinstance(state, dict):
        return {k: to_numpy(v) for k, v in state.items()}
    if isinstance(state, torch.Tensor):
        return state.detach().cpu().numpy()
    return np.asarray(state)

"""Carry a parameter tree of the JAX package into the port.

`params_from_numpy` takes the reference's tree as nested dicts of numpy
arrays (``jax.tree.map(np.asarray, params)`` on the reference side) and
returns the same tree of torch tensors on ``device``. It accepts both
unquantized trees (``{'w', 'b'}`` linears; the port's engine quantizes them
as the reference's does) and already-packed ``{'hi', 'lsb', 'scale', 'b'}``
trees. bfloat16 arrays (numpy's ``ml_dtypes`` extension type) keep their
bits.
"""

from __future__ import annotations

import numpy as np
import torch


def _to_tensor(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(np.array(a).view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a))
    return t.to(device)


def params_from_numpy(tree, device="cpu"):
    """Nested dicts of numpy arrays -> nested dicts of tensors on ``device``."""
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device) for k, v in tree.items()}
    return _to_tensor(tree, device)

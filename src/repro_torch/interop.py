"""Parameter trees across packages: nested dicts and lists of numpy arrays
<-> the same nesting of torch tensors, leaf for leaf (the CNN trees hold
lists: ``params["conv"][i]``, ``params["stages"][s][b]``).

A JAX bfloat16 array converts (``np.asarray``) to an ``ml_dtypes`` bfloat16
array, which ``torch.from_numpy`` rejects; such leaves travel as their int16
bit patterns and are viewed back as ``torch.bfloat16`` (no ``ml_dtypes``
import needed).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.tree import tree_map


def _to_torch(arr, device) -> torch.Tensor:
    arr = np.array(arr, order="C")     # a copy; a 0-d leaf (a count) stays 0-d
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16
                                                         ).to(device)
    return torch.from_numpy(arr).to(device)


def params_from_numpy(tree, device):
    """Nested dicts / lists / tuples of numpy arrays (anything
    ``np.asarray`` takes) -> the same tree of torch tensors on ``device``.
    There is no default device: the caller names the card (``"cuda"``) or
    the host (``"cpu"``), and a CUDA device with no card visible raises."""
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"params_from_numpy(device={device!r}): no CUDA "
                           "device is visible")
    return tree_map(lambda x: _to_torch(x, device), tree)


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.to(torch.float32)
    return t.numpy()


def params_to_numpy(tree):
    """Nested dicts / lists / tuples of torch tensors -> the same tree of
    numpy arrays on the host (bfloat16 leaves come back as float32: numpy
    has no bfloat16)."""
    return tree_map(_to_numpy, tree)

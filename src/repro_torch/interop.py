"""Parameter trees across packages: nested dicts of numpy arrays <-> nested
dicts of torch tensors, leaf for leaf.

A JAX bfloat16 array converts (``np.asarray``) to an ``ml_dtypes`` bfloat16
array, which ``torch.from_numpy`` rejects; such leaves travel as their int16
bit patterns and are viewed back as ``torch.bfloat16`` (no ``ml_dtypes``
import needed).
"""
from __future__ import annotations

import numpy as np
import torch


def _to_torch(arr, device) -> torch.Tensor:
    arr = np.ascontiguousarray(arr)
    if arr.dtype.name == "bfloat16":
        t = torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr.copy())
    return t.to(device)


def params_from_numpy(tree, device):
    """Nested dict of numpy arrays (anything ``np.asarray`` takes) -> the
    same tree of torch tensors on ``device``.  There is no default device:
    the caller names the card (``"cuda"``) or the host (``"cpu"``), and a
    CUDA device with no card visible raises."""
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"params_from_numpy(device={device!r}): no CUDA "
                           "device is visible")
    return _from_numpy(tree, device)


def _from_numpy(tree, device):
    if isinstance(tree, dict):
        return {k: _from_numpy(v, device) for k, v in tree.items()}
    return _to_torch(np.asarray(tree), device)


def params_to_numpy(tree):
    """Nested dict of torch tensors -> the same tree of numpy arrays on the
    host (bfloat16 leaves come back as float32: numpy has no bfloat16)."""
    if isinstance(tree, dict):
        return {k: params_to_numpy(v) for k, v in tree.items()}
    t = tree.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.to(torch.float32)
    return t.numpy()

"""Carry parameters across from the JAX package: a tree (dicts and lists)
of numpy arrays, as ``jax.tree.map(np.asarray, params)`` gives it, becomes
the same tree of tensors on ``device``, bit for bit.

bf16 travels as an int16 view and e4m3 as a uint8 view, so neither numpy
nor this module needs ``ml_dtypes``."""

from typing import Any

import numpy as np
import torch

from ..runtime.config import resolve_device

_VIEWS = {
    'bfloat16': (np.int16, torch.bfloat16),
    'float8_e4m3fn': (np.uint8, torch.float8_e4m3fn),
}


def tensor_from_numpy(arr: np.ndarray, device=None) -> torch.Tensor:
    """One numpy array (ml_dtypes bf16/e4m3 included) -> tensor, bit for bit."""
    arr = np.array(arr, copy=True)          # writable and contiguous
    view = _VIEWS.get(arr.dtype.name)
    if view is None:
        t = torch.from_numpy(arr)
    else:
        np_view, torch_dtype = view
        t = torch.from_numpy(arr.view(np_view)).view(torch_dtype)
    return t.to(resolve_device(device))


def params_from_jax(tree: Any, device=None) -> Any:
    """Tree of numpy arrays -> the same tree of tensors on ``device``."""
    if isinstance(tree, dict):
        return {k: params_from_jax(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(params_from_jax(v, device) for v in tree)
    return tensor_from_numpy(tree, device)

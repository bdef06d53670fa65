"""Carry parameters across from the JAX package: a tree (dicts and lists)
of numpy arrays, as ``jax.tree.map(np.asarray, params)`` gives it, becomes
the same tree of tensors on ``device``, bit for bit; walk such trees in the
JAX package's leaf order, to hold the port's parameters and gradients
against JAX's leaf by leaf; and cut the expert weights into the shards of
an expert-parallel mesh (JAX's ``param_shardings``: experts over 'ep').

bf16 travels as an int16 view and e4m3 as a uint8 view, so neither numpy
nor this module needs ``ml_dtypes``."""

from typing import Any, Callable, Dict, List

import numpy as np
import torch

from ..runtime.config import resolve_device

EXPERT_LEAVES = ('w1', 'w2')

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


def tree_leaves(tree: Any) -> List[Any]:
    """The leaves of a tree of dicts and lists, in ``jax.tree.leaves`` order
    (dict keys sorted), so a port tree and a JAX tree line up leaf by leaf."""
    if isinstance(tree, dict):
        return [leaf for key in sorted(tree) for leaf in tree_leaves(tree[key])]
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in tree_leaves(v)]
    return [tree]


def tree_map(fn: Callable[[Any], Any], tree: Any) -> Any:
    """The same tree with ``fn`` applied to every leaf, leaves visited in
    :func:`tree_leaves` order."""
    if isinstance(tree, dict):
        return {key: tree_map(fn, tree[key]) for key in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def rank_experts(w: Any, mesh) -> List[torch.Tensor]:
    """Each rank's experts of ``w`` [E, ...] (its 'ep' coordinate's slice of
    E / ep experts): views where the rank's device holds ``w``, copies to
    the rank's device elsewhere. A list (from :func:`shard_experts`) is
    taken as it is."""
    if isinstance(w, (list, tuple)):
        if len(w) != mesh.size:
            raise ValueError(f'{len(w)} expert shards for {mesh.size} ranks')
        return list(w)
    ep = mesh.shape[mesh.axis_names.index('ep')]
    if w.shape[0] % ep:
        raise ValueError(f'{w.shape[0]} experts do not split over ep={ep}')
    per = w.shape[0] // ep
    out = []
    for rank, dev in enumerate(mesh.devices):
        c = mesh.coords(rank)['ep']
        out.append(w[c * per:(c + 1) * per].to(dev))
    return out


def shard_experts(params: Dict[str, Any], mesh) -> Dict[str, Any]:
    """``params`` with each layer's expert weights cut into per-rank shards
    once (lists in rank order; views on one card, copies to each card on
    several), the rest shared: the form ``forward(..., mesh)`` takes
    without cutting anew each call."""
    out = dict(params)
    out['layers'] = [{key: rank_experts(v, mesh) if key in EXPERT_LEAVES else v
                      for key, v in layer.items()} for layer in params['layers']]
    return out

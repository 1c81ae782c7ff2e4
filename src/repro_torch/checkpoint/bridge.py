"""The reference's parameter tree <-> the port's parameters.

The port lays its parameters out exactly like the reference's tree
(``repro.models.lm.DecoderLM.param_specs``: a scanned stack on axis 0
of ``layers``, as ``lax.scan`` consumes it, ``dense_layer_N`` and
unscanned ``layer_NN`` blocks; whisper's ``enc_NN`` / ``dec_NN``), so
the bridge is a key-for-key copy that checks every key and shape
against the port's own specs (the shape each initializer makes: RWKV6's
stacked ``w0`` is one value a layer in both packages) and its storage
dtype (``cfg.param_dtype``: bf16 leaves of 2 or more dimensions, as
the reference's ``with_param_dtype`` stores them).  bf16 leaves
(numpy's ``ml_dtypes`` bfloat16) keep their bits.
"""
from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from ..models.base import flatten_specs
from ..tree import tree_leaves, tree_map
from ..models import param_specs

__all__ = ["params_from_jax", "params_to_numpy", "to_tensor"]


def to_tensor(arr, device) -> torch.Tensor:
    """numpy array -> tensor with the same bits.  numpy has no bf16
    dtype of its own: an ``ml_dtypes`` bfloat16 array arrives by name
    and crosses as its uint16 view."""
    arr = np.array(arr)                 # a private, writable copy
    if arr.dtype.name == "bfloat16":
        raw = torch.from_numpy(arr.view(np.uint16))
        return raw.view(torch.bfloat16).to(device)
    return torch.from_numpy(arr).to(device)


def _get(tree, path):
    node = tree
    for k in path:
        if not isinstance(node, dict) or k not in node:
            raise KeyError(f"parameter {'/'.join(path)} missing from the "
                           "reference tree")
        node = node[k]
    return node


def params_from_jax(tree, cfg, device=None) -> dict:
    """The port's parameters from the reference's tree (nested dicts of
    numpy arrays, e.g. ``jax.tree.map(np.asarray, model.init(key))``)
    for config ``cfg``.  Raises on a missing, extra or misshapen leaf,
    and on a leaf stored in another dtype than ``cfg.param_dtype`` gives
    it."""
    dev = resolve_device(device)
    specs = list(flatten_specs(param_specs(cfg)))
    n = len(tree_leaves(tree))
    if n != len(specs):
        raise ValueError(f"reference tree has {n} leaves, {cfg.name} needs "
                         f"{len(specs)}")
    out: dict = {}
    for path, ps in specs:
        arr = _get(tree, path)
        if tuple(np.shape(arr)) != ps.init_shape:
            raise ValueError(f"{'/'.join(path)}: shape {np.shape(arr)}, "
                             f"expected {ps.init_shape}")
        t = to_tensor(arr, dev)
        if t.dtype != ps.dtype:
            raise ValueError(f"{'/'.join(path)}: dtype {t.dtype}, expected "
                             f"{ps.dtype} (param_dtype {cfg.param_dtype})")
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = t
    return out


def params_to_numpy(params) -> dict:
    """The port's parameters as nested dicts of numpy arrays (bf16
    leaves as their uint16 view)."""
    return tree_map(_leaf_to_numpy, params)


def _leaf_to_numpy(t):
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.uint16).numpy()
    return t.numpy()

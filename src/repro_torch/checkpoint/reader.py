"""Reader of the reference's checkpoint layout (``repro.checkpoint.ckpt``)
with numpy and torch only::

    <dir>/LATEST                   committed step
    <dir>/step_000000123/
        manifest.json              {"step": n, "leaves": {key: {dtype, shape}}}
        <key>.npy                  one file per leaf; key = path joined by "__"

bf16 leaves are stored as their uint16 view with ``dtype: "bfloat16"``
in the manifest; they come back as bf16 tensors with the same bits.
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Optional, Tuple

import numpy as np
import torch

from ..device import resolve_device

__all__ = ["load_reference_checkpoint"]

_SEP = "__"

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "int32": torch.int32, "float16": torch.float16}


def load_reference_checkpoint(directory, *, step: Optional[int] = None,
                              device=None) -> Tuple[dict, int]:
    """Load every leaf of a reference checkpoint into a nested dict of
    tensors on ``device``.  Returns (tree, step).  Pass the tree's
    parameter subtree through :func:`~repro_torch.checkpoint.
    params_from_jax` to check it against a config."""
    dev = resolve_device(device)
    root = Path(directory)
    if step is None:
        marker = root / "LATEST"
        if not marker.exists():
            raise FileNotFoundError(f"no checkpoint under {root}")
        step = int(marker.read_text().strip())
    ckpt = root / f"step_{step:09d}"
    manifest = json.loads((ckpt / "manifest.json").read_text())
    tree: dict = {}
    for key, meta in manifest["leaves"].items():
        dtype = meta["dtype"]
        if dtype not in _DTYPES:
            raise ValueError(f"{key}: unsupported dtype {dtype}")
        arr = np.load(ckpt / f"{key}.npy")
        if list(arr.shape) != list(meta["shape"]):
            raise ValueError(f"{key}: shape {arr.shape} != manifest "
                             f"{meta['shape']}")
        t = torch.from_numpy(np.ascontiguousarray(arr))
        if dtype == "bfloat16":
            if arr.dtype != np.uint16:
                raise ValueError(f"{key}: bf16 leaf stored as {arr.dtype}")
            t = t.view(torch.bfloat16)
        elif t.dtype != _DTYPES[dtype]:
            raise ValueError(f"{key}: stored {arr.dtype}, manifest {dtype}")
        node = tree
        parts = key.split(_SEP)
        for k in parts[:-1]:
            node = node.setdefault(k, {})
        node[parts[-1]] = t.to(dev)
    return tree, int(manifest.get("step", step))

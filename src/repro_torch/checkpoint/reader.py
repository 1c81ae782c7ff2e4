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


def step_dir(root: Path, step: Optional[int]) -> Tuple[Path, int]:
    """The directory of checkpoint ``step`` under ``root`` (None: the
    committed one, from ``LATEST``) and its step."""
    if step is None:
        marker = root / "LATEST"
        if not marker.exists():
            raise FileNotFoundError(f"no checkpoint under {root}")
        step = int(marker.read_text().strip())
    return root / f"step_{step:09d}", step


def read_manifest(ckpt: Path) -> dict:
    return json.loads((ckpt / "manifest.json").read_text())


def read_leaf(ckpt: Path, key: str, meta: dict) -> torch.Tensor:
    """Leaf ``key`` of the checkpoint directory ``ckpt`` as a CPU tensor
    of the manifest's dtype, bits as stored."""
    dtype = meta["dtype"]
    if dtype not in _DTYPES:
        raise ValueError(f"{key}: unsupported dtype {dtype}")
    arr = np.load(ckpt / f"{key}.npy")
    if list(arr.shape) != list(meta["shape"]):
        raise ValueError(f"{key}: shape {arr.shape} != manifest "
                         f"{meta['shape']}")
    t = torch.from_numpy(np.require(arr, requirements="C"))  # keeps 0-d
    if dtype == "bfloat16":
        if arr.dtype != np.uint16:
            raise ValueError(f"{key}: bf16 leaf stored as {arr.dtype}")
        return t.view(torch.bfloat16)
    if t.dtype != _DTYPES[dtype]:
        raise ValueError(f"{key}: stored {arr.dtype}, manifest {dtype}")
    return t


def load_reference_checkpoint(directory, *, step: Optional[int] = None,
                              device=None) -> Tuple[dict, int]:
    """Load every leaf of a reference checkpoint into a nested dict of
    tensors on ``device``.  Returns (tree, step).  Pass the tree's
    parameter subtree through :func:`~repro_torch.checkpoint.
    params_from_jax` to check it against a config."""
    dev = resolve_device(device)
    ckpt, step = step_dir(Path(directory), step)
    manifest = read_manifest(ckpt)
    tree: dict = {}
    for key, meta in manifest["leaves"].items():
        t = read_leaf(ckpt, key, meta)
        node = tree
        parts = key.split(_SEP)
        for k in parts[:-1]:
            node = node.setdefault(k, {})
        node[parts[-1]] = t.to(dev)
    return tree, int(manifest.get("step", step))

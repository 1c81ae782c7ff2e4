"""Checkpoints of the port in the reference's layout
(``repro.checkpoint.ckpt``), so either package restores what the other
wrote, bit for bit::

    <dir>/step_000000123/
        manifest.json     {"step": n, "leaves": {key: {dtype, shape}}}
        <key>.npy         one file per leaf; key = path joined by "__"
    <dir>/LATEST          committed step marker (written last)

bf16 leaves are stored as their uint16 view with ``dtype: "bfloat16"``.
A checkpoint is written into ``.tmp_step_*`` and renamed into place
before ``LATEST`` names it, so a crash mid-checkpoint never corrupts
the restore point; the ``keep`` newest are kept.  A tree is any nested
dict of tensors: the training driver's ``{"params", "opt"}``, the
optimizer state's ``mu``, ``nu``, ``step`` (and ``master`` / ``ef``)
included.

On a mesh (``with mesh:``; ``shardings``: the tree's ``logical_spec``
tuples) the tree holds this rank's shards: ``save_checkpoint`` gathers
every leaf to its full array, rank 0 writes, and every rank waits for
it; ``restore_checkpoint`` reads the full arrays and keeps each rank's
shard.  The manifest is topology-free, so a checkpoint restores onto
any mesh (``runtime.plan_elastic_mesh``), or none.
"""
from __future__ import annotations

import json
import shutil
from pathlib import Path
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from ..launch.mesh import current_mesh
from ..sharding.spmd import unshard_tree
from ..tree import tree_items
from .reader import _SEP, read_leaf, read_manifest, step_dir

__all__ = ["save_checkpoint", "restore_checkpoint", "latest_step"]

_NAMES = {torch.float32: "float32", torch.bfloat16: "bfloat16",
          torch.int32: "int32", torch.float16: "float16"}


def _to_numpy(t: torch.Tensor):
    """(array, dtype name): bf16 as its uint16 view."""
    t = t.detach().cpu()
    if t.dtype not in _NAMES:
        raise TypeError(f"cannot checkpoint a {t.dtype} leaf")
    if t.dtype == torch.bfloat16:
        return t.view(torch.uint16).numpy(), "bfloat16"
    return t.numpy(), _NAMES[t.dtype]


def save_checkpoint(directory, step: int, tree, *, keep: int = 3,
                    shardings=None) -> Path:
    """Write a checkpoint of ``tree``; returns its path.  With
    ``shardings`` (on a mesh) the full arrays of the rank's shards."""
    mesh = current_mesh() if shardings is not None else None
    if mesh is not None:
        tree = unshard_tree(tree, shardings, mesh)
        if mesh.rank != 0:
            return _barrier(mesh, Path(directory) / f"step_{step:09d}")
        path = _write(directory, step, tree, keep)
        return _barrier(mesh, path)
    return _write(directory, step, tree, keep)


def _barrier(mesh, path: Path) -> Path:
    if mesh.size > 1:
        dist.barrier()
    return path


def _write(directory, step: int, tree, keep: int) -> Path:
    root = Path(directory)
    ckpt = root / f"step_{step:09d}"
    tmp = root / f".tmp_step_{step:09d}"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)
    manifest = {"step": step, "leaves": {}}
    for path, leaf in tree_items(tree):
        key = _SEP.join(path)
        arr, dtype = _to_numpy(torch.as_tensor(leaf))
        np.save(tmp / f"{key}.npy", arr)
        manifest["leaves"][key] = {"dtype": dtype, "shape": list(arr.shape)}
    (tmp / "manifest.json").write_text(json.dumps(manifest, indent=1))
    if ckpt.exists():
        shutil.rmtree(ckpt)
    tmp.rename(ckpt)
    (root / "LATEST").write_text(str(step))
    _gc(root, keep)
    return ckpt


def _gc(root: Path, keep: int) -> None:
    steps = sorted(p for p in root.glob("step_*") if p.is_dir())
    for p in steps[:-keep]:
        shutil.rmtree(p, ignore_errors=True)


def latest_step(directory) -> Optional[int]:
    marker = Path(directory) / "LATEST"
    if not marker.exists():
        return None
    return int(marker.read_text().strip())


def restore_checkpoint(directory, like_tree, *, step: Optional[int] = None,
                       shardings=None):
    """Restore into the structure of ``like_tree``: each leaf read with
    its stored dtype and bits onto the device of the matching leaf of
    ``like_tree``.  With ``shardings`` (on a mesh) each leaf is this
    rank's shard of the stored array, on the mesh's device.  Returns
    (tree, step); a leaf the checkpoint lacks raises ``KeyError``."""
    ckpt, step = step_dir(Path(directory), step)
    leaves = read_manifest(ckpt)["leaves"]
    mesh = current_mesh() if shardings is not None else None

    def restore(node, spec, path):
        if isinstance(node, dict):
            return {k: restore(v, None if spec is None else spec[k],
                               path + (str(k),)) for k, v in node.items()}
        key = _SEP.join(path)
        if key not in leaves:
            raise KeyError(f"checkpoint missing leaf {key!r}")
        full = read_leaf(ckpt, key, leaves[key])
        if mesh is not None:
            return mesh.shard(full, spec)
        return full.to(torch.as_tensor(node).device)
    return restore(like_tree, shardings, ()), step

"""Block-sparse matmul — the paper's Sparse PC Inc (Fig 19) at tile
granularity: the CUDA kernel's wrapper, its plain PyTorch version, and
the host-side mask compiler.

``matmul(a, b, mask)`` computes C = A @ (B under ``mask``) with f32
accumulation and an f32 output: A ``(M, K)``, B ``(K, N)`` both float32
or both bfloat16, ``mask`` a ``(K / bk, N / bn)`` bool array of live
weight tiles.  Columns of tiles with no live tile are exactly 0.

``compile_mask`` turns the mask into the jump table of live tiles
(j-major, ascending k within a column), as the paper's Instruction
Loader turns the sparse vector into per-instruction Sparse PC Inc
values (Fig 18); the kernel walks that table and never touches a dead
tile.  ``mask_from_weights``, ``compile_mask``, ``sparse_savings`` and
``expand_mask`` are numpy, as in the reference.

The wrapper launches the kernel (``csrc/block_sparse.cu``) for CUDA
tensors and takes the plain version only for CPU tensors; bf16
operands pick their producer as the dataflow GEMM's do
(``gemm_dataflow.ops.producer_for``).
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import numpy as np
import torch

from ..build import load
from ..gemm_dataflow.ops import producer_for

__all__ = ["compile_mask", "column_table", "expand_mask",
           "mask_from_weights", "matmul", "matmul_plain", "sparse_savings",
           "TILE"]

#: the kernel's tile (bm = bn = bk)
TILE = 128

#: kernel launches since the last reset (chip_smoke.py reads it)
launches = 0
#: the counters above by name: a CUDA graph of the serving programs
#: (``serve/compiled.py``) reads their rise during its capture and
#: adds it at each replay, which runs no Python
COUNTERS = ("launches",)

_fn = None
_DTYPE = {torch.float32: 0, torch.bfloat16: 1}


def _kernel():
    global _fn
    if _fn is None:
        f = load("block_sparse").repro_block_sparse
        f.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
                      + [ctypes.c_void_p])
        f.restype = ctypes.c_int
        _fn = f
    return _fn


def mask_from_weights(b: np.ndarray, bk: int, bn: int,
                      threshold: float = 0.0) -> np.ndarray:
    """Block mask: a tile is live iff it has any |w| > threshold."""
    k, n = b.shape
    assert k % bk == 0 and n % bn == 0
    blocks = np.abs(np.asarray(b)).reshape(k // bk, bk, n // bn, bn)
    return (blocks.max(axis=(1, 3)) > threshold)


def compile_mask(mask: np.ndarray) -> Tuple[np.ndarray, np.ndarray,
                                            np.ndarray]:
    """Mask (nk, nn) bool -> (live_k, live_j, first) jump table, j-major
    so each output column's live tiles are a contiguous run."""
    mask = np.asarray(mask, bool)
    nk, nn = mask.shape
    live_k, live_j, first = [], [], []
    for j in range(nn):
        ks = np.nonzero(mask[:, j])[0]
        for t, kk in enumerate(ks):
            live_k.append(kk)
            live_j.append(j)
            first.append(1 if t == 0 else 0)
    if not live_k:                     # fully-pruned: one step, masked out
        live_k, live_j, first = [0], [0], [1]
    return (np.asarray(live_k, np.int32), np.asarray(live_j, np.int32),
            np.asarray(first, np.int32))


def column_table(mask: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """The jump table as the kernel reads it: ``(col_start, live_k)``,
    int32, column j's live k tiles being ``live_k[col_start[j]:
    col_start[j + 1]]``.  Derived from ``compile_mask``; its
    fully-pruned sentinel step is dropped (no live tile, no step)."""
    mask = np.asarray(mask, bool)
    n_live = int(mask.sum())
    live_k, live_j, _ = compile_mask(mask)
    live_k, live_j = live_k[:n_live], live_j[:n_live]
    counts = np.bincount(live_j, minlength=mask.shape[1])
    col_start = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
    return col_start, live_k


def expand_mask(mask: np.ndarray, bk: int, bn: int) -> np.ndarray:
    """(K/bk, N/bn) bool -> (K, N) elementwise bool."""
    return np.repeat(np.repeat(np.asarray(mask, bool), bk, axis=0), bn,
                     axis=1)


def sparse_savings(mask: np.ndarray) -> dict:
    """Static savings — the paper's Fig-19 accounting at tile level."""
    mask = np.asarray(mask, bool)
    total = mask.size
    live = int(mask.sum())
    return {
        "tiles_total": total,
        "tiles_live": live,
        "flops_saved_frac": 1.0 - live / total,
        "weight_bytes_saved_frac": 1.0 - live / total,
    }


def _check_mask(a, b, mask, bk, bn):
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"shapes {tuple(a.shape)} @ {tuple(b.shape)} do "
                         "not chain")
    if a.device != b.device:
        raise ValueError(f"a is on {a.device}, b on {b.device}")
    if a.dtype != b.dtype:
        raise TypeError(f"a is {a.dtype}, b is {b.dtype}")
    mask = np.asarray(mask, bool)
    k, n = b.shape
    want = (-(-k // bk), -(-n // bn))
    if mask.shape != want:
        raise ValueError(f"mask shape {mask.shape}, B {tuple(b.shape)} in "
                         f"{bk} x {bn} tiles needs {want}")
    return mask


def matmul_plain(a, b, mask, *, bk: int = TILE, bn: int = TILE):
    """The kernel's function in plain PyTorch: for each column of tiles,
    the f32 psum of its live tile products in ascending k (each formed
    from zero); columns with no live tile stay 0."""
    mask = np.asarray(mask, bool)
    m = a.shape[0]
    n = b.shape[1]
    a32, b32 = a.float(), b.float()
    out = torch.zeros((m, n), dtype=torch.float32, device=a.device)
    col_start, live_k = column_table(mask)
    for j in range(mask.shape[1]):
        cols = slice(j * bn, (j + 1) * bn)
        for kk in live_k[col_start[j]:col_start[j + 1]].tolist():
            rows = slice(kk * bk, (kk + 1) * bk)
            out[:, cols] += a32[:, rows] @ b32[rows, cols]
    return out


def matmul(a, b, mask, *, bm: int = TILE, bn: int = TILE, bk: int = TILE):
    """C = A @ (B under the tile mask); returns ``(M, N)`` float32."""
    mask = _check_mask(a, b, mask, bk, bn)
    if a.device.type == "cpu":
        return matmul_plain(a, b, mask, bk=bk, bn=bn)
    if a.device.type != "cuda":
        raise ValueError(f"unsupported device {a.device}")
    if (bm, bn, bk) != (TILE, TILE, TILE):
        raise ValueError(f"the kernel takes {TILE} x {TILE} x {TILE} "
                         f"tiles, not bm={bm} bn={bn} bk={bk}")
    if a.dtype not in _DTYPE:
        raise TypeError(f"operands must be float32 or bfloat16, got "
                        f"{a.dtype}")
    a, b = a.contiguous(), b.contiguous()
    return _launch(a, b, mask, producer_for(a, b))


def _launch(a, b, mask, producer: int):
    """The kernel on contiguous CUDA operands with the given bf16
    producer (ignored for f32); private, as gemm_dataflow's."""
    m, k = a.shape
    n = b.shape[1]
    out = torch.empty((m, n), dtype=torch.float32, device=a.device)
    if m == 0 or n == 0:
        return out
    if k == 0:
        return out.zero_()
    col_start, live_k = column_table(mask)
    table = torch.from_numpy(np.concatenate([col_start, live_k])
                             ).to(a.device)
    global launches
    launches += 1
    err = _kernel()(a.data_ptr(), b.data_ptr(), table.data_ptr(),
                    table.data_ptr() + 4 * col_start.size, out.data_ptr(),
                    m, n, k, _DTYPE[a.dtype], producer,
                    torch.cuda.current_stream(a.device).cuda_stream)
    if err:
        raise RuntimeError(f"block_sparse kernel launch failed: "
                           f"cudaError_t {err}")
    return out

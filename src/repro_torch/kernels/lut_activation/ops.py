"""LUT activation — the paper's In-DRAM Table Loader (§3.9): the CUDA
kernel's wrapper, its plain PyTorch version and the named tables.

An activation is a lookup: x is quantized to the paper's 16-bit grid
on [-8, 8) (``quantize_u16``: round half to even, clip to the table's
ends, NaN to entry 0) and y is gathered from a 2^16-entry float32
table that tabulates the function on that grid (``build_table``).
The result is exact for inputs on the grid.

``lut_activation(x, table)`` takes x of any shape, float32 or bfloat16,
and returns float32 of the same shape; ``apply_lut(x, name)`` uses the
named table of ``TABLES`` (Table 4's "unnecessary" CISC ops — complex
activations, VEXP, VDV — become lookup types).

The wrapper launches the kernel (``csrc/lut_activation.cu``) for CUDA
tensors and takes the plain version only for CPU tensors.
"""
from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from ..build import load

__all__ = ["LUT_LO", "LUT_HI", "LUT_ENTRIES", "STEP", "TABLES",
           "apply_lut", "build_table", "lut_activation", "lut_plain",
           "quantize_u16", "table_for"]

#: quantization grid (paper: 16-bit fixed point in [-8, 8))
LUT_LO, LUT_HI, LUT_ENTRIES = -8.0, 8.0, 1 << 16
STEP = (LUT_HI - LUT_LO) / LUT_ENTRIES          # 2^-12

#: kernel launches since the last reset (chip_smoke.py reads it)
launches = 0
#: the counters above by name: a CUDA graph of the serving programs
#: (``serve/compiled.py``) reads their rise during its capture and
#: adds it at each replay, which runs no Python
COUNTERS = ("launches",)

_fn = None
_DTYPE = {torch.float32: 0, torch.bfloat16: 1}

# jax.nn.gelu defaults to the tanh approximation; so does this table
TABLES = {
    "sigmoid": torch.sigmoid,
    "tanh": torch.tanh,
    "exp": torch.exp,
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
    "silu": F.silu,
    "relu": F.relu,
    "sqrt": lambda x: torch.sqrt(torch.clamp(x, min=0.0)),
    "recip": lambda x: torch.where(x.abs() < 1e-4, 0.0, 1.0 / x),
}


def _kernel():
    global _fn
    if _fn is None:
        f = load("lut_activation").repro_lut_activation
        f.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_longlong,
                                               ctypes.c_int,
                                               ctypes.c_void_p])
        f.restype = ctypes.c_int
        _fn = f
    return _fn


def quantize_u16(x):
    """Grid index of x (int32): round((x - LUT_LO) / STEP) half to even,
    clipped to [0, LUT_ENTRIES - 1]; NaN maps to 0."""
    t = torch.round((x.float() - LUT_LO) / STEP)
    t = torch.nan_to_num(torch.clamp(t, 0, LUT_ENTRIES - 1), nan=0.0)
    return t.to(torch.int32)


def build_table(fn):
    """Tabulate fn over the 2^16-entry grid (paper §3.9)."""
    grid = LUT_LO + torch.arange(LUT_ENTRIES, dtype=torch.float32) * STEP
    return fn(grid).to(torch.float32)


@functools.lru_cache(maxsize=None)
def table_for(name: str, device: str = "cpu"):
    """The named table, built once per device."""
    return build_table(TABLES[name]).to(device)


def lut_plain(x, table):
    """The kernel's function in plain PyTorch: quantize, then gather."""
    return table[quantize_u16(x).long()]


def lut_activation(x, table):
    """y = table[quantize_u16(x)] elementwise; float32, x's shape."""
    if tuple(table.shape) != (LUT_ENTRIES,):
        raise ValueError(f"table must be ({LUT_ENTRIES},), got "
                         f"{tuple(table.shape)}")
    if table.device != x.device:
        raise ValueError(f"table is on {table.device}, x on {x.device}")
    if x.device.type == "cpu":
        return lut_plain(x, table)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if x.dtype not in _DTYPE:
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    if table.dtype != torch.float32:
        raise TypeError(f"table must be float32, got {table.dtype}")
    x, table = x.contiguous(), table.contiguous()
    out = torch.empty(x.shape, dtype=torch.float32, device=x.device)
    if x.numel() == 0:
        return out
    global launches
    launches += 1
    err = _kernel()(x.data_ptr(), table.data_ptr(), out.data_ptr(),
                    x.numel(), _DTYPE[x.dtype],
                    torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError(f"lut_activation kernel launch failed: "
                           f"cudaError_t {err}")
    return out


def apply_lut(x, name: str):
    """Elementwise activation ``name`` through its 2^16-entry table."""
    return lut_activation(x, table_for(name, str(x.device)))

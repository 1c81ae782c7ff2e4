"""Dataflow-parameterised tiled matmul (paper §5.2, Table 6): the CUDA
kernel's wrapper, its plain PyTorch version and the HBM-traffic model.

``matmul(a, b, dataflow)`` computes C = A @ B with f32 accumulation and
an f32 output, for A ``(M, K)`` and B ``(K, N)`` both float32 or both
bfloat16.  The dataflow is the paper's reuse scheme, mapped onto the
order in which 128-tiles are visited; it decides which operand stays
resident on chip and how often the psum crosses device memory, never
the value:

    OUTPUT_STATIONARY  (paper: All Reuse)    psum resident, C written once
    WEIGHT_STATIONARY  (paper: Filter Reuse) B tile resident over the m sweep
    INPUT_STATIONARY   (paper: Ifmap Reuse)  A tile resident over the n sweep
    NO_REUSE           (paper: No Reuse)     k outermost, nothing resident

Every dataflow sums the same bk-deep tile products, each formed from
zero, in ascending k, so the kernel gives the same bits under all four.
``modeled_traffic`` is the Pallas pipeline's copy-elision model of the
bytes each order moves (the Table-6 ordering).

The wrapper launches the kernel (``csrc/gemm_dataflow.cu``) for CUDA
tensors and takes the plain version only for CPU tensors.  On ``meta``
tensors (the dry run, ``launch/dryrun.py``) it launches nothing: it
returns an empty output of the kernel's shape and dtype, allocates the
workspace the CUDA path would (the f32 plan at ``HW.n_sm`` SMs, an
H100's), and reports one launch and its ``cost`` to the dry run's
counter (``cost.py``).  For bf16
operands it also picks the producer that fills the kernel's shared-
memory ring (``producer_for``): TMA where the operands' bases and row
strides are 16-byte aligned, cp.async otherwise; both give the same
bits.  For f32 operands under OUTPUT_STATIONARY it picks the plan of
``csrc/gemm_f32.cuh`` (``plan_f32``: the output tile from the shape,
and a split of k over whole k tiles when the tiles leave SMs idle) and
allocates the split's workspace; every plan gives the same bits.

``LinearFn`` gives a projection ``x @ W`` its gradient through the same
kernel: forward the output-stationary product rounded once to x's
dtype (the serving path's bits), backward ``dX = dY W^T`` and ``dW =
X^T dY``, each an output-stationary product rounded once to its
operand's dtype (on the CPU the same products with ``@``).
"""
from __future__ import annotations

import ctypes
import enum
from typing import Dict, NamedTuple, Optional

import torch

from ... import cost as op_cost
from ...cost import HW
from ..build import load

__all__ = ["Dataflow", "matmul", "matmul_plain", "matmul_ref",
           "modeled_traffic", "producer_for", "TILE", "TMA", "CP_ASYNC",
           "LinearFn", "project", "project_f32", "plan_f32", "F32Plan",
           "cost"]

#: the kernel's tile (bm = bn = bk)
TILE = 128

#: the producers of the bf16 pipeline (csrc/wgmma_pipe.cuh)
TMA, CP_ASYNC = 0, 1

#: kernel launches since the last reset (chip_smoke.py reads them):
#: all of them, and those with float32 operands among them
launches = 0
launches_f32 = 0
#: the counters above by name: a CUDA graph of the serving programs
#: (``serve/compiled.py``) reads their rise during its capture and
#: adds it at each replay, which runs no Python
COUNTERS = ("launches", "launches_f32")

_fn = None


class Dataflow(enum.Enum):
    OUTPUT_STATIONARY = "output_stationary"   # paper: All Reuse
    WEIGHT_STATIONARY = "weight_stationary"   # paper: Filter Reuse
    INPUT_STATIONARY = "input_stationary"     # paper: Ifmap Reuse
    NO_REUSE = "no_reuse"                     # paper: No Reuse


_CODE = {Dataflow.OUTPUT_STATIONARY: 0, Dataflow.WEIGHT_STATIONARY: 1,
         Dataflow.INPUT_STATIONARY: 2, Dataflow.NO_REUSE: 3}
_DTYPE = {torch.float32: 0, torch.bfloat16: 1}


def _kernel():
    global _fn
    if _fn is None:
        f = load("gemm_dataflow").repro_gemm_dataflow
        f.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 9
                      + [ctypes.c_void_p] * 2)
        f.restype = ctypes.c_int
        _fn = f
    return _fn


def matmul_ref(a, b, out_dtype: Optional[torch.dtype] = None):
    """The oracle: one f32 product of the whole operands."""
    out_dtype = out_dtype or torch.promote_types(a.dtype, torch.float32)
    return (a.float() @ b.float()).to(out_dtype)


def matmul_plain(a, b, *, bk: int = TILE):
    """The kernel's function in plain PyTorch: f32 psum of the bk-deep
    tile products in ascending k, each product formed from zero and
    added with one rounding.  (Within a product, PyTorch's summation
    order is its own, so the kernel agrees to a tolerance, not bits.)"""
    m, k = a.shape
    n = b.shape[1]
    a32, b32 = a.float(), b.float()
    out = torch.zeros((m, n), dtype=torch.float32, device=a.device)
    for k0 in range(0, k, bk):
        out += a32[:, k0:k0 + bk] @ b32[k0:k0 + bk]
    return out


class F32Plan(NamedTuple):
    """How the f32 output-stationary kernel (``csrc/gemm_f32.cuh``)
    covers an (M, N, K) product: ``bm`` x ``bn`` output tiles, and the
    k tiles (``TILE`` deep) in ``chunks`` runs of ``tiles_per_chunk``
    consecutive tiles, one block per (output tile, run).  With more than
    one run every k tile's product goes to a workspace of
    ``workspace_floats`` floats and a second launch adds them."""
    bm: int
    bn: int
    tiles_per_chunk: int
    chunks: int
    workspace_floats: int


#: the f32 kernel's output tiles: rows, columns
F32_TILES_M = (8, 16, 32, 64, 128)
F32_TILES_N = (64, 128)
#: the largest workspace a split of k may take, in bytes
F32_WORKSPACE_CAP = 64 << 20


def plan_f32(m: int, n: int, k: int, n_sm: int) -> F32Plan:
    """The f32 output-stationary kernel's plan for an (M, N, K) product
    on a card of ``n_sm`` SMs.  The smallest row tile that holds M (128
    above); 128 columns only for M up to 64 rows that N fills, else 64
    (a 128 x 128 tile would fit one block an SM); a 128-row tile halved
    to 64 when N fits 64 columns and the tiles leave SMs idle.  When the
    output tiles still leave SMs idle, k is split into runs of whole k
    tiles, about one block an SM, unless the workspace (every k tile's
    product, nk x M x N floats) would exceed ``F32_WORKSPACE_CAP``.
    None of this changes a bit of the result."""
    nk = -(-k // TILE)
    bm = next((t for t in F32_TILES_M if t >= m), F32_TILES_M[-1])
    bn = F32_TILES_N[-1] if n > F32_TILES_N[0] and bm <= 64 else \
        F32_TILES_N[0]

    def tiles(rows):
        return -(-m // rows) * -(-n // bn)
    if bm == 128 and n <= F32_TILES_N[0] and tiles(bm) < n_sm:
        bm = 64
    out_tiles = tiles(bm)
    per, chunks = nk, 1
    if (out_tiles < n_sm and nk > 1
            and nk * m * n * 4 <= F32_WORKSPACE_CAP):
        per = -(-nk // min(nk, -(-n_sm // out_tiles)))
        chunks = -(-nk // per)
    return F32Plan(bm, bn, per, chunks, nk * m * n if chunks > 1 else 0)


_n_sm: Dict[int, int] = {}


def _sm_count(device) -> int:
    idx = device.index if device.index is not None else \
        torch.cuda.current_device()
    if idx not in _n_sm:
        _n_sm[idx] = torch.cuda.get_device_properties(
            idx).multi_processor_count
    return _n_sm[idx]


def cost(m: int, n: int, k: int, dtype: torch.dtype) -> tuple:
    """(flops, bytes) of an (M, N, K) product of ``dtype`` operands,
    whatever computes it: 2 M N K operations; A and B read once, the
    f32 C written once (the bound of PERF.md's kernel table)."""
    es = dtype.itemsize
    return 2 * m * n * k, (m * k + k * n) * es + m * n * 4


def producer_for(a, b) -> int:
    """The producer of the bf16 pipeline for row-major contiguous
    operands A ``(M, K)`` and B ``(K, N)``: ``TMA`` needs both bases
    16-byte aligned and both row strides (K and N elements) multiples
    of 16 bytes; anything else takes ``CP_ASYNC``, which writes the
    same swizzled layout."""
    row_a = a.shape[1] * a.element_size()
    row_b = b.shape[1] * b.element_size()
    aligned = (a.data_ptr() % 16 == 0 and b.data_ptr() % 16 == 0
               and row_a % 16 == 0 and row_b % 16 == 0)
    return TMA if aligned else CP_ASYNC


def _check(a, b):
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"shapes {tuple(a.shape)} @ {tuple(b.shape)} do "
                         "not chain")
    if a.device != b.device:
        raise ValueError(f"a is on {a.device}, b on {b.device}")
    if a.dtype != b.dtype:
        raise TypeError(f"a is {a.dtype}, b is {b.dtype}")


def matmul(a, b, dataflow: Dataflow = Dataflow.OUTPUT_STATIONARY, *,
           bm: int = TILE, bn: int = TILE, bk: int = TILE):
    """C = A @ B under ``dataflow``; returns ``(M, N)`` float32."""
    _check(a, b)
    dataflow = Dataflow(dataflow)
    if a.device.type == "cpu":
        return matmul_plain(a, b, bk=bk)
    if a.device.type not in ("cuda", "meta"):
        raise ValueError(f"unsupported device {a.device}")
    if (bm, bn, bk) != (TILE, TILE, TILE):
        raise ValueError(f"the kernel takes {TILE} x {TILE} x {TILE} "
                         f"tiles, not bm={bm} bn={bn} bk={bk}")
    if a.dtype not in _DTYPE:
        raise TypeError(f"operands must be float32 or bfloat16, got "
                        f"{a.dtype}")
    a, b = a.contiguous(), b.contiguous()
    if a.device.type == "meta":
        return _dry_launch(a, b, dataflow)
    return _launch(a, b, dataflow, producer_for(a, b))


def _dry_launch(a, b, dataflow: Dataflow):
    """``_launch`` on meta operands: the output and workspace the CUDA
    path allocates, and the launch it would make, reported to the dry
    run's counter; no kernel runs."""
    m, k = a.shape
    n = b.shape[1]
    out = torch.empty((m, n), dtype=torch.float32, device=a.device)
    if m == 0 or n == 0:
        return out
    if k == 0:
        return out.zero_()
    f32 = a.dtype == torch.float32
    if f32 and dataflow is Dataflow.OUTPUT_STATIONARY:
        plan = plan_f32(m, n, k, HW.n_sm)
        if plan.workspace_floats:
            torch.empty(plan.workspace_floats, dtype=torch.float32,
                        device=a.device)
    op_cost.kernel("gemm_dataflow", *cost(m, n, k, a.dtype),
                   also=("gemm_dataflow_f32",) if f32 else ())
    return out


def _launch(a, b, dataflow: Dataflow, producer: int):
    """The kernel on contiguous CUDA operands with the given bf16
    producer (ignored for f32).  Private: ``matmul`` picks the producer
    from the operands; chip_smoke.py forces each in turn to hold the
    two against each other."""
    m, k = a.shape
    n = b.shape[1]
    out = torch.empty((m, n), dtype=torch.float32, device=a.device)
    if m == 0 or n == 0:
        return out
    if k == 0:
        return out.zero_()
    plan, ws = F32Plan(0, 0, 0, 1, 0), None
    if a.dtype == torch.float32 and dataflow is Dataflow.OUTPUT_STATIONARY:
        plan = plan_f32(m, n, k, _sm_count(a.device))
        if plan.workspace_floats:
            ws = torch.empty(plan.workspace_floats, dtype=torch.float32,
                             device=a.device)
    global launches, launches_f32
    launches += 1
    launches_f32 += int(a.dtype == torch.float32)
    err = _kernel()(a.data_ptr(), b.data_ptr(), out.data_ptr(), m, n, k,
                    _CODE[dataflow], _DTYPE[a.dtype], producer, plan.bm,
                    plan.bn, plan.tiles_per_chunk,
                    None if ws is None else ws.data_ptr(),
                    torch.cuda.current_stream(a.device).cuda_stream)
    if err:
        raise RuntimeError(f"gemm_dataflow kernel launch failed: "
                           f"cudaError_t {err}")
    return out


def project(a, b):
    """``a @ b`` rounded once to a's dtype: on the card the output-
    stationary kernel (fixed 128-tiles, k ascending, so a row's bits do
    not depend on the rows of its call), on the CPU ``a @ b``."""
    if a.device.type == "cpu":
        return a @ b
    return matmul(a, b, Dataflow.OUTPUT_STATIONARY).to(a.dtype)


def project_f32(a, b):
    """``a @ b`` left in f32: the same kernel as ``project``, unrounded
    (a partial sum that is rounded once after it is added to the
    others); on the CPU ``a @ b`` in f32."""
    if a.device.type == "cpu":
        return a.float() @ b.float()
    return matmul(a, b, Dataflow.OUTPUT_STATIONARY)


class LinearFn(torch.autograd.Function):
    """``x @ w`` for x ``(M, K)`` and w ``(K, N)`` of one dtype, with its
    gradient: dX = dY w^T and dW = x^T dY through ``project`` (the
    transposes made contiguous first), each in its operand's dtype.
    ``f32_out``: the forward is ``project_f32`` (its gradient arrives in
    f32 and is rounded to x's dtype first).  ``skip``: save x and w as
    above but launch nothing, and return a placeholder of the output's
    shape and dtype (one element, expanded): a checkpoint's recompute
    that needs this product's operands but never its output
    (``components.linear``'s ``last``)."""

    @staticmethod
    def forward(ctx, x, w, f32_out=False, skip=False):
        ctx.save_for_backward(x, w)
        if skip:
            dtype = torch.float32 if f32_out else x.dtype
            return x.new_zeros((), dtype=dtype).expand(x.shape[0],
                                                        w.shape[1])
        return (project_f32 if f32_out else project)(x, w)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        dy = dy.to(x.dtype).contiguous()
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = project(dy, w.t().contiguous())
        if ctx.needs_input_grad[1]:
            dw = project(x.t().contiguous(), dy)
        return dx, dw, None, None


def modeled_traffic(m: int, n: int, k: int, dataflow: Dataflow,
                    *, bm: int = 128, bn: int = 128, bk: int = 128,
                    bytes_per_elem: int = 2) -> Dict[str, float]:
    """HBM bytes under the pipeline's copy-elision rule: a block is
    fetched again iff its index changed since the previous grid step."""
    nm, nn, nk = -(-m // bm), -(-n // bn), -(-k // bk)
    a_blk = bm * bk * bytes_per_elem
    b_blk = bk * bn * bytes_per_elem
    o_blk = bm * bn * 4                      # f32 psums/out
    if dataflow is Dataflow.OUTPUT_STATIONARY:
        a_loads = nm * nn * nk               # A changes with (i, kk)
        b_loads = nm * nn * nk
        o_writes = nm * nn                   # written once
        o_reads = 0
    elif dataflow is Dataflow.WEIGHT_STATIONARY:
        a_loads = nn * nk * nm
        b_loads = nn * nk                    # B constant over inner m
        o_writes = nn * nk * nm
        o_reads = nn * (nk - 1) * nm
    elif dataflow is Dataflow.INPUT_STATIONARY:
        a_loads = nm * nk                    # A constant over inner n
        b_loads = nm * nk * nn
        o_writes = nm * nk * nn
        o_reads = nm * (nk - 1) * nn
    else:                                    # NO_REUSE
        a_loads = nk * nm * nn
        b_loads = nk * nm * nn
        o_writes = nk * nm * nn
        o_reads = (nk - 1) * nm * nn
    return {
        "a_bytes": a_loads * a_blk,
        "b_bytes": b_loads * b_blk,
        "out_bytes": o_writes * o_blk + o_reads * o_blk,
        "total_bytes": (a_loads * a_blk + b_loads * b_blk
                        + (o_writes + o_reads) * o_blk),
    }

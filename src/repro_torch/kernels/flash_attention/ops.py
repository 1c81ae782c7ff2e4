"""Blocked attention with an online softmax (whole-prompt and chunked
prefill): the CUDA kernel's wrapper and its plain PyTorch version.

``flash_attention(q, k, v, q_offset=0, causal=True, window=None)``:

* q ``(B, Sq, H, Dh)``; k/v ``(B, Skv, KVH, Dh)``, Dh 64, 128 or 256;
  ``q_offset`` an int or a ``(B,)`` int32 tensor — query i of row b
  sits at absolute position ``p = q_offset[b] + i``.
* Key j is visible to that query iff ``j < Skv``, if causal ``j <= p``,
  and with a ``window`` ``j > p - window``: the function of
  ``repro.models.components.flash_attention`` (per-row offset, ragged
  Skv, sliding window, GQA with kv head ``h // (H // KVH)``).
* Keys are walked in fixed KV_TILE tiles anchored at position 0, so a
  row's result depends only on its own keys and offset: attention over
  a longer padded buffer with the same leading keys is bit-identical.

The wrapper launches the kernel (``csrc/flash_attention.cu``) for CUDA
tensors and takes the plain version only for CPU tensors.  On ``meta``
tensors (the dry run, ``launch/dryrun.py``) the forward and the
backward launch nothing: they return empty outputs of the kernels'
shapes and dtypes, allocate the CUDA path's workspaces (the backward's
from ``plan_dkdv``) and report each launch and its ``cost`` to the dry
run's counter (``cost.py``).  The head dims the kernels
refuse are refused on the card only: the dry run traces the smoke
configs (Dh 16) too.

Training: ``FlashAttentionFn`` gives the attention a gradient.  Its
forward is the kernel with the per-row log-sum-exp as a second output;
its backward is the hand-written kernels of
``csrc/flash_attention_bwd.cu`` (``flash_attention_bwd``: dQ, then dK
and dV, the long dK/dV walks cut into runs by ``plan_dkdv`` and their
f32 partials added in run order by a third kernel; no atomics, so a
step is a deterministic function of its inputs), whose plain version is
``flash_attention_bwd_plain``.  The backward covers every attention the
reference trains: causal or not, a sliding ``window`` (local
attention), Sq != Skv (cross-attention), Dh 64, 128 or 256, q_offset 0
(no training path passes another).

A call with no heads (H = KVH = 0: a rank of ``model`` that holds none,
``sharding.spmd.rank_heads``) launches nothing and returns empty
results, forward and backward.
"""
from __future__ import annotations

import ctypes
import math
from typing import Dict, NamedTuple, Tuple

import numpy as np
import torch

from ... import cost as op_cost
from ..build import load

__all__ = ["flash_attention", "flash_attention_plain", "KV_TILE",
           "flash_attention_lse", "flash_attention_bwd",
           "flash_attention_bwd_plain", "FlashAttentionFn",
           "flash_attention_train", "plan_dkdv", "DkdvPlan",
           "walk_bounds", "cost", "visible_pairs"]

#: keys per online-softmax step — the kernel's tile
KV_TILE = 64
NEG_INF = -1e30

#: kernel launches since the last reset (chip_smoke.py reads them):
#: the forward's, and the backward's (one a ``flash_attention_bwd``
#: call, which runs the dQ kernel and then the dK/dV kernel)
launches = 0
bwd_launches = 0
#: the counters above by name: a CUDA graph of the serving programs
#: (``serve/compiled.py``) reads their rise during its capture and
#: adds it at each replay, which runs no Python
COUNTERS = ("launches", "bwd_launches")

#: the backward kernel's head dims (the plain version takes any)
BWD_HEAD_DIMS = (64, 128, 256)

_fn = None
_bwd_fn = None


def _kernel():
    global _fn
    if _fn is None:
        f = load("flash_attention").repro_flash_attention_bf16
        f.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 8
                      + [ctypes.c_void_p] * 2)
        f.restype = ctypes.c_int
        _fn = f
    return _fn


def _bwd_kernel():
    global _bwd_fn
    if _bwd_fn is None:
        f = load("flash_attention_bwd").repro_flash_attention_bwd_bf16
        f.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int, ctypes.c_void_p,
                                                ctypes.c_int, ctypes.c_void_p]
                      + [ctypes.c_int] * 8 + [ctypes.c_void_p])
        f.restype = ctypes.c_int
        _bwd_fn = f
    return _bwd_fn


def _offsets(q_offset, B: int, device) -> torch.Tensor:
    if isinstance(q_offset, torch.Tensor):
        if q_offset.dim() == 0:
            q_offset = q_offset.reshape(1).expand(B)
        if tuple(q_offset.shape) != (B,):
            raise ValueError(f"q_offset must be a scalar or (B,)=({B},), "
                             f"got {tuple(q_offset.shape)}")
        return q_offset.to(device=device, dtype=torch.int32).contiguous()
    return torch.full((B,), int(q_offset), dtype=torch.int32, device=device)


#: query rows the plain version takes at once (bounds its temporaries)
PLAIN_ROWS = 256


def flash_attention_plain(q, k, v, q_offset=0, causal: bool = True,
                          window=None, return_lse: bool = False):
    """The kernel's function in plain PyTorch, with the kernel's tile
    partition and dtype contract (f32 scores and accumulation, p rounded
    to the value dtype before P.V).  Products are summed with
    ``(a * b).sum(-1)`` over a fixed length rather than ``matmul``: on
    the CPU an f32 GEMM's summation order depends on the number of rows,
    and chunked == whole prefill needs each row's bits to depend on that
    row alone.  Query rows go PLAIN_ROWS at a time (a row's result does
    not depend on the others).  With ``return_lse`` also each row's
    log-sum-exp of its scaled scores, f32 ``(B, H, Sq)``."""
    B, Sq = q.shape[:2]
    offs = _offsets(q_offset, B, q.device)
    # the rows' first position where the host knows it: a tensor offset
    # is read on the device only (a CUDA graph's replay, or its CPU
    # stand-in, reads no value), and its rows walk every tile
    host = None if isinstance(q_offset, torch.Tensor) else int(q_offset)
    parts = [_plain_rows(q[:, i:i + PLAIN_ROWS], k, v, offs + i, causal,
                         window, None if host is None else host + i)
             for i in range(0, Sq, PLAIN_ROWS)]
    if not parts:
        out = torch.empty_like(q)
        lse = q.new_empty((B, q.shape[2], 0), dtype=torch.float32)
    else:
        out = torch.cat([o for o, _ in parts], 1)
        lse = torch.cat([l for _, l in parts], 2)
    return (out, lse) if return_lse else out


def _plain_rows(q, k, v, offs, causal, window, first):
    """Rows whose offsets are ``offs``; ``first``: the first row's
    position where the host knows it (every row of the call then has
    one offset), else None."""
    B, Sq, H, Dh = q.shape
    Skv, KVH = k.shape[1], k.shape[2]
    G = H // KVH
    dev = q.device
    scale = 1.0 / math.sqrt(Dh)
    q_pos = offs.long()[:, None] + torch.arange(Sq, device=dev)[None]
    # tiles no row sees change no bit: one masked for every row before
    # the first seen tile is wiped by that tile's rescale (alpha = 0),
    # one after the last adds p = 0 (see the kernel); with the
    # positions on the host, the walk skips them
    kbeg, kend = 0, Skv
    if causal and Sq and first is not None:
        kend = min(Skv, first + Sq)
    if window is not None and Sq and first is not None:
        kbeg = max(0, first - window + 1) // KV_TILE * KV_TILE
    qh = q.float().reshape(B, Sq, KVH, G, Dh).permute(0, 2, 3, 1, 4)
    m = torch.full((B, KVH, G, Sq), NEG_INF, dtype=torch.float32,
                   device=dev)
    l = torch.zeros((B, KVH, G, Sq), dtype=torch.float32, device=dev)
    acc = torch.zeros((B, KVH, G, Sq, Dh), dtype=torch.float32, device=dev)
    for j0 in range(kbeg, kend, KV_TILE):
        j = j0 + torch.arange(KV_TILE, device=dev)
        in_kv = j < Skv
        jc = j.clamp(max=Skv - 1)
        kt = torch.where(in_kv[None, :, None, None], k[:, jc].float(), 0.0)
        vt = torch.where(in_kv[None, :, None, None], v[:, jc].float(), 0.0)
        kt = kt.permute(0, 2, 1, 3)                     # (B, KVH, KV_TILE, Dh)
        vt = vt.permute(0, 2, 3, 1)                     # (B, KVH, Dh, KV_TILE)
        s = (qh[..., None, :] * kt[:, :, None, None]).sum(-1) * scale
        mask = in_kv[None, None, :]
        if causal:
            mask = mask & (j[None, None, :] <= q_pos[..., None])
        if window is not None:
            mask = mask & (j[None, None, :] > q_pos[..., None] - window)
        mask = mask.expand(B, Sq, KV_TILE)
        s = torch.where(mask[:, None, None], s, NEG_INF)
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.exp(s - m_new[..., None])
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(-1)
        pb = p.to(v.dtype).float()
        pv = (pb[..., None, :] * vt[:, :, None, None]).sum(-1)
        acc = acc * alpha[..., None] + pv
        m = m_new
    den = torch.clamp(l, min=1e-30)
    out = acc / den[..., None]                           # (B,KVH,G,Sq,Dh)
    lse = (m + torch.log(den)).reshape(B, H, Sq)
    return (out.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, Dh).to(q.dtype),
            lse)


def visible_pairs(Sq: int, Skv: int, causal: bool = True, window=None,
                  q_offset: int = 0) -> int:
    """The query-key pairs of one (batch row, head) that the mask lets
    through: query i at position p = q_offset + i sees key j iff j <
    Skv, if causal j <= p, and with a window j > p - window."""
    p = q_offset + np.arange(Sq, dtype=np.int64)
    hi = np.minimum(p, Skv - 1) if causal else np.full(Sq, Skv - 1)
    lo = np.maximum(0, p - window + 1) if window is not None else 0
    return int(np.maximum(0, hi - lo + 1).sum())


def cost(B: int, Sq: int, Skv: int, H: int, KVH: int, Dh: int,
         causal: bool = True, window=None, q_offset: int = 0,
         lse: bool = False, backward: bool = False) -> tuple:
    """(flops, bytes) of the attention of B rows of Sq queries over Skv
    keys (H query heads, KVH kv heads of Dh), whatever computes it:
    4 Dh operations a visible query-key pair (``visible_pairs``, exact
    for causal, window and ragged rows) forward; the backward 2.5 times
    that (five products of its size).  Bytes: forward q, the keys and
    values up to the last visible one, the output, the offsets (and
    with ``lse`` the f32 log-sum-exps); backward q, k, v, dout, lse, dq,
    dk and dv (the bound of PERF.md's kernel table)."""
    flops = 4 * Dh * H * B * visible_pairs(Sq, Skv, causal, window,
                                           q_offset)
    q_el, kv_el = B * Sq * H * Dh, B * Skv * KVH * Dh
    if backward:
        return 2.5 * flops, (3 * q_el + 4 * kv_el) * 2 + B * H * Sq * 4
    keys = min(Skv, q_offset + Sq) if causal else Skv
    return flops, (2 * q_el + 2 * B * keys * KVH * Dh) * 2 + B * 4 + (
        B * H * Sq * 4 if lse else 0)


def _check(q, k, v):
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError("q must be (B,Sq,H,Dh) and k/v (B,Skv,KVH,Dh)")
    B, Sq, H, Dh = q.shape
    if k.shape[0] != B or k.shape[3] != Dh:
        raise ValueError(f"k/v {tuple(k.shape)} do not match "
                         f"q {tuple(q.shape)}")
    if (H % k.shape[2]) if k.shape[2] else H:
        raise ValueError(f"H={H} is not a multiple of KVH={k.shape[2]}")


def flash_attention(q, k, v, q_offset=0, causal: bool = True,
                    window=None):
    """See the module docstring.  Returns ``(B, Sq, H, Dh)`` in q's
    dtype."""
    return _forward(q, k, v, q_offset, causal, window, False)


def flash_attention_lse(q, k, v, causal: bool = True, window=None,
                        q_offset=0):
    """``(out, lse)``, lse the f32 ``(B, H, Sq)`` log-sum-exp of each
    row's scaled scores, written by the kernel beside the same ``out``
    bits: the forward that training saves for the backward (q_offset
    0), and a decode step's partial over one shard of a cache split
    along its sequence."""
    return _forward(q, k, v, q_offset, causal, window, True)


def _forward(q, k, v, q_offset, causal, window, want_lse):
    _check(q, k, v)
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    if q.shape[2] == 0:
        # no heads (a rank of model that holds none): nothing to launch
        lse = q.new_empty((q.shape[0], 0, q.shape[1]),
                          dtype=torch.float32)
        return (torch.empty_like(q), lse) if want_lse else torch.empty_like(q)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, q_offset, causal, window,
                                     return_lse=want_lse)
    if q.device.type not in ("cuda", "meta"):
        raise ValueError(f"unsupported device {q.device}")
    B, Sq, H, Dh = q.shape
    Skv, KVH = k.shape[1], k.shape[2]
    qo = _offsets(q_offset, B, q.device)
    for name, t, dt in (("q", q, torch.bfloat16),
                        ("k", k, torch.bfloat16),
                        ("v", v, torch.bfloat16),
                        ("q_offset", qo, torch.int32)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if t.dtype != dt:
            raise TypeError(f"{name} must be {dt}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        # bf16 operands are read 16 bytes (8 values) at a time; the
        # int32 tables are read one value at a time
        if dt == torch.bfloat16 and t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    if q.is_cuda and Dh not in (64, 128, 256):
        raise ValueError(f"head_dim {Dh} unsupported (64, 128 or 256)")
    out = torch.empty_like(q)
    lse = (torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
           if want_lse else None)
    if B and Sq and q.device.type == "meta":
        # the offsets' values are not known on meta: a tensor offset
        # counts as rows ending at the last key (a chunk at the end)
        off = Skv - Sq if isinstance(q_offset, torch.Tensor) else q_offset
        op_cost.kernel("flash_attention", *cost(
            B, Sq, Skv, H, KVH, Dh, causal, window, off, want_lse))
    elif B and Sq:
        global launches
        launches += 1
        err = _kernel()(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                        qo.data_ptr(), out.data_ptr(), B, Sq, Skv, H, KVH,
                        Dh, int(causal), int(window or 0),
                        None if lse is None else lse.data_ptr(),
                        torch.cuda.current_stream(q.device).cuda_stream)
        if err:
            raise RuntimeError(f"flash_attention kernel launch failed: "
                               f"cudaError_t {err}")
    return (out, lse) if want_lse else out


# ------------------------------------------------------------ backward
def _check_bwd(q, k, v, window=None):
    """What the backward takes: any forward shape at q_offset 0."""
    _check(q, k, v)
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    if q.is_cuda and q.shape[3] not in BWD_HEAD_DIMS:
        raise ValueError(f"the attention backward kernel takes head_dim "
                         f"{BWD_HEAD_DIMS}, got {q.shape[3]}")


def walk_bounds(t, nq: int, causal: bool, window):
    """(first, last) query tile that can see key tile ``t`` (an int or
    an int tensor) of ``nq`` query tiles at q_offset 0: causal from the
    key tile's own tile, else from 0; under a window up to the tile of
    the last query within ``window`` positions of the tile's last key.
    ``first > last`` when no query sees it."""
    first = t if causal else t * 0
    if window is None:
        return first, t * 0 + nq - 1
    last = (t * KV_TILE + KV_TILE - 2 + window) // KV_TILE
    if isinstance(last, torch.Tensor):
        return first, last.clamp(max=nq - 1)
    return first, min(last, nq - 1)


class DkdvPlan(NamedTuple):
    """How the dK/dV kernel covers the key tiles of one (kv head, batch
    row).  The walk of key tile t runs ``steps(t)`` steps, step i being
    query head ``i // per_head`` of the kv head's G and query tile
    ``first + i % per_head``, (first, last) = ``walk_bounds(t)`` and
    per_head = last - first + 1 (0 when no query sees the tile: its
    walk is one block of no steps, which writes zeros).  A walk longer
    than ``chunk`` steps is cut into runs of ``chunk`` steps, one block
    each, whose f32 partials go to workspace slots ``first_slot,
    first_slot + 1, ...``; ``splits`` lists those walks and a combine
    adds their runs in ascending order.  ``items`` are the blocks,
    longest first: (key tile, step0, step1, slot, -1 when the block
    writes the whole walk)."""
    chunk: int
    items: Tuple[Tuple[int, int, int, int], ...]
    splits: Tuple[Tuple[int, int, int], ...]
    n_slots: int


#: a dK/dV walk is cut into runs of at most
#: max(DKDV_MIN_CHUNK, ceil(longest walk / DKDV_RUNS)) steps
DKDV_MIN_CHUNK, DKDV_RUNS = 8, 2


def plan_dkdv(Sq: int, Skv: int, G: int, causal: bool = True,
              window=None) -> DkdvPlan:
    """The dK/dV plan for Sq queries and Skv keys (tiles of KV_TILE), G
    query heads a kv head, the mask (causal, window); it depends on
    nothing else, so every batch row and kv head sums its gradients in
    the same order."""
    nq, nk = -(-Sq // KV_TILE), -(-Skv // KV_TILE)
    steps = []
    for t in range(nk):
        first, last = walk_bounds(t, nq, causal, window)
        steps.append(G * max(0, last - first + 1))
    chunk = max(DKDV_MIN_CHUNK, -(-max(steps, default=0) // DKDV_RUNS))
    items, splits, slot = [], [], 0
    for t, n in enumerate(steps):
        if n <= chunk:
            items.append((t, 0, n, -1))
            continue
        runs = [(i, min(n, i + chunk)) for i in range(0, n, chunk)]
        splits.append((t, slot, len(runs)))
        items += [(t, i0, i1, slot + c) for c, (i0, i1) in enumerate(runs)]
        slot += len(runs)
    items.sort(key=lambda it: (it[1] - it[2], it[0]))
    return DkdvPlan(chunk, tuple(items), tuple(splits), slot)


def flash_attention_bwd_plain(q, k, v, lse, dout, causal: bool = True,
                              window=None):
    """The backward kernels' function in plain PyTorch: (dq, dk, dv) in
    the inputs' dtypes from the forward's ``lse``.  P = exp(S scale -
    lse) on the forward's mask, dP = dout V^T, D = rowsum(P dP) and dS =
    P (dP - D) in f32 (D from the forward's output, rounded to its dtype,
    would leave each dS row a residue that a large component the keys
    share turns into dQ and Wk gradient: the kernel's header); P and dS
    are rounded to the value dtype where they enter a product (as the
    kernels round them to bf16).  Query
    heads, then query tiles of KV_TILE rows, in ascending order, as the
    dK/dV walks run them; each key tile's dK and dV are summed in f32
    run by run of ``plan_dkdv``, and the runs added in ascending
    order."""
    _check_bwd(q, k, v, window)
    B, Sq, H, Dh = q.shape
    Skv, KVH = k.shape[1], k.shape[2]
    G = H // KVH
    dt = q.dtype
    scale = 1.0 / math.sqrt(Dh)
    dev = q.device

    def heads(t):                       # (B, Sq, H, Dh) -> (B,KVH,G,Sq,Dh)
        return t.float().reshape(B, Sq, KVH, G, Dh).permute(0, 2, 3, 1, 4)
    qf, dof = heads(q), heads(dout)
    kf = k.float().permute(0, 2, 1, 3)                 # (B,KVH,Skv,Dh)
    vf = v.float().permute(0, 2, 1, 3)
    lse = lse.float().reshape(B, KVH, G, Sq)
    plan = plan_dkdv(Sq, Skv, G, causal, window)
    nq = -(-Sq // KV_TILE)
    j = torch.arange(Skv, device=dev)
    first, last = walk_bounds(j // KV_TILE, nq, causal, window)
    per_head = (last - first + 1).clamp(min=0)
    n_runs = max([1 + (i1 - 1) // plan.chunk
                  for _, _, i1, _ in plan.items if i1], default=1)
    dq = torch.zeros_like(qf)
    part = torch.zeros((2, n_runs, B, KVH, Skv, Dh), dtype=torch.float32,
                       device=dev)                     # dk, dv runs
    for g in range(G):
        for qt in range(nq):
            rows = slice(qt * KV_TILE, (qt + 1) * KV_TILE)
            i = torch.arange(Sq, device=dev)[rows, None]
            s = qf[:, :, g, rows] @ kf.transpose(-1, -2)   # (B,KVH,T,Skv)
            p = torch.exp(s * scale - lse[:, :, g, rows, None])
            vis = torch.ones((len(i), Skv), dtype=torch.bool, device=dev)
            if causal:
                vis = vis & (j[None] <= i)
            if window is not None:
                vis = vis & (j[None] > i - window)
            p = torch.where(vis, p, 0.0)
            dp = dof[:, :, g, rows] @ vf.transpose(-1, -2)
            ds = p * (dp - (p * dp).sum(-1, keepdim=True))
            pb, dsb = p.to(dt).float(), ds.to(dt).float()
            dq[:, :, g, rows] = dsb @ kf
            steps = (dsb.transpose(-1, -2) @ qf[:, :, g, rows],
                     pb.transpose(-1, -2) @ dof[:, :, g, rows])
            # the run of this walk step in each key tile's walk
            run = (g * per_head + qt - first) // plan.chunk
            seen = (qt >= first) & (qt <= last)
            for c in run[seen].unique().tolist():
                keys = torch.nonzero(seen & (run == c)).squeeze(1)
                for x, step in enumerate(steps):
                    part[x, c].index_add_(2, keys, step.index_select(2, keys))
    dk = torch.zeros((B, KVH, Skv, Dh), dtype=torch.float32, device=dev)
    dv = torch.zeros_like(dk)
    for c in range(n_runs):
        dk, dv = dk + part[0, c], dv + part[1, c]
    dq = (dq * scale).permute(0, 3, 1, 2, 4).reshape(B, Sq, H, Dh)
    dk, dv = ((t.permute(0, 2, 1, 3)).to(dt) for t in (dk * scale, dv))
    return dq.to(dt), dk, dv


_plan_tables: Dict[tuple, tuple] = {}


def _dkdv_tables(Sq: int, Skv: int, G: int, causal: bool, window, device):
    """``plan_dkdv``'s items and splits as int32 (n, 4) tensors on
    ``device`` (kept for the next call with the same shapes and mask)."""
    key = (Sq, Skv, G, causal, window, str(device))
    if key not in _plan_tables:
        plan = plan_dkdv(Sq, Skv, G, causal, window)
        items = torch.tensor(plan.items, dtype=torch.int32, device=device)
        splits = torch.tensor([sp + (0,) for sp in plan.splits] or
                              [(0, 0, 0, 0)], dtype=torch.int32,
                              device=device)
        _plan_tables[key] = (plan, items, splits)
    return _plan_tables[key]


def flash_attention_bwd(q, k, v, lse, dout, causal: bool = True,
                        window=None):
    """(dq, dk, dv) of ``flash_attention(q, k, v, causal=causal,
    window=window)`` given its ``lse`` (``flash_attention_lse``) and the
    output's gradient ``dout``: the kernels for CUDA tensors, the plain
    version for CPU tensors."""
    _check_bwd(q, k, v, window)
    if q.shape[2] == 0:
        return torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, lse, dout, causal, window)
    if q.device.type not in ("cuda", "meta"):
        raise ValueError(f"unsupported device {q.device}")
    B, Sq, H, Dh = q.shape
    Skv, KVH = k.shape[1], k.shape[2]
    for name, t in (("q", q), ("k", k), ("v", v), ("dout", dout),
                    ("lse", lse)):
        want = torch.float32 if name == "lse" else torch.bfloat16
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if t.dtype != want:
            raise TypeError(f"{name} must be {want}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    if dout.shape != q.shape:
        raise ValueError("dout must have q's shape")
    if tuple(lse.shape) != (B, H, Sq):
        raise ValueError(f"lse must be (B, H, Sq) = {(B, H, Sq)}, got "
                         f"{tuple(lse.shape)}")
    dq = torch.empty_like(q)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    if B == 0 or Sq == 0 or Skv == 0:
        return dq.zero_(), dk.zero_(), dv.zero_()
    dsum = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    if q.device.type == "meta":
        plan = plan_dkdv(Sq, Skv, H // KVH, causal, window)
        if plan.n_slots:
            torch.empty(plan.n_slots * B * KVH * 2 * KV_TILE * Dh,
                        dtype=torch.float32, device=q.device)
        op_cost.kernel("flash_attention_bwd", *cost(
            B, Sq, Skv, H, KVH, Dh, causal, window, backward=True))
        return dq, dk, dv
    plan, items, splits = _dkdv_tables(Sq, Skv, H // KVH, causal, window,
                                       q.device)
    ws = None
    if plan.n_slots:
        ws = torch.empty(plan.n_slots * B * KVH * 2 * KV_TILE * Dh,
                         dtype=torch.float32, device=q.device)
    global bwd_launches
    bwd_launches += 1
    err = _bwd_kernel()(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                        dout.data_ptr(), lse.data_ptr(),
                        dsum.data_ptr(), dq.data_ptr(), dk.data_ptr(),
                        dv.data_ptr(), items.data_ptr(), len(plan.items),
                        splits.data_ptr(), len(plan.splits),
                        None if ws is None else ws.data_ptr(), B, Sq, Skv,
                        H, KVH, Dh, int(causal), int(window or 0),
                        torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(f"flash_attention_bwd kernel launch failed: "
                           f"cudaError_t {err}")
    return dq, dk, dv


class FlashAttentionFn(torch.autograd.Function):
    """Attention with a gradient: ``flash_attention_lse`` forward,
    ``flash_attention_bwd`` backward (the kernels on the card, the plain
    versions on the CPU)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window):
        out, lse = flash_attention_lse(q, k, v, causal, window)
        ctx.causal, ctx.window = causal, window
        ctx.save_for_backward(q, k, v, lse)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, lse, dout.contiguous(),
                                         ctx.causal, ctx.window)
        return dq, dk, dv, None, None


def flash_attention_train(q, k, v, q_offset=0, causal: bool = True,
                          window=None):
    """``flash_attention`` with a gradient (``FlashAttentionFn``).  A
    non-zero q_offset raises: no training path of the reference passes
    one (its training forwards attend whole sequences from position
    0)."""
    if isinstance(q_offset, torch.Tensor) or q_offset != 0:
        raise ValueError("the attention backward takes q_offset 0: no "
                         "training path attends from another position")
    _check_bwd(q, k, v, window)
    return FlashAttentionFn.apply(q, k, v, causal, window)

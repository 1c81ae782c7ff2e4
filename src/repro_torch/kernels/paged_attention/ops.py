"""Paged attention (decode and speculative verification) over a bf16
KV page pool: the CUDA kernel's wrapper and its plain PyTorch version.

``paged_attention(q, k_pages, v_pages, page_tables, lengths)``:

* q ``(B, T, H, Dh)``; k/v_pages ``(P, ps, KVH, Dh)`` (one layer's
  pool); page_tables ``(B, n)`` int32; lengths ``(B,)`` int32 — tokens
  resident *before* this call's T queries were written.
* Query t of row b sits at position ``lengths[b] + t`` and attends the
  gathered keys ``j <= lengths[b] + t`` (clipped to the ``n * ps`` keys
  the table covers): ``paged_verify_attention_ref``'s semantics, which
  at T = 1 are the decode step's (``paged_attention_ref`` with
  ``lengths + 1``).
* Every table entry must name a page of the pool (the null page 0
  included); the kernel does not validate them.

The wrapper launches the kernel (``csrc/paged_attention.cu``) for CUDA
tensors and takes the plain version only for CPU tensors.  On ``meta``
tensors (the dry run, ``launch/dryrun.py``) it launches nothing: it
returns an empty output, allocates the split partials' workspace the
CUDA path allocates and reports one launch and its ``cost`` to the dry
run's counter (``cost.py``); the kernel's head dims are
refused on the card only.
"""
from __future__ import annotations

import ctypes
import math

import torch

from ... import cost as op_cost
from ..build import load

__all__ = ["paged_attention", "paged_attention_plain", "KV_TILE",
           "SPLIT", "cost"]

#: keys per online-softmax step, anchored at position 0 — the same
#: partition as the kernel, independent of the page size
KV_TILE = 64
#: keys of one split (one block of the kernel), anchored at position 0:
#: a row's result combines its splits' partials in ascending order
SPLIT = 128
ROWS = 16                  # query rows (t, g) per block: one m16 tile
NEG_INF = -1e30

#: kernel launches since the last reset (chip_smoke.py reads it)
launches = 0
#: the counters above by name: a CUDA graph of the serving programs
#: (``serve/compiled.py``) reads their rise during its capture and
#: adds it at each replay, which runs no Python
COUNTERS = ("launches",)

_fn = None
# (device index, stream) -> int32 zeros, one per (b, kv head, row
# group); the kernel leaves them zero after each launch.  A buffer
# outgrown by a larger call is kept, never freed: a CUDA graph captured
# on that stream (``serve/compiled.py``) reads it by address
_counters = {}
_outgrown = []


def _kernel():
    global _fn
    if _fn is None:
        lib = load("paged_attention")
        lib.repro_paged_attention_split.restype = ctypes.c_int
        built = lib.repro_paged_attention_split()
        if built != SPLIT:
            raise RuntimeError(f"paged_attention kernel splits keys by "
                               f"{built}, the wrapper by {SPLIT}")
        f = lib.repro_paged_attention_bf16
        f.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 7
                      + [ctypes.c_void_p])
        f.restype = ctypes.c_int
        _fn = f
    return _fn


def _counter_buffer(device, stream: int, size: int):
    buf = _counters.get((device.index, stream))
    if buf is None or buf.numel() < size:
        if buf is not None:
            _outgrown.append(buf)
        buf = torch.zeros(max(size, 1024), dtype=torch.int32, device=device)
        _counters[(device.index, stream)] = buf
    return buf


def _split_partials(qh, k_pages, v_pages, tables, row_limit, s, scale):
    """Row max m, denominator l and unnormalised output acc of split s
    (keys s * SPLIT ..), each row over its keys in the split: the
    online softmax over the split's KV_TILE tiles, f32 scores, p rounded
    to the value dtype before P.V.  A row with no key in the split gets
    m = -1e30 and garbage l and acc, which the combine never reads."""
    B, KVH, R, Dh = qh.shape
    ps = k_pages.shape[1]
    cover = tables.shape[1] * ps
    dev = qh.device
    m = torch.full((B, KVH, R), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((B, KVH, R), dtype=torch.float32, device=dev)
    acc = torch.zeros((B, KVH, R, Dh), dtype=torch.float32, device=dev)
    for j0 in range(s * SPLIT, (s + 1) * SPLIT, KV_TILE):
        j = j0 + torch.arange(KV_TILE, device=dev)
        in_cover = (j < cover)[None, :, None, None]
        jc = j.clamp(max=cover - 1)
        pid, slot = tables[:, jc // ps], jc % ps                # (B, KV_TILE)
        k = torch.where(in_cover, k_pages[pid, slot].float(), 0.0)
        v = torch.where(in_cover, v_pages[pid, slot].float(), 0.0)
        k = k.permute(0, 2, 1, 3)                       # (B, KVH, KV_TILE, Dh)
        v = v.permute(0, 2, 3, 1)                       # (B, KVH, Dh, KV_TILE)
        sc = (qh[:, :, :, None, :] * k[:, :, None]).sum(-1) * scale
        valid = j[None, None, :] < row_limit[:, :, None]     # (B, R, KV_TILE)
        sc = torch.where(valid[:, None], sc, NEG_INF)
        m_new = torch.maximum(m, sc.amax(-1))
        p = torch.exp(sc - m_new[..., None])
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(-1)
        pb = p.to(v_pages.dtype).float()
        pv = (pb[:, :, :, None, :] * v[:, :, None]).sum(-1)     # (B,KVH,R,Dh)
        acc = acc * alpha[..., None] + pv
        m = m_new
    return m, l, acc


def paged_attention_plain(q, k_pages, v_pages, page_tables, lengths):
    """The kernel's function in plain PyTorch, with the kernel's
    partition and dtype contract: keys in splits of SPLIT anchored at
    position 0 (KV_TILE tiles within a split), f32 scores and
    accumulation, p rounded to the value dtype before P.V; each split's
    partials (m, l, acc) combined per row over exactly the splits that
    hold at least one of the row's keys, in ascending split order:
    O = sum w_s acc_s, L = sum w_s l_s, w_s = exp(m_s - max m), and
    out = O / L.  Products are summed with ``(a * b).sum(-1)`` over a
    fixed length rather than ``matmul``: on the CPU an f32 GEMM's
    summation order depends on the number of rows, and the port's
    engine-vs-oracle parity needs each row's bits to depend on that row
    alone."""
    B, T, H, Dh = q.shape
    _, ps, KVH, _ = k_pages.shape
    G = H // KVH
    cover = page_tables.shape[1] * ps
    dev = q.device
    scale = 1.0 / math.sqrt(Dh)
    tables = page_tables.long()
    limit = torch.clamp(lengths.long()[:, None]
                        + torch.arange(T, device=dev)[None] + 1,
                        max=cover)                              # (B, T)
    row_limit = limit.repeat_interleave(G, dim=1)               # (B, T*G)
    R = T * G
    qh = (q.float().reshape(B, T, KVH, G, Dh).permute(0, 2, 1, 3, 4)
          .reshape(B, KVH, R, Dh))                   # row r = t * G + g
    # every split the tables cover: a split that holds no key of any
    # row is left out of each row's combine (``holds``), and the
    # lengths are read on the device only (a CUDA graph's replay, or
    # its CPU stand-in, reads no value)
    parts = [_split_partials(qh, k_pages, v_pages, tables, row_limit, s,
                             scale)
             for s in range(-(-cover // SPLIT))]
    # split s holds a key of row r iff s * SPLIT < limit; split 0 always
    holds = [(s * SPLIT < row_limit)[:, None] for s in range(len(parts))]
    M = parts[0][0]
    for (m, _, _), h in zip(parts[1:], holds[1:]):
        M = torch.where(h, torch.maximum(M, m), M)
    w = torch.exp(parts[0][0] - M)
    L, O = w * parts[0][1], w[..., None] * parts[0][2]
    for (m, l, acc), h in zip(parts[1:], holds[1:]):
        w = torch.exp(m - M)
        L = torch.where(h, L + w * l, L)
        O = torch.where(h[..., None], O + w[..., None] * acc, O)
    out = O / torch.clamp(L, min=1e-30)[..., None]
    out = out.reshape(B, KVH, T, G, Dh).permute(0, 2, 1, 3, 4)
    return out.reshape(B, T, H, Dh).to(q.dtype)


def cost(B: int, T: int, H: int, KVH: int, Dh: int, keys,
         n_table: int) -> tuple:
    """(flops, bytes) of paged attention for B rows of T queries, row b
    over ``keys[b]`` keys (its length + T, clipped to what its table of
    ``n_table`` pages covers), whatever computes it: 4 T H Dh operations
    a key; the keys' K and V read once, q read and the output written,
    the tables and lengths read (the bound of PERF.md's kernel
    table)."""
    kv = sum(keys) * KVH * Dh * 2 * 2
    io = 2 * B * T * H * Dh * 2 + B * n_table * 4 + B * 4
    return sum(4 * T * H * Dh * k for k in keys), kv + io


def _check(q, k_pages, v_pages, page_tables, lengths):
    if q.dim() != 4 or k_pages.dim() != 4:
        raise ValueError("q must be (B,T,H,Dh) and pages (P,ps,KVH,Dh)")
    B, T, H, Dh = q.shape
    P, ps, KVH, Dhk = k_pages.shape
    if v_pages.shape != k_pages.shape or Dhk != Dh:
        raise ValueError(f"page shapes {tuple(k_pages.shape)} / "
                         f"{tuple(v_pages.shape)} do not match "
                         f"q {tuple(q.shape)}")
    if H % KVH:
        raise ValueError(f"H={H} is not a multiple of KVH={KVH}")
    if page_tables.dim() != 2 or page_tables.shape[0] != B \
            or tuple(lengths.shape) != (B,):
        raise ValueError("page_tables must be (B, n) and lengths (B,)")
    if page_tables.shape[1] < 1:
        raise ValueError("page_tables needs at least one column")


def paged_attention(q, k_pages, v_pages, page_tables, lengths):
    """See the module docstring.  Returns ``(B, T, H, Dh)`` in q's dtype."""
    _check(q, k_pages, v_pages, page_tables, lengths)
    if q.device.type == "cpu":
        return paged_attention_plain(q, k_pages, v_pages, page_tables,
                                     lengths)
    if q.device.type not in ("cuda", "meta"):
        raise ValueError(f"unsupported device {q.device}")
    B, T, H, Dh = q.shape
    P, ps, KVH, _ = k_pages.shape
    for name, t, dt in (("q", q, torch.bfloat16),
                        ("k_pages", k_pages, torch.bfloat16),
                        ("v_pages", v_pages, torch.bfloat16),
                        ("page_tables", page_tables, torch.int32),
                        ("lengths", lengths, torch.int32)):
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
    if B == 0 or T == 0:
        return out
    n = page_tables.shape[1]
    groups = B * KVH * -(-T * (H // KVH) // ROWS)
    # split partials: per block ROWS x Dh outputs, ROWS maxima and sums
    ws = torch.empty(groups * -(-n * ps // SPLIT) * ROWS * (Dh + 2),
                     dtype=torch.float32, device=q.device)
    if q.device.type == "meta":
        # the lengths' values are not known on meta: every row counts
        # the keys its table covers (a decode at the cache's last slot)
        op_cost.kernel("paged_attention",
                       *cost(B, T, H, KVH, Dh, [n * ps] * B, n))
        return out
    stream = torch.cuda.current_stream(q.device).cuda_stream
    counters = _counter_buffer(q.device, stream, groups)
    fn = _kernel()
    global launches
    launches += 1
    err = fn(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
             page_tables.data_ptr(), lengths.data_ptr(), out.data_ptr(),
             ws.data_ptr(), counters.data_ptr(), B, T, H, KVH, Dh, ps, n,
             stream)
    if err:
        raise RuntimeError(f"paged_attention kernel launch failed: "
                           f"cudaError_t {err}")
    return out

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
tensors and takes the plain version only for CPU tensors.
"""
from __future__ import annotations

import ctypes
import math

import torch

from ..build import load

__all__ = ["paged_attention", "paged_attention_plain", "KV_TILE"]

#: keys per online-softmax step, anchored at position 0 — the same
#: partition as the kernel, independent of the page size
KV_TILE = 64
NEG_INF = -1e30

#: kernel launches since the last reset (chip_smoke.py reads it)
launches = 0

_fn = None


def _kernel():
    global _fn
    if _fn is None:
        f = load("paged_attention").repro_paged_attention_bf16
        f.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 7
                      + [ctypes.c_void_p])
        f.restype = ctypes.c_int
        _fn = f
    return _fn


def paged_attention_plain(q, k_pages, v_pages, page_tables, lengths):
    """The kernel's function in plain PyTorch, with the kernel's tile
    partition (KV_TILE keys anchored at position 0) and dtype contract
    (f32 scores and accumulation, p rounded to the value dtype before
    P.V).  Products are summed with ``(a * b).sum(-1)`` over a fixed
    length rather than ``matmul``: on the CPU an f32 GEMM's summation
    order depends on the number of rows, and the port's engine-vs-oracle
    parity needs each row's bits to depend on that row alone."""
    B, T, H, Dh = q.shape
    _, ps, KVH, _ = k_pages.shape
    G = H // KVH
    n = page_tables.shape[1]
    cover = n * ps
    dev = q.device
    scale = 1.0 / math.sqrt(Dh)
    tables = page_tables.long()
    limit = torch.clamp(lengths.long()[:, None]
                        + torch.arange(T, device=dev)[None] + 1,
                        max=cover)                              # (B, T)
    row_limit = limit.repeat_interleave(G, dim=1)               # (B, T*G)
    n_tiles = -(-int(limit.max()) // KV_TILE)
    R = T * G
    qh = (q.float().reshape(B, T, KVH, G, Dh).permute(0, 2, 1, 3, 4)
          .reshape(B, KVH, R, Dh))                   # row r = t * G + g
    m = torch.full((B, KVH, R), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((B, KVH, R), dtype=torch.float32, device=dev)
    acc = torch.zeros((B, KVH, R, Dh), dtype=torch.float32, device=dev)
    for i in range(n_tiles):
        j = i * KV_TILE + torch.arange(KV_TILE, device=dev)
        in_cover = (j < cover)[None, :, None, None]
        jc = j.clamp(max=cover - 1)
        pid, slot = tables[:, jc // ps], jc % ps                # (B, KV_TILE)
        k = torch.where(in_cover, k_pages[pid, slot].float(), 0.0)
        v = torch.where(in_cover, v_pages[pid, slot].float(), 0.0)
        k = k.permute(0, 2, 1, 3)                       # (B, KVH, KV_TILE, Dh)
        v = v.permute(0, 2, 3, 1)                       # (B, KVH, Dh, KV_TILE)
        s = (qh[:, :, :, None, :] * k[:, :, None]).sum(-1) * scale
        valid = j[None, None, :] < row_limit[:, :, None]     # (B, R, KV_TILE)
        s = torch.where(valid[:, None], s, NEG_INF)
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.exp(s - m_new[..., None])
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(-1)
        pb = p.to(v_pages.dtype).float()
        pv = (pb[:, :, :, None, :] * v[:, :, None]).sum(-1)     # (B,KVH,R,Dh)
        acc = acc * alpha[..., None] + pv
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    out = out.reshape(B, KVH, T, G, Dh).permute(0, 2, 1, 3, 4)
    return out.reshape(B, T, H, Dh).to(q.dtype)


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
    if q.device.type != "cuda":
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
    if Dh not in (64, 128):
        raise ValueError(f"head_dim {Dh} unsupported (64 or 128)")
    out = torch.empty_like(q)
    if B == 0 or T == 0:
        return out
    global launches
    launches += 1
    err = _kernel()(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
                    page_tables.data_ptr(), lengths.data_ptr(),
                    out.data_ptr(), B, T, H, KVH, Dh, ps,
                    page_tables.shape[1],
                    torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(f"paged_attention kernel launch failed: "
                           f"cudaError_t {err}")
    return out

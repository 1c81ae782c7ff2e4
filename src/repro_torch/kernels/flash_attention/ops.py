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
tensors and takes the plain version only for CPU tensors.
"""
from __future__ import annotations

import ctypes
import math

import torch

from ..build import load

__all__ = ["flash_attention", "flash_attention_plain", "KV_TILE"]

#: keys per online-softmax step — the kernel's tile
KV_TILE = 64
NEG_INF = -1e30

#: kernel launches since the last reset (chip_smoke.py reads it)
launches = 0

_fn = None


def _kernel():
    global _fn
    if _fn is None:
        f = load("flash_attention").repro_flash_attention_bf16
        f.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 8
                      + [ctypes.c_void_p])
        f.restype = ctypes.c_int
        _fn = f
    return _fn


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
                          window=None):
    """The kernel's function in plain PyTorch, with the kernel's tile
    partition and dtype contract (f32 scores and accumulation, p rounded
    to the value dtype before P.V).  Products are summed with
    ``(a * b).sum(-1)`` over a fixed length rather than ``matmul``: on
    the CPU an f32 GEMM's summation order depends on the number of rows,
    and chunked == whole prefill needs each row's bits to depend on that
    row alone.  Query rows go PLAIN_ROWS at a time (a row's result does
    not depend on the others)."""
    B, Sq = q.shape[:2]
    offs = _offsets(q_offset, B, q.device)
    outs = [_plain_rows(q[:, i:i + PLAIN_ROWS], k, v, offs + i, causal,
                        window)
            for i in range(0, Sq, PLAIN_ROWS)]
    if len(outs) == 1:
        return outs[0]
    return torch.cat(outs, 1) if outs else torch.empty_like(q)


def _plain_rows(q, k, v, offs, causal, window):
    B, Sq, H, Dh = q.shape
    Skv, KVH = k.shape[1], k.shape[2]
    G = H // KVH
    dev = q.device
    scale = 1.0 / math.sqrt(Dh)
    q_pos = offs.long()[:, None] + torch.arange(Sq, device=dev)[None]
    kend = Skv
    if causal and Sq:
        kend = min(Skv, int(q_pos.max()) + 1)
    # the first tile any row sees: earlier tiles are masked for every
    # row, and starting later gives the same bits (see the kernel)
    kbeg = 0
    if window is not None and Sq:
        kbeg = max(0, int(q_pos.min()) - window + 1) // KV_TILE * KV_TILE
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
    out = acc / torch.clamp(l, min=1e-30)[..., None]     # (B,KVH,G,Sq,Dh)
    return out.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, Dh).to(q.dtype)


def _check(q, k, v):
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError("q must be (B,Sq,H,Dh) and k/v (B,Skv,KVH,Dh)")
    B, Sq, H, Dh = q.shape
    if k.shape[0] != B or k.shape[3] != Dh:
        raise ValueError(f"k/v {tuple(k.shape)} do not match "
                         f"q {tuple(q.shape)}")
    if H % k.shape[2]:
        raise ValueError(f"H={H} is not a multiple of KVH={k.shape[2]}")


def flash_attention(q, k, v, q_offset=0, causal: bool = True,
                    window=None):
    """See the module docstring.  Returns ``(B, Sq, H, Dh)`` in q's
    dtype."""
    _check(q, k, v)
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, q_offset, causal, window)
    if q.device.type != "cuda":
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
    if Dh not in (64, 128, 256):
        raise ValueError(f"head_dim {Dh} unsupported (64, 128 or 256)")
    out = torch.empty_like(q)
    if B == 0 or Sq == 0:
        return out
    global launches
    launches += 1
    err = _kernel()(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                    qo.data_ptr(), out.data_ptr(), B, Sq, Skv, H, KVH, Dh,
                    int(causal), int(window or 0),
                    torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(f"flash_attention kernel launch failed: "
                           f"cudaError_t {err}")
    return out

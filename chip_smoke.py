#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line; any failure exits non-zero:

1. **env**     torch / CUDA versions, the card, and the build of every
               hand-written kernel from ``src/repro_torch/csrc``.
2. **kernels** each kernel against its plain PyTorch version on the
               card at qwen3-0.6b FULL attention shapes (H 16, KVH 8,
               Dh 128, page 16), bf16, with kernel / plain / library /
               bound times, and the kernel's own bitwise properties
               (a row's bits depend on its own keys only; 32-row chunks
               of the 512-token prefill at offsets 0, 32, 224 and 480
               give the whole prefill's bits; the contiguous decode
               gives the paged decode's bits).  Paged attention also at
               ~2,000-key contexts and at Dh 64 with two row groups,
               with the key-split grid's block counts.
3. **paper**   the paper's kernel path at full width: the dataflow GEMM
               (all four reuse schemes) on llama4-scout's expert
               up-projection (M 8192, K 5120, N 8192, bf16), input-/
               weight-stationary again at 2M / 2N (twice the blocks),
               and a ragged f32 GEMM, the block-sparse GEMM on the same
               operands at the Table-3 keep rates, and the LUT
               activation on the GEMM's output shape and on all eight
               tables.  Its entry points run once with the launch
               counters at 0 (the path); then each kernel is held
               against its plain version (the four dataflows bit-
               identical, dead columns exactly 0, the LUT bit-identical,
               its scalar tail and unaligned paths too, the bf16
               pipeline's TMA and cp.async producers bit-identical) and
               timed beside its plain version, a library call and its
               bound; the LUT once more with every x equal (no gather
               spread).
4. **serve**   qwen3-0.6b at full width (seeded random init) serves 16
               synthetic requests through ``ServeEngine`` and the
               kernels' launch counters prove the path ran through them.
5. **parity**  every served token is re-scored teacher-forced by the
               port's whole-sequence ``apply`` on the card.
6. **profile** a shorter serve run under ``torch.profiler``: device
               time by kernel and the device's idle share.

Then a ``{"kernels": [...]}`` line (all five kernels, launches from the
serve and paper paths), the card's name and power limit as
``nvidia-smi`` reports them, and as the last line
``{"ok": true, "device": {...}}``.  The run uses one card: the first
one ``CUDA_VISIBLE_DEVICES`` lists (device 0 when it is unset).
Without a GPU, or without the rest of the repository beside this file,
it exits non-zero and prints no result.  It imports neither ``jax`` nor
the JAX package ``repro``.
"""
from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

HBM_BYTES_PER_S = 3.35e12       # H100 SXM device memory
BF16_FLOPS_PER_S = 989e12       # H100 SXM dense bf16 tensor-core peak
F32_FLOPS_PER_S = 67e12         # H100 SXM float32 outside the tensor cores

# bf16 outputs: kernel and plain version both accumulate in f32 but in
# different orders, then round to bf16 (8 significant bits, relative
# step 2^-8 = 0.0039); 2e-2 absolute + relative allows a few bf16 ulps
# of outputs of magnitude ~1 and no real error.
ATOL = RTOL = 2e-2
# parity: a served token must score within TAU of the best logit when
# the port's whole-sequence prefill re-scores it.  Logits of this
# random-init model have std ~0.6; bf16 rounding that differs between
# batched decode and whole prefill moves them by ~1e-3 per layer.
TAU = 0.05

N_REQUESTS, PROMPT_LEN, GEN = 16, 256, 32
# chunk starts of the kernel-level chunked == whole prefill check
CHUNK_STARTS = (0, 32, 224, 480)

# paper phase.  llama4-scout's expert up-projection (tokens x d_model @
# d_model x d_ff), the GEMM of benchmarks/kernel_dataflow.py
SCOUT_M, SCOUT_K, SCOUT_N = 8192, 5120, 8192
KEEP_RATES = (0.36, 0.27, 0.35, 0.38)      # the paper's Table-3 rates
# f32 outputs of a K-5120 product: kernel and plain version sum 5120
# products of magnitude ~1 in two orders (tensor-core or FMA tile
# products vs cuBLAS f32 panels), so outputs of magnitude ~70 differ by
# ~1e-3; 1e-2 + 1e-4 |want| allows that and no real error
GEMM_ATOL, GEMM_RTOL = 1e-2, 1e-4


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def fail(msg: str) -> "None":
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if out.returncode != 0:
        fail(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


# ----------------------------------------------------------- timing
def _flush_l2(buf) -> None:
    buf.zero_()                      # 256 MB > the 50 MB L2


def time_ms(fn, *, iters: int = 20, flush=None,
            budget_ms: float = None) -> float:
    """Median device time of one call, CUDA events around each call,
    L2 flushed between calls when ``flush`` is given (in the serve path
    each of the 28 layers reads its own K/V).  With ``budget_ms`` the
    number of calls is cut (to no fewer than 3) so that they take about
    that long in all."""
    import torch
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    fn()
    b.record()
    b.synchronize()
    if budget_ms is not None:
        iters = max(3, min(iters, int(budget_ms / max(a.elapsed_time(b),
                                                      1e-3))))
    times = []
    for _ in range(iters):
        if flush is not None:
            _flush_l2(flush)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    times.sort()
    return times[len(times) // 2]


def bound_ms(n_bytes: float, n_flops: float,
             flops_per_s: float = BF16_FLOPS_PER_S):
    t_b = n_bytes / HBM_BYTES_PER_S * 1e3
    t_f = n_flops / flops_per_s * 1e3
    return (t_b, "bytes") if t_b >= t_f else (t_f, "operations")


def max_err(got, want, atol: float = ATOL, rtol: float = RTOL):
    """(max |got - want|, within atol + rtol * |want| everywhere)."""
    g, w = got.float(), want.float()
    d = (g - w).abs()
    ok = bool((d <= atol + rtol * w.abs()).all()) and bool(
        torch_isfinite(g))
    return float(d.max()), ok


def torch_isfinite(x) -> bool:
    import torch
    return bool(torch.isfinite(x).all())


# ----------------------------------------------------------- phases
def phase_env():
    import torch
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    took = build.build()
    rec = {"phase": "env", "torch": torch.__version__,
           "cuda": torch.version.cuda, "python": sys.version.split()[0],
           "device": torch.cuda.get_device_name(0),
           "nvidia_smi": nvidia_smi_line(),
           "build_s": round(time.perf_counter() - t0, 3),
           "build_s_per_kernel": {k: round(v, 3) for k, v in took.items()}}
    for name in build.SOURCES:
        rec[f"ptxas_{name}"] = _ptxas_summary(build.build_log(name))
    emit(rec)


def _kernel_name(mangled: str) -> str:
    """A kernel's demangled name without its parameter list
    (``pipe::gemm_bf16<0>``); without c++filt, its last identifier."""
    try:
        out = subprocess.run(["c++filt", mangled], capture_output=True,
                             text=True, timeout=10).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        out = mangled
    if out == mangled:
        found = re.findall(r"\d+([a-z][a-z0-9_]+?)(?:I|E)", mangled)
        return found[-1] if found else mangled
    name = out.replace("(anonymous namespace)::", "").split("(", 1)[0]
    return name.split(" ", 1)[-1]


def _ptxas_summary(log: str):
    """One line per kernel of ptxas's -v report: registers, shared
    memory and spill bytes."""
    out, name, spill = [], None, ""
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", ln)
        if m:
            name = _kernel_name(m.group(1))
        elif "spill stores" in ln:
            spill = ln.strip()
        elif "Used" in ln and "registers" in ln and name:
            used = ln.split("Used", 1)[1].strip()
            out.append(f"{name}: {used}; {spill}")
            name, spill = None, ""
    return out


def _paged_case(B, T, lengths, *, seed, P=154, H=16, KVH=8, Dh=128):
    """Inputs of one paged-attention call, by default at qwen3-0.6b
    shapes: a pool of P pages of 16 (154: the size the serve phase
    sizes), ragged lengths, distinct random pages per row."""
    import torch
    ps = 16
    n = -(-(max(lengths) + T) // ps)
    g = torch.Generator(device="cuda").manual_seed(seed)
    dev = "cuda"
    q = torch.randn(B, T, H, Dh, generator=g, device=dev).bfloat16()
    kp = torch.randn(P, ps, KVH, Dh, generator=g, device=dev).bfloat16()
    vp = torch.randn(P, ps, KVH, Dh, generator=g, device=dev).bfloat16()
    perm = torch.randperm(P - 1, generator=g, device=dev) + 1
    tables = torch.zeros(B, n, dtype=torch.int32, device=dev)
    used = 0
    for b, ln in enumerate(lengths):
        k = -(-(ln + T) // ps)
        tables[b, :k] = perm[used:used + k].int()
        used += k
    lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
    return q, kp, vp, tables, lens


def _paged_numbers(q, kp, vp, tables, lens):
    B, T, H, Dh = q.shape
    KVH, ps = kp.shape[2], kp.shape[1]
    keys = [min(int(ln) + T, tables.shape[1] * ps) for ln in lens.tolist()]
    kv_bytes = sum(keys) * KVH * Dh * 2 * 2
    io_bytes = 2 * q.numel() * 2 + tables.numel() * 4 + lens.numel() * 4
    flops = sum(4 * T * H * Dh * k for k in keys)
    return kv_bytes + io_bytes, flops


def _paged_blocks(q, kp, tables, lens, split):
    """(blocks launched, blocks with keys to read) of the kernel's grid:
    one block per (b, kv head, row group of <= 16 query rows, key split
    of ``split`` keys anchored at position 0); a split past its row
    group's last key does no work."""
    B, T, H, _ = q.shape
    ps, KVH = kp.shape[1], kp.shape[2]
    G, cover = H // KVH, tables.shape[1] * ps
    groups = -(-T * G // 16)
    work = 0
    for ln in lens.tolist():
        for rg in range(groups):
            last = min(T * G, 16 * (rg + 1)) - 1
            work += KVH * -(-min(ln + last // G + 1, cover) // split)
    return B * KVH * groups * -(-cover // split), work


def _sdpa_paged(q, kp, vp, tables, lens):
    """SDPA over K/V gathered from the pages beforehand (the gather is
    not timed): the library yardstick for the paged kernel."""
    import torch
    import torch.nn.functional as F
    B, T, H, Dh = q.shape
    ps = kp.shape[1]
    n = tables.shape[1]
    k = kp[tables.long()].reshape(B, n * ps, *kp.shape[2:]).transpose(1, 2)
    v = vp[tables.long()].reshape(B, n * ps, *vp.shape[2:]).transpose(1, 2)
    k, v = k.contiguous(), v.contiguous()
    qpos = lens.long()[:, None] + torch.arange(T, device=q.device)[None]
    mask = (torch.arange(n * ps, device=q.device)[None, None]
            <= qpos[:, :, None])[:, None]
    qt = q.transpose(1, 2).contiguous()

    def call():
        return F.scaled_dot_product_attention(qt, k, v, attn_mask=mask,
                                              enable_gqa=True)
    return call


def _flash_numbers(q, k, v, q_offset, causal):
    B, Sq, H, Dh = q.shape
    Skv, KVH = k.shape[1], k.shape[2]
    keys = []
    for b in range(B):
        off = int(q_offset[b])
        for i in range(Sq):
            keys.append(min(Skv, off + i + 1) if causal else Skv)
    kmax = [min(Skv, int(q_offset[b]) + Sq) if causal else Skv
            for b in range(B)]
    kv_bytes = sum(kmax) * KVH * Dh * 2 * 2
    io_bytes = 2 * q.numel() * 2 + B * 4
    flops = 4 * H * Dh * sum(keys)
    return kv_bytes + io_bytes, flops


def _sdpa_flash(q, k, v, q_offset, causal):
    import torch
    import torch.nn.functional as F
    B, Sq = q.shape[:2]
    Skv = k.shape[1]
    qt = q.transpose(1, 2).contiguous()
    kt = k.transpose(1, 2).contiguous()
    vt = v.transpose(1, 2).contiguous()
    mask = None
    if causal:
        qpos = q_offset.long()[:, None] + torch.arange(Sq, device=q.device)
        mask = (torch.arange(Skv, device=q.device)[None, None]
                <= qpos[:, :, None])[:, None]

    def call():
        return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                              enable_gqa=True)
    return call


def _paged_bitwise(kernel, q, kp, vp, tables, lens, got) -> bool:
    """The properties the engine's token-exactness rests on, held by
    the kernel itself: query t of a T-token call == the one-token call
    at lengths + t; a wider table changes no bit; a row alone == the
    row in the batch."""
    import torch
    T = q.shape[1]
    wider = torch.cat([tables, torch.zeros_like(tables[:, :3])], 1)
    ok = torch.equal(kernel(q, kp, vp, wider, lens), got)
    for t in range(T):
        one = kernel(q[:, t:t + 1].contiguous(), kp, vp, tables, lens + t)
        ok = ok and torch.equal(one[:, 0], got[:, t])
    alone = kernel(q[1:2], kp, vp, tables[1:2], lens[1:2])
    return ok and torch.equal(alone, got[1:2])


def _contiguous_equals_paged(seed) -> bool:
    """The contiguous decode (``components.decode_attention``: the cache
    viewed as one page of S_max = 304 keys per row, not a multiple of
    the key split) gives the bits of the paged decode over the same keys
    in pages of 16, at qwen3-0.6b shapes."""
    import torch
    from repro_torch.kernels.paged_attention import paged_attention
    from repro_torch.models.components import decode_attention
    B, H, KVH, Dh, ps, S, pos = 8, 16, 8, 128, 16, 304, 297
    g = torch.Generator(device="cuda").manual_seed(seed)
    k = torch.randn(B, S, KVH, Dh, generator=g, device="cuda").bfloat16()
    v = torch.randn(B, S, KVH, Dh, generator=g, device="cuda").bfloat16()
    q = torch.randn(B, 1, H, Dh, generator=g, device="cuda").bfloat16()
    null = torch.zeros(1, ps, KVH, Dh, dtype=k.dtype, device="cuda")
    kp = torch.cat([null, k.reshape(B * S // ps, ps, KVH, Dh)])
    vp = torch.cat([null, v.reshape(B * S // ps, ps, KVH, Dh)])
    tables = (torch.arange(B * S // ps, dtype=torch.int32, device="cuda")
              .reshape(B, S // ps) + 1)
    lens = torch.full((B,), pos - 1, dtype=torch.int32, device="cuda")
    return torch.equal(decode_attention(q, k, v, pos),
                       paged_attention(q, kp, vp, tables, lens))


def _flash_bitwise(kernel, q, k, v, off, got) -> bool:
    """Keys past every row's causal frontier (a longer buffer) change
    no bit, and a row alone == the row in the batch."""
    import torch
    pad = torch.randn_like(k[:, :64])
    longer = kernel(q, torch.cat([k, pad], 1), torch.cat([v, pad], 1),
                    q_offset=off, causal=True)
    alone = kernel(q[1:2], k[1:2], v[1:2], q_offset=off[1:2], causal=True)
    return torch.equal(longer, got) and torch.equal(alone, got[1:2])


def _flash_chunked_equals_whole(kernel, q, k, v, whole) -> bool:
    """Each row of a 32-row call at q_offset s over the first s + 32
    keys equals the same row of the whole prefill, for s in CHUNK_STARTS:
    chunked == whole prefill, held by the kernel itself."""
    import torch
    ok = True
    for s in CHUNK_STARTS:
        off = torch.full((q.shape[0],), s, dtype=torch.int32,
                         device=q.device)
        part = kernel(q[:, s:s + 32].contiguous(),
                      k[:, :s + 32].contiguous(), v[:, :s + 32].contiguous(),
                      q_offset=off, causal=True)
        ok = ok and torch.equal(part, whole[:, s:s + 32])
    return ok


def phase_kernels():
    """Each kernel vs its plain version at the main path's shapes."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import paged_attention as pa
    flush = torch.empty(64 << 20, dtype=torch.float32, device="cuda")
    results = {}
    # what this way of timing reads for a kernel that does next to
    # nothing: one 4-byte memset, timed as the kernels below are
    emit({"phase": "kernels", "check": "timing_floor",
          "memset_4_bytes_ms": time_ms(lambda: flush[:1].zero_(),
                                       flush=flush)})

    def record(kernel, case, got, want, bitwise, t_k, t_p, t_l, n_bytes,
               flops, **shape):
        err, ok = max_err(got, want)
        b_ms, b_by = bound_ms(n_bytes, flops)
        rec = {"phase": "kernels", "kernel": kernel, "case": case,
               **shape, "max_abs_err": err, "atol": ATOL, "rtol": RTOL,
               "ok": ok, "bitwise_invariants": bitwise, "ms": t_k,
               "plain_ms": t_p, "library_ms": t_l, "bound_ms": b_ms,
               "bound_by": b_by, "bytes": n_bytes, "flops": flops}
        emit(rec)
        if not ok:
            fail(f"{kernel} [{case}] disagrees with its plain version: "
                 f"max abs err {err}")
        if not bitwise:
            fail(f"{kernel} [{case}]: a row's bits depend on more than "
                 "its own keys")
        results.setdefault(kernel, []).append(rec)

    # paged attention: decode (T=1) and verify (T=5 = spec_k + 1) at the
    # serve phase's contexts, verify at ~2,000-key contexts (a pool of
    # 1,040 pages of 16 and the null page), and Dh 64 with 4 query heads
    # per kv head (T * G = 20 rows: two row groups)
    short = [255, 17, 283, 100, 31, 200, 64, 129]
    long_ = [2040, 1800, 1999, 1024, 2047, 1500, 1900, 1700]
    for case, T, lengths, P, seed, shape in (
            ("B8_T1", 1, short, 154, 1, {}),
            ("B8_T5", 5, short, 154, 5, {}),
            ("B8_T5_long", 5, long_, 1041, 6, {}),
            ("B4_T5_G4_dh64", 5, [300, 5, 130, 64], 154, 7,
             {"H": 16, "KVH": 4, "Dh": 64})):
        args = _paged_case(len(lengths), T, lengths, seed=seed, P=P, **shape)
        got = pa.paged_attention(*args)
        want = pa.paged_attention_plain(*args)
        bitwise = _paged_bitwise(pa.paged_attention, *args, got)
        torch.cuda.synchronize()
        n_bytes, flops = _paged_numbers(*args)
        grid, working = _paged_blocks(args[0], args[1], args[3], args[4],
                                      pa.SPLIT)
        record("paged_attention", case, got, want, bitwise,
               time_ms(lambda: pa.paged_attention(*args), flush=flush),
               time_ms(lambda: pa.paged_attention_plain(*args), iters=5,
                       flush=flush),
               time_ms(_sdpa_paged(*args), flush=flush),
               n_bytes, flops, B=len(lengths), T=T, H=args[0].shape[2],
               KVH=args[1].shape[2], Dh=args[0].shape[3], lengths=lengths,
               pool_pages=P,
               split=pa.SPLIT, grid_blocks=grid, working_blocks=working)
    contiguous = _contiguous_equals_paged(seed=11)
    emit({"phase": "kernels", "check": "contiguous_decode_equals_paged",
          "B": 8, "S_max": 304, "page_size": 16, "equal": contiguous})
    if not contiguous:
        fail("paged_attention: the contiguous decode gives other bits than "
             "the paged decode over the same keys")

    # flash attention: whole 512-token causal prefill, and one fused
    # chunk step (B 8 x C 32, per-row offsets, ragged gathered buffer)
    g = torch.Generator(device="cuda").manual_seed(7)
    H, KVH, Dh = 16, 8, 128
    cases = []
    q = torch.randn(2, 512, H, Dh, generator=g, device="cuda").bfloat16()
    k = torch.randn(2, 512, KVH, Dh, generator=g, device="cuda").bfloat16()
    v = torch.randn(2, 512, KVH, Dh, generator=g, device="cuda").bfloat16()
    off = torch.zeros(2, dtype=torch.int32, device="cuda")
    cases.append(("prefill_B2_S512", q, k, v, off))
    starts = [0, 32, 64, 96, 128, 160, 192, 224]
    skv = 16 * 16 + 32                       # bucket 16 pages + chunk
    q = torch.randn(8, 32, H, Dh, generator=g, device="cuda").bfloat16()
    k = torch.randn(8, skv, KVH, Dh, generator=g, device="cuda").bfloat16()
    v = torch.randn(8, skv, KVH, Dh, generator=g, device="cuda").bfloat16()
    off = torch.tensor(starts, dtype=torch.int32, device="cuda")
    cases.append(("chunk_B8_C32", q, k, v, off))
    for case, q, k, v, off in cases:
        got = fa.flash_attention(q, k, v, q_offset=off, causal=True)
        want = fa.flash_attention_plain(q, k, v, q_offset=off, causal=True)
        bitwise = _flash_bitwise(fa.flash_attention, q, k, v, off, got)
        chunked = None
        if case.startswith("prefill"):
            chunked = _flash_chunked_equals_whole(fa.flash_attention, q, k,
                                                  v, got)
            if not chunked:
                fail(f"flash_attention [{case}]: a 32-row chunk gives other "
                     "bits than the same rows of the whole prefill")
        torch.cuda.synchronize()
        n_bytes, flops = _flash_numbers(q, k, v, off.tolist(), True)
        record("flash_attention", case, got, want, bitwise,
               time_ms(lambda: fa.flash_attention(q, k, v, q_offset=off,
                                                  causal=True), flush=flush),
               time_ms(lambda: fa.flash_attention_plain(
                   q, k, v, q_offset=off, causal=True), iters=3,
                   flush=flush),
               time_ms(_sdpa_flash(q, k, v, off, True), flush=flush),
               n_bytes, flops, B=q.shape[0], Sq=q.shape[1],
               Skv=k.shape[1], q_offset=off.tolist(),
               chunked_equals_whole=chunked)
    del flush
    return results


def _lut_x(g, rows, cols, scale):
    """Activations of the given shape: normal values times ``scale``,
    with every fourth value an exact half step LUT_LO + (i + 0.5) STEP
    (where rounding half to even decides the entry) and +-inf, |x| > 8
    and the grid's ends among the first eight."""
    import torch
    from repro_torch.kernels.lut_activation import LUT_ENTRIES, LUT_LO, STEP
    n = rows * cols
    x = torch.randn(n, generator=g, device="cuda") * scale
    idx = torch.randint(0, LUT_ENTRIES, (n,), generator=g, device="cuda")
    x[::4] = LUT_LO + (idx[::4].float() + 0.5) * STEP
    x[:8] = torch.tensor([float("inf"), float("-inf"), 8.5, -8.5, 1e30,
                          -1e30, 7.9999, -8.0], device="cuda")
    return x.reshape(rows, cols)


def _scout_masks(b):
    """(case, mask, B) for the block-sparse GEMM on scout's operands:
    masks at the Table-3 keep rates, made as
    benchmarks/kernel_dataflow.py makes them, and one read by
    ``mask_from_weights`` from a B whose pruned tiles are zero (keep
    0.36 at random, every eighth column of tiles pruned whole, so some
    output columns are dead)."""
    import torch
    from repro_torch.kernels import block_sparse as bs
    nk, nn = SCOUT_K // 128, SCOUT_N // 128
    out = []
    for keep in KEEP_RATES:
        rng = np.random.default_rng(int(keep * 100))
        out.append((f"keep_{keep}", rng.random((nk, nn)) < keep, b))
    keep = np.random.default_rng(1).random((nk, nn)) < 0.36
    keep[:, 7::8] = False
    pruned = b * torch.from_numpy(bs.expand_mask(keep, 128, 128)).to(b.device)
    mask = bs.mask_from_weights(pruned.float().cpu().numpy(), 128, 128)
    if not np.array_equal(mask, keep):
        fail("paper: mask_from_weights did not recover the pruned tiles")
    out.append(("from_weights", mask, pruned))
    return out


def phase_paper():
    """The paper's kernel path at full width: the dataflow GEMM, the
    block-sparse GEMM and the LUT activation through their entry points.
    Returns ({kernel: [case records]}, {kernel: launches on the path})."""
    import torch
    from repro_torch.kernels import block_sparse as bs
    from repro_torch.kernels import gemm_dataflow as gd
    from repro_torch.kernels import lut_activation as lut
    from repro_torch.kernels.block_sparse import ops as bs_ops
    from repro_torch.kernels.gemm_dataflow import ops as gd_ops
    from repro_torch.kernels.lut_activation import ops as lut_ops
    t_phase = time.perf_counter()
    M, K, N = SCOUT_M, SCOUT_K, SCOUT_N
    g = torch.Generator(device="cuda").manual_seed(12)
    a = torch.randn(M, K, generator=g, device="cuda").bfloat16()
    b = torch.randn(K, N, generator=g, device="cuda").bfloat16()
    a2 = torch.randn(2 * M, K, generator=g, device="cuda").bfloat16()
    b2 = torch.randn(K, 2 * N, generator=g, device="cuda").bfloat16()
    a32 = torch.randn(1000, K, generator=g, device="cuda")
    b32 = torch.randn(K, 1000, generator=g, device="cuda")
    # ragged bf16: K and N no multiple of 8 (element-wise loads), N odd
    ar = torch.randn(1000, 5100, generator=g, device="cuda").bfloat16()
    br = torch.randn(5100, 999, generator=g, device="cuda").bfloat16()
    mask_r = np.random.default_rng(2).random((40, 8)) < 0.36
    mask_r[:, 3] = False
    sparse_cases = ([(case, a, w, mask) for case, mask, w in _scout_masks(b)]
                    + [("ragged_bf16", ar, br, mask_r)])
    x_act = _lut_x(g, M, N, 2.0)           # the GEMM's output shape
    x_tab = _lut_x(g, 2048, 2048, 3.0)
    D = gd.Dataflow
    # input-/weight-stationary parallelise over M/128 or N/128 blocks
    # only (64 here, on 132 SMs); the 2M / 2N cases give them 128
    gemm_cases = ([("scout_expert_bf16", df, a, b) for df in D]
                  + [("scout_2m_bf16", df, a2, b)
                     for df in (D.OUTPUT_STATIONARY, D.INPUT_STATIONARY)]
                  + [("scout_2n_bf16", df, a, b2)
                     for df in (D.OUTPUT_STATIONARY, D.WEIGHT_STATIONARY)]
                  + [("ragged_f32", df, a32, b32)
                     for df in (D.OUTPUT_STATIONARY, D.NO_REUSE)]
                  + [("ragged_bf16", df, ar, br) for df in D])
    lut_cases = ([("silu_f32", "silu", x_act),
                  ("silu_bf16", "silu", x_act.bfloat16())]
                 + [(f"{name}_f32", name, x_tab)
                    for name in sorted(lut.TABLES)])

    # the path: each entry point once per case, counters from 0
    gd_ops.launches = bs_ops.launches = lut_ops.launches = 0
    gemm_out = [gd.matmul(x, w, df) for _, df, x, w in gemm_cases]
    bs_out = [bs.matmul(x, w, mask) for _, x, w, mask in sparse_cases]
    lut_out = [lut.apply_lut(x, name) for _, name, x in lut_cases]
    torch.cuda.synchronize()
    launches = {"gemm_dataflow": gd_ops.launches,
                "block_sparse": bs_ops.launches,
                "lut_activation": lut_ops.launches}
    want = {"gemm_dataflow": len(gemm_cases),
            "block_sparse": len(sparse_cases),
            "lut_activation": len(lut_cases)}
    if launches != want:
        fail(f"paper: launches {launches}, the path needs {want}")

    flush = torch.empty(64 << 20, dtype=torch.float32, device="cuda")
    results = {}

    def record(kernel, case, got, want, atol, rtol, t_k, t_p, t_l,
               n_bytes, flops, flops_per_s, **extra):
        err, ok = max_err(got, want, atol, rtol)
        b_ms, b_by = bound_ms(n_bytes, flops, flops_per_s)
        rec = {"phase": "paper", "kernel": kernel, "case": case, **extra,
               "max_abs_err": err, "atol": atol, "rtol": rtol, "ok": ok,
               "ms": t_k, "plain_ms": t_p, "library_ms": t_l,
               "bound_ms": b_ms, "bound_by": b_by, "bytes": n_bytes,
               "flops": flops, "launches": launches[kernel]}
        emit(rec)
        if not ok:
            fail(f"{kernel} [{case}] disagrees with its plain version: "
                 f"max abs err {err} (atol {atol}, rtol {rtol})")
        results.setdefault(kernel, []).append(rec)

    # dataflow GEMM: every dataflow of a case gives the first one's bits
    first = {}
    for (case, df, x, w), got in zip(gemm_cases, gemm_out):
        if case not in first:
            first[case] = (got, gd.matmul_plain(x, w),
                           time_ms(lambda: gd.matmul_plain(x, w), iters=3,
                                   flush=flush),
                           time_ms(lambda: torch.matmul(x, w), flush=flush))
        ref_c, want_c, t_p, t_l = first[case]
        same = torch.equal(got, ref_c)
        if not same:
            fail(f"gemm_dataflow [{case}]: {df.value} gives other bits "
                 "than output_stationary")
        m, k = x.shape
        n = w.shape[1]
        e = x.element_size()
        t_k = time_ms(lambda: gd.matmul(x, w, df), flush=flush,
                      budget_ms=1500)
        record("gemm_dataflow", case, got, want_c, GEMM_ATOL, GEMM_RTOL,
               t_k, t_p, t_l, (m * k + k * n) * e + m * n * 4,
               2 * m * n * k,
               BF16_FLOPS_PER_S if e == 2 else F32_FLOPS_PER_S,
               dataflow=df.value, M=m, K=k, N=n, dtype=str(x.dtype)[6:],
               bitwise_equal_across_dataflows=same,
               modeled_bytes=gd.modeled_traffic(
                   m, n, k, df, bytes_per_elem=e)["total_bytes"])
    del first

    # block-sparse GEMM: live tiles only; dead columns exactly 0
    for (case, x, w, mask), got in zip(sparse_cases, bs_out):
        m, k = x.shape
        n = w.shape[1]
        live_w = bs.expand_mask(mask, 128, 128)[:k, :n]   # live weights
        dead = torch.from_numpy(~live_w.any(axis=0)).cuda()
        dead_zero = bool((got[:, dead] == 0).all())
        if not dead_zero:
            fail(f"block_sparse [{case}]: a dead column is not 0")
        dense = w * torch.from_numpy(live_w).cuda()
        n_live, k_live = int(live_w.sum()), int(live_w.any(axis=1).sum())
        record("block_sparse", case, got, bs.matmul_plain(x, w, mask),
               GEMM_ATOL, GEMM_RTOL,
               time_ms(lambda: bs.matmul(x, w, mask), flush=flush,
                       budget_ms=1000),
               time_ms(lambda: bs.matmul_plain(x, w, mask), iters=3,
                       flush=flush),
               time_ms(lambda: torch.matmul(x, dense), flush=flush),
               (m * k_live + n_live) * 2 + m * n * 4, 2 * m * n_live,
               BF16_FLOPS_PER_S, M=m, K=k, N=n, dtype="bfloat16",
               tiles_live=int(mask.sum()), tiles_total=int(mask.size),
               dead_columns=int((~mask.any(axis=0)).sum()),
               dead_columns_zero=dead_zero)
        del dense
    # the two producers of the bf16 pipeline on the same aligned
    # operands: the same C, through the wrappers' private launchers
    if gd_ops.producer_for(a, b) != gd_ops.TMA:
        fail("paper: the scout operands should take the TMA producer")
    OS = D.OUTPUT_STATIONARY
    cp_c = gd_ops._launch(a, b, OS, gd_ops.CP_ASYNC)
    mask0 = sparse_cases[0][3]
    cp_bs = bs_ops._launch(a, b, mask0, gd_ops.CP_ASYNC)
    same_gemm = torch.equal(cp_c, gemm_out[0])
    same_bs = torch.equal(cp_bs, bs_out[0])
    emit({"phase": "paper", "check": "producers", "case": "scout_expert_bf16",
          "gemm_tma_equals_cp_async": same_gemm,
          "block_sparse_tma_equals_cp_async": same_bs,
          "gemm_os_tma_ms": time_ms(lambda: gd_ops._launch(
              a, b, OS, gd_ops.TMA), flush=flush),
          "gemm_os_cp_async_ms": time_ms(lambda: gd_ops._launch(
              a, b, OS, gd_ops.CP_ASYNC), flush=flush),
          "ragged_bf16_producer": "cp_async" if gd_ops.producer_for(
              ar, br) == gd_ops.CP_ASYNC else "tma"})
    if not (same_gemm and same_bs):
        fail(f"paper: the cp.async producer gives other bits than TMA "
             f"(gemm {same_gemm}, block-sparse {same_bs})")
    del cp_c, cp_bs
    nk, nn = K // 128, N // 128
    dense_bits = torch.equal(bs.matmul(a, b, np.ones((nk, nn), bool)),
                             gemm_out[0])
    empty_zero = bool((bs.matmul(a, b, np.zeros((nk, nn), bool)) == 0
                       ).all())
    if not (dense_bits and empty_zero):
        fail(f"block_sparse: density 1 == output-stationary bits "
             f"{dense_bits}, fully pruned == 0 {empty_zero}")

    # LUT activation: bit-identical to the plain version.  The library
    # yardstick is the table's function called on x; for bf16 x it
    # would return bf16, not the kernel's f32, so there is none.
    for (case, name, x), got in zip(lut_cases, lut_out):
        table = lut.table_for(name, str(x.device))
        n = x.numel()
        t_l, note = None, ("no single PyTorch call maps bf16 x to f32 "
                           f"{name}(x)")
        if x.dtype == torch.float32:
            t_l = time_ms(lambda: lut.TABLES[name](x), flush=flush)
            note = f"lut.TABLES['{name}'](x)"
        record("lut_activation", case, got, lut.lut_plain(x, table), 0.0,
               0.0, time_ms(lambda: lut.apply_lut(x, name), flush=flush),
               time_ms(lambda: lut.lut_plain(x, table), iters=5,
                       flush=flush),
               t_l, n * x.element_size() + n * 4 + lut.LUT_ENTRIES * 4, 0,
               BF16_FLOPS_PER_S, table=name, shape=list(x.shape),
               dtype=str(x.dtype)[6:], library=note)
    # the kernel's scalar paths, bit for bit: a tail of 7 values (n =
    # 1001 * 999) and x at an address no multiple of 16 bytes (a view
    # from element 1), in f32 and bf16
    edges = {}
    silu = lut.table_for("silu", "cuda")
    x_edge = _lut_x(g, 1001, 999, 3.0)
    for dt in (torch.float32, torch.bfloat16):
        xe = x_edge.to(dt)
        for label, xx in (("tail", xe), ("unaligned", xe.reshape(-1)[1:])):
            edges[f"{label}_{str(dt)[6:]}"] = torch.equal(
                lut.lut_activation(xx, silu), lut.lut_plain(xx, silu))
    emit({"phase": "paper", "check": "lut_scalar_paths", **edges})
    if not all(edges.values()):
        fail(f"lut_activation: a scalar path differs from the plain version "
             f"{edges}")
    # what the table gathers cost: the same kernel on the same shapes
    # with every x equal (one table entry), beside the silu cases
    probe = {"phase": "paper", "check": "lut_gather_probe",
             "shape": [M, N], "x": 0.5}
    for dt in (torch.float32, torch.bfloat16):
        x = torch.full((M, N), 0.5, dtype=dt, device="cuda")
        ms = time_ms(lambda: lut.apply_lut(x, "silu"), flush=flush)
        probe[f"constant_index_{str(dt)[6:]}_ms"] = ms
    del x
    emit(probe)
    del flush
    emit({"phase": "paper", "seconds": time.perf_counter() - t_phase,
          "launches": launches,
          "block_sparse_density_1_equals_output_stationary": dense_bits,
          "block_sparse_fully_pruned_is_zero": empty_zero})
    return results, launches


def phase_serve():
    """qwen3-0.6b FULL, seeded random init, 16 requests through the
    engine with the ServeOptions defaults at batch 8.  Returns what the
    parity phase and the summary need."""
    import torch
    from repro_torch import configs
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.paged_attention import ops as pa_ops
    from repro_torch.launch.serve import serve_trace, synth_requests
    from repro_torch.models.lm import DecoderLM
    from repro_torch.serve import ServeOptions, ServePrograms

    cfg = configs.get("qwen3-0.6b")
    model = DecoderLM(cfg)                       # the GPU
    t0 = time.perf_counter()
    params = model.init(seed=0)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(t.numel() for t in _leaves(params))
    programs = ServePrograms(model)
    opts = ServeOptions(batch=8)
    # warm-up: cuBLAS handles, allocator pools, the kernels' first loads
    warm = synth_requests(cfg, 2, PROMPT_LEN, 4, rate=50.0, seed=1)
    opts.sized_for(warm).build(model, params, programs=programs).run(warm)
    torch.cuda.synchronize()

    reqs = synth_requests(cfg, N_REQUESTS, PROMPT_LEN, GEN, rate=50.0)
    opts = opts.sized_for(reqs)
    engine = opts.build(model, params, programs=programs)
    torch.cuda.reset_peak_memory_stats()
    fa_ops.launches = 0
    pa_ops.launches = 0
    stats = serve_trace(engine, reqs, realtime=True)
    launches = {"flash_attention": fa_ops.launches,
                "paged_attention": pa_ops.launches}
    L = cfg.n_layers
    want = {"flash_attention": L * stats["n_prefill_dispatches"],
            "paged_attention": L * (stats["n_decode_steps"]
                                    + stats["n_replay_steps"])}
    emit({"phase": "serve", "arch": cfg.name, "n_params": n_params,
          "init_s": init_s, "requests": stats["requests"],
          "prompt_len": PROMPT_LEN, "gen": GEN, "batch": opts.batch,
          "page_size": opts.page_size, "chunk_size": opts.chunk_size,
          "spec_k": opts.spec_k, "fused": opts.fused,
          "n_pages": opts.n_pages,
          "kv_pool_gb": 2 * engine.cache.k_pages.numel() * 2 / 1e9,
          "tokens": stats["tokens"], "wall_s": stats["wall_s"],
          "tok_per_s": stats["tok_per_s"],
          "ttft_mean_s": stats["ttft_mean_s"],
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
          "counters": {k: v for k, v in stats.items()
                       if k.startswith("n_") or k == "accept_rate"},
          "launches": launches, "launches_expected": want,
          "card": nvidia_smi_line()})
    done = sorted(engine.finished, key=lambda r: r.rid)
    if len(done) != N_REQUESTS or any(len(r.generated) != GEN
                                      for r in done):
        fail(f"serve: {len(done)} requests finished, generated "
             f"{[len(r.generated) for r in done]} tokens")
    for name, n in launches.items():
        if n < want[name] or n == 0:
            fail(f"serve: {name} launched {n} times, the path's "
                 f"dispatches need {want[name]}")
    return model, params, programs, done, launches


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def phase_parity(model, params, done):
    """Re-score every served token with one whole-sequence prefill of
    prompt + generated[:-1]: each must be within TAU of the best f32
    logit at its position.  Exact agreement with the greedy oracle is
    reported, not required (cuBLAS may pick its algorithm by the number
    of rows, so a row's bf16 bits in a batched decode and in a whole
    prefill can differ, and random-init logits sit on knife-edges)."""
    import torch
    from repro_torch.serve import greedy_generate
    ctx = torch.tensor(np.stack([np.concatenate(
        [r.prompt, np.asarray(r.generated[:-1], np.int32)]) for r in done]),
        device=model.device)
    gen = torch.tensor([r.generated for r in done], device=model.device)
    with torch.no_grad():
        logits = model.apply(params, ctx)[:, PROMPT_LEN - 1:]
    chosen = logits.gather(-1, gen.long()[..., None])[..., 0]
    gap = logits.max(-1).values - chosen             # (B, GEN) >= 0
    argmax_match = float((logits.argmax(-1) == gen).float().mean())
    oracle = greedy_generate(model, params, ctx[:, :PROMPT_LEN], GEN,
                             cache_len=PROMPT_LEN + GEN)
    same = (oracle == gen)
    prefix = same.long().cumprod(1).sum(1)           # tokens before a split
    emit({"phase": "parity", "tau": TAU, "max_gap": float(gap.max()),
          "mean_gap": float(gap.mean()),
          "logit_std": float(logits.std()),
          "teacher_forced_argmax_match": argmax_match,
          "oracle_token_match": float(same.float().mean()),
          "oracle_exact_requests": int((prefix == GEN).sum()),
          "oracle_prefix_mean": float(prefix.float().mean()),
          "finite": torch_isfinite(logits)})
    if not torch_isfinite(logits):
        fail("parity: non-finite logits")
    if float(gap.max()) > TAU:
        fail(f"parity: a served token is {float(gap.max())} below the "
             f"best logit (tau {TAU})")


def _kernel_group(name: str) -> str:
    if "paged_attention_kernel" in name:
        return "paged_attention"
    if "flash_attention_kernel" in name:
        return "flash_attention"
    low = name.lower()
    if any(t in low for t in ("gemm", "nvjet", "cutlass", "xmma", "gemv")):
        return "matmul"
    return "other"


def phase_profile(model, params, programs):
    """Where the serve time goes: 8 requests of the same shape through
    a fresh engine under torch.profiler; device time summed by kernel
    and by group, against the run's host wall time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.launch.serve import synth_requests
    from repro_torch.serve import ServeOptions
    reqs = synth_requests(model.cfg, 8, PROMPT_LEN, GEN, rate=50.0, seed=2)
    engine = ServeOptions(batch=8).sized_for(reqs).build(
        model, params, programs=programs)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        engine.run(reqs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = []
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        kernels.append((e.key, us / 1e3, e.count))
    busy_ms = sum(k[1] for k in kernels)
    groups = {}
    for name, ms, n in kernels:
        g = groups.setdefault(_kernel_group(name), {"ms": 0.0, "launches": 0})
        g["ms"] += ms
        g["launches"] += n
    kernels.sort(key=lambda k: -k[1])
    st = engine.stats()
    emit({"phase": "profile", "requests": len(reqs),
          "dispatches": int(st["n_total_dispatches"]),
          "wall_ms": wall * 1e3, "device_busy_ms": busy_ms,
          "device_idle_share": (1 - busy_ms / (wall * 1e3)) if busy_ms
          else None,
          "kernel_launches": sum(k[2] for k in kernels),
          "by_group": groups,
          "top": [[name[:90], ms, n] for name, ms, n in kernels[:12]]})


def summary_line(kernel_results, launches):
    """One entry for each kernel whose checks and path both ran."""
    sources = {"paged_attention": ("paged_attention.cu",
                                   "paged_attention/kernel.py:89", "B8_T5"),
               "flash_attention": ("flash_attention.cu",
                                   "flash_attention/kernel.py:69",
                                   "chunk_B8_C32"),
               "gemm_dataflow": ("gemm_dataflow.cu",
                                 "gemm_dataflow/kernel.py:79",
                                 "scout_expert_bf16"),
               "block_sparse": ("block_sparse.cu",
                                "block_sparse/kernel.py:44", "keep_0.36"),
               "lut_activation": ("lut_activation.cu",
                                  "lut_activation/kernel.py:38",
                                  "silu_f32")}
    out = []
    for name, (src, replaces, case) in sources.items():
        if name not in kernel_results or name not in launches:
            continue
        recs = kernel_results[name]
        main = next(r for r in recs if r["case"] == case)
        out.append({"name": name, "route": "cuda",
                    "source": f"src/repro_torch/csrc/{src}",
                    "replaces": f"src/repro/kernels/{replaces}",
                    "launches": launches[name],
                    "max_abs_err": max(r["max_abs_err"] for r in recs),
                    "ms": main["ms"], "plain_ms": main["plain_ms"],
                    "bound_ms": main["bound_ms"],
                    "bound_by": main["bound_by"],
                    "library_ms": main["library_ms"], "case": case})
    emit({"kernels": out})


def main(phases=("env", "kernels", "paper", "serve", "parity",
                 "profile")) -> int:
    # one card: the first visible one (before torch sees the devices)
    visible = os.environ.get("CUDA_VISIBLE_DEVICES")
    os.environ["CUDA_VISIBLE_DEVICES"] = (
        "0" if visible is None else visible.split(",")[0])
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs "
              "one GPU", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch" / "__init__.py").is_file():
        print(f"chip_smoke: {SRC / 'repro_torch'} not found: run from a "
              "checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    results, launches = {}, {}
    if "env" in phases:
        phase_env()
    if "kernels" in phases:
        results.update(phase_kernels())
    if "paper" in phases:
        paper_results, paper_launches = phase_paper()
        results.update(paper_results)
        launches.update(paper_launches)
    if "serve" in phases:
        model, params, programs, done, served = phase_serve()
        launches.update(served)
        if "parity" in phases:
            phase_parity(model, params, done)
        if "profile" in phases:
            phase_profile(model, params, programs)
    if results:
        summary_line(results, launches)
    print(nvidia_smi_line(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())

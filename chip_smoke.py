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
               (a row's bits depend on its own keys only).
3. **serve**   qwen3-0.6b at full width (seeded random init) serves 16
               synthetic requests through ``ServeEngine`` and the
               kernels' launch counters prove the path ran through them.
4. **parity**  every served token is re-scored teacher-forced by the
               port's whole-sequence ``apply`` on the card.
5. **profile** a shorter serve run under ``torch.profiler``: device
               time by kernel and the device's idle share.

Then a ``{"kernels": [...]}`` line, the card's name and power limit as
``nvidia-smi`` reports them, and as the last line
``{"ok": true, "device": {...}}``.  Without a GPU, or without the rest
of the repository beside this file, it exits non-zero and prints no
result.  It imports neither ``jax`` nor the JAX package ``repro``.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

HBM_BYTES_PER_S = 3.35e12       # H100 SXM device memory
BF16_FLOPS_PER_S = 989e12       # H100 SXM dense bf16 tensor-core peak

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


def time_ms(fn, *, iters: int = 20, flush=None) -> float:
    """Median device time of one call, CUDA events around each call,
    L2 flushed between calls when ``flush`` is given (in the serve path
    each of the 28 layers reads its own K/V)."""
    import torch
    fn()
    torch.cuda.synchronize()
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


def bound_ms(n_bytes: float, n_flops: float):
    t_b = n_bytes / HBM_BYTES_PER_S * 1e3
    t_f = n_flops / BF16_FLOPS_PER_S * 1e3
    return (t_b, "bytes") if t_b >= t_f else (t_f, "operations")


def max_err(got, want):
    """(max |got - want|, within ATOL + RTOL * |want| everywhere)."""
    g, w = got.float(), want.float()
    d = (g - w).abs()
    ok = bool((d <= ATOL + RTOL * w.abs()).all()) and bool(
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
        log = build.build_log(name)
        rec[f"ptxas_{name}"] = [ln.strip() for ln in log.splitlines()
                                if "registers" in ln or "spill" in ln]
    emit(rec)


def _paged_case(B, T, lengths, *, seed):
    """Inputs of one paged-attention call at qwen3-0.6b shapes: a pool
    the size the serve phase sizes (154 pages of 16), ragged lengths,
    distinct random pages per row."""
    import torch
    H, KVH, Dh, ps, P = 16, 8, 128, 16, 154
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


def _flash_bitwise(kernel, q, k, v, off, got) -> bool:
    """Keys past every row's causal frontier (a longer buffer) change
    no bit, and a row alone == the row in the batch."""
    import torch
    pad = torch.randn_like(k[:, :64])
    longer = kernel(q, torch.cat([k, pad], 1), torch.cat([v, pad], 1),
                    q_offset=off, causal=True)
    alone = kernel(q[1:2], k[1:2], v[1:2], q_offset=off[1:2], causal=True)
    return torch.equal(longer, got) and torch.equal(alone, got[1:2])


def phase_kernels():
    """Each kernel vs its plain version at the main path's shapes."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import paged_attention as pa
    flush = torch.empty(64 << 20, dtype=torch.float32, device="cuda")
    results = {}

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

    # paged attention: decode (T=1) and verify (T=5 = spec_k + 1)
    for T in (1, 5):
        lengths = [255, 17, 283, 100, 31, 200, 64, 129]
        args = _paged_case(8, T, lengths, seed=T)
        got = pa.paged_attention(*args)
        want = pa.paged_attention_plain(*args)
        bitwise = _paged_bitwise(pa.paged_attention, *args, got)
        torch.cuda.synchronize()
        n_bytes, flops = _paged_numbers(*args)
        record("paged_attention", f"B8_T{T}", got, want, bitwise,
               time_ms(lambda: pa.paged_attention(*args), flush=flush),
               time_ms(lambda: pa.paged_attention_plain(*args), iters=5,
                       flush=flush),
               time_ms(_sdpa_paged(*args), flush=flush),
               n_bytes, flops, B=8, T=T, lengths=lengths)

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
               Skv=k.shape[1], q_offset=off.tolist())
    del flush
    return results


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
    sources = {"paged_attention": ("src/repro_torch/csrc/paged_attention.cu",
                                   "src/repro/kernels/paged_attention/"
                                   "kernel.py:89", "B8_T5"),
               "flash_attention": ("src/repro_torch/csrc/flash_attention.cu",
                                   "src/repro/kernels/flash_attention/"
                                   "kernel.py:69", "chunk_B8_C32")}
    out = []
    for name, (src, replaces, case) in sources.items():
        recs = kernel_results[name]
        main = next(r for r in recs if r["case"] == case)
        out.append({"name": name, "route": "cuda", "source": src,
                    "replaces": replaces, "launches": launches[name],
                    "max_abs_err": max(r["max_abs_err"] for r in recs),
                    "ms": main["ms"], "plain_ms": main["plain_ms"],
                    "bound_ms": main["bound_ms"],
                    "bound_by": main["bound_by"],
                    "library_ms": main["library_ms"], "case": case})
    emit({"kernels": out})


def main(phases=("env", "kernels", "serve", "parity", "profile")) -> int:
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
    if "env" in phases:
        phase_env()
    if "kernels" in phases:
        results = phase_kernels()
    if "serve" in phases:
        model, params, programs, done, launches = phase_serve()
        if "parity" in phases:
            phase_parity(model, params, done)
        if "profile" in phases:
            phase_profile(model, params, programs)
        if "kernels" in phases:
            summary_line(results, launches)
    print(nvidia_smi_line(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())

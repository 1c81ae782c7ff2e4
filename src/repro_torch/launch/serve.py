"""Serving launcher of the port: the continuous-batching engine over the
paged KV cache, driven by a synthetic Poisson trace.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-0.6b \\
        --requests 16 --batch 8 --prompt-len 256 --gen 32

Runs on the GPU; ``--device cpu`` (with ``--smoke``) runs the plain
PyTorch versions of the kernels on the CPU instead.  Weights are a
random init from seed 0.  The reference launcher's ``--naive``,
``--stream``, ``--tp``, ``--replicas`` and ``--shared-prefix`` paths
are not ported yet.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from .. import configs
from ..models.lm import DecoderLM
from ..serve import Request, ServeOptions

__all__ = ["synth_requests", "serve_trace", "main"]


def synth_requests(cfg, n: int, prompt_len: int, gen: int,
                   rate: float, seed: int = 0, prefix_len: int = 0):
    """Poisson arrival trace with markov-ish prompts, draw-for-draw the
    reference launcher's trace at the same seed.  ``prefix_len`` > 0
    prepends one shared system-prompt prefix to every request."""
    rng = np.random.default_rng(seed)
    arrivals = np.cumsum(rng.exponential(1.0 / rate, size=n))

    def walk(length):
        base = rng.integers(0, cfg.vocab_size)
        drift = rng.integers(0, 17, size=length)
        return ((base + np.cumsum(drift)) % cfg.vocab_size).astype(np.int32)

    prefix = walk(prefix_len) if prefix_len else None
    reqs = []
    for i in range(n):
        prompt = walk(prompt_len)
        if prefix is not None:
            prompt = np.concatenate([prefix, prompt])
        reqs.append(Request(rid=i, prompt=prompt, max_new_tokens=gen,
                            arrival=float(arrivals[i])))
    return reqs


def serve_trace(engine, reqs, *, realtime: bool = True) -> dict:
    """Serve ``reqs`` to completion and return the run's stats:
    throughput, mean TTFT, dispatch and cache-reuse counters."""
    t0 = time.perf_counter()
    done = engine.run(reqs, realtime=realtime)
    if engine.model.device.type == "cuda":
        torch.cuda.synchronize(engine.model.device)
    dt = time.perf_counter() - t0
    st = engine.stats()
    toks = sum(len(r.generated) for r in done)
    ttfts = [r.ttft for r in done if r.ttft is not None
             and r.ttft != float("inf")]
    return {"requests": len(done), "tokens": toks, "wall_s": dt,
            "tok_per_s": toks / max(dt, 1e-9),
            "ttft_mean_s": float(np.mean(ttfts)) if ttfts else float("nan"),
            **{k: (int(v) if float(v).is_integer() else float(v))
               for k, v in st.items()}}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--rate", type=float, default=50.0,
                    help="Poisson arrival rate (req/s)")
    ap.add_argument("--device", default=None,
                    help="default: the GPU (raises without one); 'cpu' "
                         "runs the kernels' plain versions")
    ServeOptions.add_cli(ap)
    args = ap.parse_args(argv)

    cfg = (configs.get_smoke if args.smoke else configs.get)(args.arch)
    model = DecoderLM(cfg, device=args.device)
    params = model.init(seed=0)
    reqs = synth_requests(cfg, args.requests, args.prompt_len, args.gen,
                          args.rate)
    opts = ServeOptions.from_args(args).sized_for(reqs)
    stats = serve_trace(opts.build(model, params), reqs)
    where = (torch.cuda.get_device_name(model.device)
             if model.device.type == "cuda" else "cpu")
    spec_note = (f"{stats['n_spec_rounds']} verify rounds, accept rate "
                 f"{stats['accept_rate']:.2f}, " if opts.spec_k else "")
    print(f"[{where}] {stats['requests']} requests ({args.prompt_len}+"
          f"{args.gen} tok) batch={opts.batch} "
          f"pages={opts.n_pages}x{opts.page_size}: "
          f"{stats['tok_per_s']:.1f} tok/s, "
          f"TTFT {stats['ttft_mean_s'] * 1e3:.0f} ms, "
          f"{stats['n_decode_steps']} decode steps, {spec_note}"
          f"{stats['n_prefill_chunks']} prefill chunks in "
          f"{stats['n_prefill_dispatches']} dispatches, "
          f"{stats['n_fused_dispatches']}/{stats['n_total_dispatches']} "
          f"launches fused, {stats['n_shared_tokens']} prefix tokens "
          f"reused, {stats['n_cow']} COW copies")
    return stats


if __name__ == "__main__":
    main()

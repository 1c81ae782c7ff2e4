"""Serving launcher of the port: the continuous-batching engine over the
paged KV cache, a routed or elastic fleet of engines, or the streaming
front-end (``--stream``), driven by a synthetic Poisson trace.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-0.6b \\
        --requests 16 --batch 8 --prompt-len 256 --gen 32

``--replicas M`` puts M engine replicas behind the request router
(``--router-policy prefix|least-loaded|round-robin``); ``--max-replicas
N`` makes the fleet *elastic* instead (replicas scale between
``--min-replicas`` and N with demand, live requests migrating off
draining replicas with token streams unchanged); ``--chaos-faults``
wraps replicas in scripted fault injectors (crashed replicas' requests
are rebuilt from the router's journal and replayed on survivors).
``--stream`` serves the same trace through ``ServeFrontend``:
per-request token streams, SLO classes (every 4th request is
interactive), and ``--tenant-weights`` fair sharing.  On one GPU every
replica shares the card.

Runs on the GPU; ``--device cpu`` (with ``--smoke``) runs the plain
PyTorch versions of the kernels on the CPU instead.  Weights are a
random init from seed 0.  The reference launcher's ``--naive`` loop and
its deprecated ``run_engine`` shim are not ported, nor is ``--tp``.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from .. import configs
from ..models.lm import DecoderLM
from ..serve import Request, ServeOptions

__all__ = ["synth_requests", "fleet_of", "backend_device", "serve_trace",
           "run_stream", "main"]


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


def fleet_of(backend):
    """(router-or-backend, engines): the fleet behind ``backend`` — an
    engine (possibly a fault-injecting wrapper), a router or an elastic
    controller — and its live members."""
    router = getattr(backend, "router", backend)
    return router, list(getattr(router, "replicas", [backend]))


def backend_device(backend) -> torch.device:
    """The device ``backend`` serves on: its fleet's first replica's."""
    return fleet_of(backend)[1][0].model.device


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _number(v):
    return int(v) if float(v).is_integer() else float(v)


def _drive(front, reqs, *, realtime: bool) -> dict:
    """Run the trace and aggregate counters through the backend's own
    ``stats()`` — the ``ServeBackend`` contract every backend (engine,
    router, elastic controller) implements.  Summing over the live
    replica list here would silently drop the work of replicas that
    left an elastic fleet mid-trace; the protocol's stats fold departed
    replicas in."""
    device = backend_device(front)       # before any replica can leave
    t0 = time.perf_counter()
    done = front.run(reqs, realtime=realtime)
    _sync(device)
    dt = time.perf_counter() - t0
    st = front.stats()
    router, engines = fleet_of(front)
    toks = sum(len(r.generated) for r in done)
    ttfts = [r.ttft for r in done if r.ttft is not None
             and r.ttft != float("inf")]
    return {"requests": len(done), "tokens": toks, "wall_s": dt,
            "tok_per_s": toks / max(dt, 1e-9),
            "ttft_mean_s": float(np.mean(ttfts)) if ttfts else float("nan"),
            # per-engine breakdowns read the live members
            "engine_stats": [e.stats() for e in engines],
            "dispatched": list(getattr(router, "n_dispatched",
                                       [len(done)])),
            **{k: _number(v) for k, v in st.items()}}


def serve_trace(backend, reqs, *, realtime: bool = True,
                trace_out: str = "") -> dict:
    """Serve ``reqs`` to completion on a built backend and return the
    run's stats: throughput, mean TTFT, the backend's own counters
    (fleet-wide, departed replicas included) and per-engine stats.
    With ``trace_out`` the run's telemetry (spans, step timeline,
    metrics) lands there as JSONL."""
    out = _drive(backend, reqs, realtime=realtime)
    _write_trace(trace_out, backend, realtime=realtime)
    return out


def _write_trace(path: str, backend, *, realtime: bool) -> None:
    tel = getattr(backend, "tel", None)
    if tel is None or not path:
        return
    tel.clock_label = "seconds" if realtime else "steps"
    tel.write_jsonl(path)
    print(f"telemetry: wrote {path}")


def run_stream(opts: ServeOptions, model, params, reqs, *,
               smoke: bool = False, programs=None) -> dict:
    """Serve the trace through the async front-end: submit each
    request when its arrival time comes due (wall clock), pump until
    every stream completes, and report per-SLO-class TTFT plus the
    per-tenant token split.  Every 4th request is interactive; tenants
    rotate round-robin through ``opts.tenant_weights`` names.  The
    returned dict holds the front-end under ``"frontend"`` and the
    ``TokenStream`` of every request under ``"streams"`` (rid -> stream)
    beside the numbers."""
    fe = opts.build_frontend(model, params, smoke=smoke, programs=programs,
                             realtime=True)
    device = backend_device(fe.backend)
    tenants = list(opts.tenant_weights) or ["default"]
    pending = sorted(reqs, key=lambda r: (r.arrival, r.rid))
    streams = {}
    t0 = time.perf_counter()
    while pending or fe.busy:
        now = time.perf_counter() - t0
        while pending and pending[0].arrival <= now:
            r = pending.pop(0)
            r.tenant = tenants[r.rid % len(tenants)]
            r.slo_class = "interactive" if r.rid % 4 == 0 else "batch"
            streams[r.rid] = fe.submit_request(r)
        if not fe.pump() and pending:
            time.sleep(max(0.0, pending[0].arrival
                           - (time.perf_counter() - t0)))
    _sync(device)
    dt = time.perf_counter() - t0
    done = fe.completed
    toks = sum(len(r.generated) for r in done)
    st = fe.stats()
    ttft = {}
    for cls in ("interactive", "batch"):
        ts = [r.ttft for r in done
              if r.slo_class == cls and r.ttft is not None]
        if ts:
            ttft[cls] = {"n": len(ts), "mean_s": float(np.mean(ts)),
                         "p99_s": float(np.percentile(ts, 99))}
    shares = {t: int(st[f"tenant_tokens[{t}]"]) for t in tenants
              if f"tenant_tokens[{t}]" in st}
    _write_trace(opts.trace_out, fe, realtime=True)
    return {"frontend": fe, "streams": streams, "requests": len(done),
            "tokens": toks,
            "wall_s": dt, "tok_per_s": toks / max(dt, 1e-9),
            "ttft_by_class": ttft, "tenant_tokens": shares,
            "n_slo_preemptions": int(st["n_slo_preemptions"]),
            "n_cancelled": int(st["n_cancelled"]),
            "n_shed": int(st["n_shed"]),
            "backend": {k: _number(v)
                        for k, v in fe.backend.stats().items()}}


def _print_stream(stats: dict, where: str) -> None:
    print(f"[{where}] stream: {stats['requests']} streams, "
          f"{stats['tokens']} tokens in {stats['wall_s']:.2f}s "
          f"({stats['tok_per_s']:.1f} tok/s)")
    for cls, t in stats["ttft_by_class"].items():
        print(f"  {cls:<12} n={t['n']:<3} "
              f"TTFT mean {t['mean_s'] * 1e3:.0f} ms "
              f"p99 {t['p99_s'] * 1e3:.0f} ms")
    if len(stats["tenant_tokens"]) > 1:
        print("  tenant tokens: " + ", ".join(
            f"{t}={v}" for t, v in stats["tenant_tokens"].items()))
    print(f"  {stats['n_slo_preemptions']} SLO preemptions, "
          f"{stats['n_cancelled']} cancelled")


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--shared-prefix", type=int, default=0,
                    help="tokens of system prompt shared by every "
                         "request (exercises the prefix cache)")
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--rate", type=float, default=50.0,
                    help="Poisson arrival rate (req/s)")
    ap.add_argument("--stats", action="store_true",
                    help="dump per-engine counter stats (dispatches, "
                         "co-ingestion occupancy, cache reuse) after "
                         "the run")
    ap.add_argument("--device", default=None,
                    help="default: the GPU (raises without one); 'cpu' "
                         "runs the kernels' plain versions")
    ServeOptions.add_cli(ap)
    args = ap.parse_args(argv)

    cfg = (configs.get_smoke if args.smoke else configs.get)(args.arch)
    model = DecoderLM(cfg, device=args.device)
    params = model.init(seed=0)
    reqs = synth_requests(cfg, args.requests, args.prompt_len, args.gen,
                          args.rate, prefix_len=args.shared_prefix)
    opts = ServeOptions.from_args(args).sized_for(
        reqs, shared_prefix=args.shared_prefix)
    where = (torch.cuda.get_device_name(model.device)
             if model.device.type == "cuda" else "cpu")

    if args.stream:
        stats = run_stream(opts, model, params, reqs, smoke=args.smoke)
        _print_stream(stats, where)
        return stats

    stats = serve_trace(opts.build(model, params, smoke=args.smoke), reqs,
                        trace_out=opts.trace_out)
    spec_note = (f"{stats['n_spec_rounds']} verify rounds, accept rate "
                 f"{stats['accept_rate']:.2f} ({stats['n_draft_accepted']}"
                 f"/{stats['n_drafted']} drafts), " if opts.spec_k else "")
    dist_note = ""
    if opts.replicas > 1 or opts.max_replicas > 0:
        dist_note = (f"{opts.replicas} replica(s) [{opts.router_policy}] "
                     f"dispatched {stats['dispatched']}, "
                     f"{stats['n_affinity_hits']} affinity hits, "
                     f"{stats['n_failures']} failures "
                     f"({stats['n_recovered_requests']} requests "
                     f"recovered), ")
    if opts.max_replicas > 0:
        dist_note += (f"elastic {opts.min_replicas}..{opts.max_replicas} "
                      f"(peak {stats['n_replicas_peak']}, "
                      f"{stats['n_scale_ups']} up / "
                      f"{stats['n_scale_downs']} down, "
                      f"{stats['n_migrations']} migrations), ")
    print(f"[{where}] {stats['requests']} requests ({args.shared_prefix}+"
          f"{args.prompt_len}+{args.gen} tok) batch={opts.batch} "
          f"pages={opts.n_pages}x{opts.page_size}: "
          f"{stats['tok_per_s']:.1f} tok/s, "
          f"TTFT {stats['ttft_mean_s'] * 1e3:.0f} ms, {dist_note}"
          f"{stats['n_decode_steps']} decode steps, {spec_note}"
          f"{stats['n_prefill_chunks']} prefill chunks in "
          f"{stats['n_prefill_dispatches']} dispatches, "
          f"{stats['n_fused_dispatches']}/{stats['n_total_dispatches']} "
          f"launches fused, {stats['n_shared_tokens']} prefix tokens "
          f"reused, {stats['n_cow']} COW copies")
    if args.stats:
        for i, es in enumerate(stats["engine_stats"]):
            print(f"engine[{i}] stats: "
                  + ", ".join(f"{k}={v:.2f}" if isinstance(v, float)
                              else f"{k}={v}" for k, v in es.items()))
    return stats


if __name__ == "__main__":
    main()

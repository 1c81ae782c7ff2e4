"""The port's serve engine (``repro_torch.serve``) on the JAX engine
tests' traces: token-exact against the port's own ``greedy_generate``
(bf16, on the CPU) with and without speculation, under preemption,
chunking and prefix sharing; and, with ``spec_k=0`` and no EOS (where
token values cannot steer scheduling), the same dispatch counters as
the JAX engine on the same trace."""
import jax
import numpy as np
import pytest

from repro import configs as jconfigs
from repro.models import build_model
from repro.serve import Request as JRequest
from repro.serve import ServeEngine as JServeEngine
from repro_torch import configs
from repro_torch.checkpoint import params_from_jax
from repro_torch.launch import serve as launch
from repro_torch.models.lm import DecoderLM
from repro_torch.serve import (Request, ServeEngine, ServeOptions,
                               greedy_generate)

ARCH = "qwen3-0.6b"
COUNTERS = ["n_prefill_dispatches", "n_prefill_chunks", "n_decode_steps",
            "n_replay_steps", "n_fused_dispatches", "n_total_dispatches"]


@pytest.fixture(scope="module")
def ref():
    cfg = jconfigs.get_smoke(ARCH)
    model = build_model(cfg)
    return model, model.init(jax.random.PRNGKey(0))


@pytest.fixture(scope="module")
def port(ref):
    cfg = configs.get_smoke(ARCH)
    params = params_from_jax(jax.tree.map(np.asarray, ref[1]), cfg,
                             device="cpu")
    return cfg, DecoderLM(cfg, device="cpu"), params


def _prompts(cfg, seed, lens):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab_size, size=(L,)).astype(np.int32)
            for L in lens]


def _oracle(model, params, prompts, gen, memo=None):
    """{i: greedy_generate of prompt i}; ``memo`` ({(prompt bytes,
    gen): tokens}) keeps each stream for the next call that asks."""
    memo = {} if memo is None else memo
    out = {}
    for i, p in enumerate(prompts):
        key = (p.tobytes(), gen)
        if key not in memo:
            memo[key] = greedy_generate(model, params, p[None], gen,
                                        cache_len=len(p) + gen)[0].numpy()
        out[i] = memo[key]
    return out


@pytest.fixture(scope="module")
def streams():
    """The port's greedy streams, shared by the engine tests' cases
    (``_oracle``'s ``memo``)."""
    return {}


def _run(model, params, prompts, gen, **kw):
    eng = ServeEngine(model, params, **kw)
    done = eng.run([Request(rid=i, prompt=p, max_new_tokens=gen)
                    for i, p in enumerate(prompts)])
    assert len(done) == len(prompts)
    return eng, done


def _assert_parity(done, oracle):
    for r in done:
        np.testing.assert_array_equal(
            np.asarray(r.generated, np.int32), oracle[r.rid],
            err_msg=f"request {r.rid} diverged")


# ------------------------------------------------------------ parity
@pytest.mark.parametrize("spec_k", [0, 4])
def test_engine_token_exact_vs_greedy_generate(port, streams, spec_k):
    cfg, model, params = port
    prompts, gen = _prompts(cfg, 7, [9, 17, 24, 12, 31, 8]), 10
    eng, done = _run(model, params, prompts, gen, max_batch=3, n_pages=24,
                     page_size=8, max_pages_per_seq=8, spec_k=spec_k)
    _assert_parity(done, _oracle(model, params, prompts, gen, streams))
    eng.cache.check_invariants()
    eng.cache.release_prefix_pages(len(eng.cache.prefix))
    eng.cache.check_invariants()
    assert eng.cache.free_pages == 23


@pytest.mark.parametrize("spec_k,n_pages", [(0, 13), (4, 10)])
def test_engine_preemption_token_exact(port, streams, spec_k, n_pages):
    """A small pool forces preemption; the evicted request replays and
    still matches the oracle."""
    cfg, model, params = port
    prompts, gen = _prompts(cfg, 11, [30, 28, 18]), 8
    eng, done = _run(model, params, prompts, gen, max_batch=3,
                     n_pages=n_pages, page_size=8, max_pages_per_seq=8,
                     prefix_sharing=False, spec_k=spec_k)
    assert sum(r.n_preemptions for r in done) >= 1
    assert eng.n_replay_steps >= 1
    _assert_parity(done, _oracle(model, params, prompts, gen, streams))
    eng.cache.check_invariants()


@pytest.mark.parametrize("spec_k", [0, 4])
def test_engine_chunking_and_prefix_sharing_token_exact(port, streams,
                                                        spec_k):
    cfg, model, params = port
    # a prompt spanning five chunks and several context buckets
    long = _prompts(cfg, 5, [70])
    eng, done = _run(model, params, long, 6, max_batch=2, n_pages=16,
                     page_size=8, max_pages_per_seq=12, chunk_size=16,
                     bucket_edges=[2, 4, 8, 12], spec_k=spec_k)
    assert eng.n_prefill_chunks == 5
    _assert_parity(done, _oracle(model, params, long, 6, streams))
    # three prompts sharing a 20-token prefix that diverges mid-page
    rng = np.random.default_rng(3)
    prefix = rng.integers(0, cfg.vocab_size, size=(20,)).astype(np.int32)
    prompts = [np.concatenate([prefix, rng.integers(
        0, cfg.vocab_size, size=(7,)).astype(np.int32)]) for _ in range(3)]
    eng, done = _run(model, params, prompts, 6, max_batch=2, n_pages=32,
                     page_size=8, max_pages_per_seq=8, chunk_size=16,
                     spec_k=spec_k)
    assert eng.cache.n_shared_tokens >= 2 * 20 and eng.cache.n_cow >= 2
    _assert_parity(done, _oracle(model, params, prompts, 6, streams))
    eng.cache.check_invariants()


def test_traced_engine_spans_and_stream_events(port):
    """The port's telemetry copy on the port's engine: every span is
    well formed, the dispatch identity audits clean, and the engine is a
    ``ServeBackend`` whose stream events reproduce each request."""
    from repro_torch.serve.backend import ServeBackend
    from repro_torch.serve.telemetry import Telemetry, check_spans
    cfg, model, params = port
    prompts = _prompts(cfg, 7, [9, 17, 24, 12])
    eng = ServeEngine(model, params, max_batch=2, n_pages=24, page_size=8,
                      max_pages_per_seq=8, spec_k=4,
                      telemetry=Telemetry(trace=True))
    assert isinstance(eng, ServeBackend)
    for i, p in enumerate(prompts):
        eng.submit(Request(rid=i, prompt=p, max_new_tokens=6))
    streamed = {i: [] for i in range(len(prompts))}
    while eng.step():
        for ev in eng.drain_events():
            streamed[ev.rid].extend(ev.tokens)
    for ev in eng.drain_events():
        streamed[ev.rid].extend(ev.tokens)
    check_spans(eng.finished, backend=eng)
    assert {r.rid: list(r.generated) for r in eng.finished} == streamed
    assert any(rec["kind"] == "fused" for rec in eng.tel.records)


# ------------------------------------------------- dispatch counters
def _drive_counters(engine, request_cls, prompts, gen):
    for i, p in enumerate(prompts):
        engine.submit(request_cls(rid=i, prompt=p, max_new_tokens=gen,
                                  arrival=0.0))
    while engine.step(now=0.0):
        pass
    st = engine.stats()
    return {k: int(st[k]) for k in COUNTERS}


@pytest.mark.parametrize("fused", [True, False])
def test_dispatch_counters_equal_reference(ref, port, fused):
    """The fused-step trace of tests/test_serve_fused.py (6 requests x
    16 tokens, chunk 8, co-ingest 2, 4 slots), spec_k=0, no EOS."""
    cfg, model, params = port
    prompts = _prompts(cfg, 7, [16] * 6)
    kw = dict(fused=fused, max_batch=4, n_pages=64, page_size=8,
              max_pages_per_seq=8, chunk_size=8, prefill_batch=2,
              prefix_sharing=False)
    want = _drive_counters(JServeEngine(ref[0], ref[1], **kw), JRequest,
                           prompts, 6)
    got = _drive_counters(ServeEngine(model, params, **kw), Request,
                          prompts, 6)
    assert got == want
    # the reference's pinned numbers for this trace
    assert got["n_total_dispatches"] == (14 if fused else 17)


# -------------------------------------------------------- options / CLI
def test_serve_options_defaults_build_the_main_path_engine(port):
    cfg, model, params = port
    reqs = launch.synth_requests(cfg, 4, 24, 6, rate=100.0)
    opts = ServeOptions(batch=2).sized_for(reqs)
    # one null page + (pages + headroom) per slot + one prefix page
    assert opts.n_pages == 1 + 2 * (2 + 1) + 1
    assert opts.max_pages_per_seq == 2
    eng = opts.build(model, params)
    assert (eng.spec_k, eng.fused, eng.chunk_size, eng.prefill_batch) == \
        (4, True, 32, 2)
    assert eng.cache.prefix is not None


def test_launcher_serves_on_cpu(capsys):
    stats = launch.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                         "--requests", "4", "--batch", "2",
                         "--prompt-len", "12", "--gen", "5",
                         "--rate", "1000"])
    assert stats["requests"] == 4 and stats["tokens"] == 20
    assert stats["n_total_dispatches"] > 0
    assert "[cpu] 4 requests" in capsys.readouterr().out


def test_synth_requests_match_reference_trace():
    from repro.launch.serve import synth_requests as jsynth
    cfg = configs.get_smoke(ARCH)
    a = launch.synth_requests(cfg, 5, 9, 3, rate=10.0, prefix_len=4)
    b = jsynth(jconfigs.get_smoke(ARCH), 5, 9, 3, rate=10.0, prefix_len=4)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x.prompt, y.prompt)
        assert (x.arrival, x.max_new_tokens) == (y.arrival, y.max_new_tokens)

"""Tensor-parallel serving in the port (``repro_torch.serve.parallel``):
the traces of the reference's ``tests/test_serve_parallel.py`` on
shards named ``[cpu] * tp``, in f32 compute, one process.

Every stream of a tp-way engine equals the port's single-device
engine's and the reference's single-device ``ServeEngine``'s on the
same bridged weights (the reference's own tests hold its tp 2 equal to
its tp 1), token for token, across chunked prefill, prefix sharing with
mid-page COW, speculation, batched prefill and preemption.  Each shard's
pages hold KVH / tp heads and equal the matching head slice of the
single-device pool.

On the CPU a product ``a @ b`` need not give a column the bits it gets
in a product of fewer columns (torch 2.13, measured: M 1, K 128, N 96
against its four column quarters, 4.8e-6 apart), so a shard's slice of
a projection may differ from the single device's in the last bits: one
dispatch of each program holds the logits within LOGIT_ATOL of tp 1
(and each shard's logits equal to shard 0's, bit for bit).  On the card
the same comparisons are ``torch.equal`` (``chip_smoke.py``'s tp
phase).
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.configs.base import ModelConfig as JModelConfig
from repro.models import build_model as jbuild
from repro.serve import Request as JRequest
from repro.serve import ServeEngine as JServeEngine
from repro.serve.parallel import validate_tp as jvalidate_tp
from repro_torch import configs
from repro_torch.checkpoint import params_from_jax
from repro_torch.launch import serve as launch
from repro_torch.models import build_model
from repro_torch.serve import Request, ServeEngine, ServeOptions
from repro_torch.serve.parallel import (ShardedPages, TPServePrograms,
                                        make_tp_devices, validate_tp)
from repro_torch.serve.step import ServePrograms
from test_torch_model import to_port_config

#: f32 logits of one dispatch, tp vs tp 1 on the CPU (see the docstring)
LOGIT_ATOL = 1e-4

#: the reference's 8 H / 4 KVH config of its tp 4 test
TP4 = JModelConfig(name="tp4-test", family="dense", n_layers=2, d_model=64,
                   n_heads=8, n_kv_heads=4, head_dim=16, d_ff=128,
                   vocab_size=256, qk_norm=True, tie_embeddings=True,
                   attn_kv_chunk=16)
#: its bias / GELU / LayerNorm / untied-head config
BIAS = JModelConfig(name="tp-bias-test", family="dense", n_layers=2,
                    d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
                    d_ff=128, vocab_size=256, qkv_bias=True,
                    mlp_kind="gelu", norm_kind="layernorm",
                    tie_embeddings=False, attn_kv_chunk=16)


def _pair(jcfg, seed):
    """(reference model, its params, port model, its params) in f32
    compute on the reference's init from PRNGKey(seed)."""
    jcfg = dataclasses.replace(jcfg, compute_dtype="float32")
    jmodel = jbuild(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(seed))
    cfg = to_port_config(jcfg)
    params = params_from_jax(jax.tree.map(np.asarray, jparams), cfg,
                             device="cpu")
    return jmodel, jparams, build_model(cfg, device="cpu"), params


def _streams(engine, prompts, gen, request=Request):
    done = engine.run([request(rid=i, prompt=p, max_new_tokens=gen)
                       for i, p in enumerate(prompts)])
    assert len(done) == len(prompts)
    return {r.rid: list(r.generated) for r in done}


def _check_pages(tp_engine, one_engine):
    """Each shard's pools hold KVH / tp heads: the head slice of the
    single-device pool, bit for bit, but for the null page 0, where
    padding and masked rows write in an order no one reads."""
    tp = tp_engine.tp
    for name in ("k_pages", "v_pages"):
        whole = getattr(one_engine.cache, name)
        pages = getattr(tp_engine.cache, name)
        assert isinstance(pages, ShardedPages)
        assert len(pages.shards) == tp
        for piece, want in zip(pages.shards, whole.chunk(tp, -2)):
            assert piece.shape[-2] == whole.shape[-2] // tp
            assert piece.nbytes * tp == whole.nbytes
            assert torch.equal(piece[:, 1:], want[:, 1:]), name


def _serve_all(jcfg, seed, prompts, gen, tp, **kw):
    """Streams of the reference's engine, the port's tp 1 and tp ``tp``
    (shards on the CPU) on one trace; returns the two port engines."""
    jmodel, jparams, model, params = _pair(jcfg, seed)
    want = _streams(JServeEngine(jmodel, jparams, **kw), prompts, gen,
                    JRequest)
    one = ServeEngine(model, params, **kw)
    sharded = ServeEngine(model, params, mesh=["cpu"] * tp, **kw)
    assert sharded.tp == tp
    assert _streams(one, prompts, gen) == want
    assert _streams(sharded, prompts, gen) == want
    _check_pages(sharded, one)
    sharded.cache.check_invariants()
    return one, sharded


def _rand(seed, lens, vocab):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, size=(L,)).astype(np.int32)
            for L in lens]


def test_tp2_token_parity_sharing_and_spec():
    """Chunked prefill, prefix sharing with mid-page COW (a page copy in
    every shard) and speculative decode."""
    cfg = jconfigs.get_smoke("qwen3-0.6b")
    rng = np.random.default_rng(3)
    prefix = rng.integers(0, cfg.vocab_size, size=(20,)).astype(np.int32)
    prompts = [np.concatenate([prefix, rng.integers(
        0, cfg.vocab_size, size=(7,)).astype(np.int32)]) for _ in range(3)]
    prompts.append(rng.integers(0, cfg.vocab_size,
                                size=(40,)).astype(np.int32))
    _, tp = _serve_all(cfg, 0, prompts, 6, 2, max_batch=2, n_pages=40,
                       page_size=8, max_pages_per_seq=8, chunk_size=16,
                       spec_k=4)
    assert tp.cache.n_cow >= 2 and tp.n_spec_rounds >= 1


def test_tp2_batched_prefill_parity():
    """A tp 2 engine co-ingesting a burst (prefill_batch 4) streams as
    the single-device serialized engine."""
    cfg = jconfigs.get_smoke("qwen3-0.6b")
    rng = np.random.default_rng(13)
    prefix = rng.integers(0, cfg.vocab_size, size=(20,)).astype(np.int32)
    prompts = [np.concatenate([prefix, rng.integers(
        0, cfg.vocab_size, size=(7,)).astype(np.int32)]) for _ in range(3)]
    prompts += _rand(14, (15, 33), cfg.vocab_size)
    jmodel, jparams, model, params = _pair(cfg, 0)
    kw = dict(max_batch=4, n_pages=64, page_size=8, max_pages_per_seq=8,
              chunk_size=16)
    want = _streams(JServeEngine(jmodel, jparams, prefill_batch=1, **kw),
                    prompts, 6, JRequest)
    tp = ServeEngine(model, params, mesh=["cpu", "cpu"], prefill_batch=4,
                     **kw)
    assert _streams(tp, prompts, 6) == want
    assert tp.n_prefill_dispatches < tp.n_prefill_chunks
    assert tp.cache.n_shared_tokens >= 2 * 20
    tp.cache.check_invariants()


def test_tp2_preemption_replay_parity():
    """Page pressure forces eviction and replay on the sharded engine."""
    cfg = jconfigs.get_smoke("qwen3-0.6b")
    _, tp = _serve_all(cfg, 0, _rand(11, (30, 28, 18), cfg.vocab_size), 8,
                       2, max_batch=3, n_pages=13, page_size=8,
                       max_pages_per_seq=8, prefix_sharing=False)
    assert tp.n_replay_steps >= 1


def test_tp4_token_parity_shared_programs():
    """tp 4 (8 H / 4 KVH: one KV head a shard); two engines share one
    ``TPServePrograms`` and its one split of the parameters."""
    jmodel, jparams, model, params = _pair(TP4, 1)
    prompts = _rand(5, (9, 21, 14), 256)
    kw = dict(max_batch=2, n_pages=24, page_size=8, max_pages_per_seq=8)
    want = _streams(JServeEngine(jmodel, jparams, **kw), prompts, 6,
                    JRequest)
    progs = TPServePrograms(model, devices=["cpu"] * 4)
    a = ServeEngine(model, params, programs=progs, **kw)
    b = ServeEngine(model, params, programs=progs, **kw)
    assert a.params is b.params
    assert _streams(a, prompts, 6) == want
    assert _streams(b, prompts, 6) == want
    _check_pages(a, _run_one(model, params, prompts, 6, **kw))


def _run_one(model, params, prompts, gen, **kw):
    one = ServeEngine(model, params, **kw)
    _streams(one, prompts, gen)
    return one


def test_tp2_parity_bias_gelu_untied_family():
    """QKV biases (sharded with their heads), GELU w1 / b1 (sharded
    hidden), LayerNorm and an untied head (replicated), spec on."""
    _serve_all(BIAS, 3, _rand(2, (9, 21, 14), 256), 6, 2, max_batch=2,
               n_pages=24, page_size=8, max_pages_per_seq=8, spec_k=3)


def test_fleet_shares_one_tp_bundle():
    """``ServeOptions.build`` hands one ``TPServePrograms`` (shards
    named ``cpu``) to every replica of the router; the fleet serves the
    tp 1 fleet's streams."""
    cfg = configs.get_smoke("qwen3-0.6b")
    model = build_model(dataclasses.replace(cfg, compute_dtype="float32"),
                        device="cpu")
    params = model.init(seed=0)
    def trace():
        return launch.synth_requests(model.cfg, 6, 16, 6, 100.0)
    opts = ServeOptions(batch=2, replicas=2).sized_for(trace())
    want = {r.rid: r.generated
            for r in opts.build(model, params).run(trace(), realtime=False)}
    backend = dataclasses.replace(opts, tp=2).build(
        model, params, programs=TPServePrograms(model, devices=["cpu"] * 2))
    _, engines = launch.fleet_of(backend)
    assert len(engines) == 2
    assert len({id(e.programs) for e in engines}) == 1
    assert isinstance(engines[0].programs, TPServePrograms)
    got = {r.rid: r.generated
           for r in backend.run(trace(), realtime=False)}
    assert got == want


# ------------------------------------------------ one dispatch each
def _states(model, programs, n_pages=16, page_size=8):
    """(tp 1 state, tp state): zero pools, the second sharded."""
    cfg = model.cfg
    shape = (cfg.n_layers, n_pages, page_size, cfg.n_kv_heads, cfg.head_dim)
    whole = {n: torch.zeros(shape, dtype=torch.bfloat16)
             for n in ("k_pages", "v_pages")}
    return whole, {n: programs.prepare_pages(t.clone())
                   for n, t in whole.items()}


@pytest.mark.parametrize("jcfg", [jconfigs.get_smoke("qwen3-0.6b"), BIAS],
                         ids=["qwen3", "bias_gelu"])
def test_program_logits_match_tp1(jcfg):
    """One dispatch of chunk, decode, verify (T 5) and fused: every
    shard's logits equal shard 0's, within LOGIT_ATOL of tp 1, and the
    tokens the programs return equal tp 1's; the pools stay equal."""
    _, _, model, params = _pair(jcfg, 0)
    progs = TPServePrograms(model, devices=["cpu", "cpu"])
    one = ServePrograms(model)
    p1, ptp = one.prepare_params(params), progs.prepare_params(params)
    s1, stp = _states(model, progs)
    rng = np.random.default_rng(7)
    V = model.cfg.vocab_size

    def t(*shape):
        return torch.from_numpy(rng.integers(0, V, shape).astype(np.int32))

    def i32(x):
        return torch.tensor(x, dtype=torch.int32)

    def both(method, *args, extra=None):
        want = getattr(model, method)(p1, {**s1, **(extra or {})}, *args)[0]
        got = progs.map_shards(
            lambda m, g, p, st, *a: getattr(m, method)(p, st, *a,
                                                       gather=g)[0],
            ptp, {**stp, **(extra or {})}, *args)
        for a, b in zip(*(w if isinstance(w, tuple) else (w,)
                          for w in (want, got[0]))):
            torch.testing.assert_close(b, a, rtol=0, atol=LOGIT_ATOL)
        for g in got[1:]:
            for a, b in zip(*(x if isinstance(x, tuple) else (x,)
                              for x in (got[0], g))):
                assert torch.equal(a, b)
        return want

    # two rows of 12 prompt tokens on pages 1-2 and 3-4
    tables = i32([[1, 2], [3, 4]])
    both("prefill_chunk_paged", t(2, 12), tables, i32([0, 0]), i32([12, 12]))
    state = {"page_tables": tables, "lengths": i32([12, 12])}
    both("decode_step_paged", t(2, 1), extra=state)
    both("verify_step_paged", t(2, 5),
         extra={**state, "lengths": i32([13, 13])})
    both("fused_step_paged", t(2, 1), t(1, 8), i32([[5, 6]]), i32([0]),
         i32([8]), extra={**state, "lengths": i32([18, 18])})
    for name in ("k_pages", "v_pages"):
        for piece, want in zip(stp[name].shards, s1[name].chunk(2, -2)):
            assert torch.equal(piece[:, 1:], want[:, 1:]), name
    # the engine's program surface: tokens from shard 0, equal to tp 1's
    st1 = {**s1, **state, "lengths": i32([19, 19])}
    sttp = {**stp, **state, "lengths": i32([19, 19])}
    tok = t(2, 1)
    assert torch.equal(progs.decode(ptp, sttp, tok)[0],
                       one.decode(p1, st1, tok)[0])


# ---------------------------------------------------------- refusals
def _jmodel(name):
    return jbuild(jconfigs.get_smoke(name))


@pytest.mark.parametrize("arch,tp", [
    ("qwen3-0.6b", 2), ("qwen3-0.6b", 4), ("qwen2-0.5b", 2),
    ("llama4-scout-17b-a16e", 2), ("deepseek-moe-16b", 2),
    ("rwkv6-3b", 2)])
def test_validate_tp_refuses_as_the_reference(arch, tp):
    """The reference's ``test_tp_validation_rejects_bad_configs`` and
    its other refusals: the same configs raise the same message."""
    model = build_model(configs.get_smoke(arch), device="cpu")
    jmodel = _jmodel(arch)
    try:
        jvalidate_tp(jmodel, tp)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            validate_tp(model, tp)
        assert str(got.value) == str(e)
    else:
        validate_tp(model, tp)


def test_refusals_without_enough_cards():
    """No CUDA device here: tp 2 without named devices raises, naming
    the count, at every entry point; nothing falls back to the CPU."""
    assert not torch.cuda.is_available()
    model = build_model(configs.get_smoke("qwen3-0.6b"), device="cpu")
    match = "tp=2 exceeds 0 visible CUDA devices"
    with pytest.raises(ValueError, match=match):
        make_tp_devices(2)
    with pytest.raises(ValueError, match=match):
        TPServePrograms(model, tp=2)
    with pytest.raises(ValueError, match=match):
        ServeEngine(model, model.init(0), tp=2, n_pages=8)
    with pytest.raises(ValueError, match=match):
        ServeOptions(tp=2, n_pages=8).build(model, model.init(0))
    with pytest.raises(ValueError, match=match):
        launch.main(["--arch", "qwen3-0.6b", "--smoke", "--device", "cpu",
                     "--requests", "2", "--tp", "2"])
    with pytest.raises(ValueError, match="tp >= 2"):
        TPServePrograms(model, tp=1)
    with pytest.raises(ValueError, match="tp=3 with 2 devices"):
        TPServePrograms(model, tp=3, devices=["cpu", "cpu"])


def test_launcher_serves_with_named_shards():
    """The launcher's ``serve_trace`` and ``run_stream`` over a bundle
    whose shards are named: the tp 1 streams, and the devices the
    launcher waits for are the shards' (not every visible card)."""
    cfg = configs.get_smoke("qwen3-0.6b")
    model = build_model(dataclasses.replace(cfg, compute_dtype="float32"),
                        device="cpu")
    params = model.init(seed=0)
    def trace():
        return launch.synth_requests(model.cfg, 4, 12, 4, 1000.0)
    opts = ServeOptions(batch=2).sized_for(trace())
    one = launch.serve_trace(opts.build(model, params), trace(),
                             realtime=False)
    progs = TPServePrograms(model, devices=["cpu"] * 2)
    backend = opts.build(model, params, programs=progs)
    assert launch.backend_devices(backend) == [torch.device("cpu")]
    assert progs.devices == [torch.device("cpu")] * 2
    stats = launch.serve_trace(backend, trace(), realtime=False)
    assert stats["requests"] == 4
    assert stats["tokens"] == one["tokens"] == 16
    streams = launch.run_stream(opts, model, params, trace(),
                                programs=progs)["streams"]
    assert len(streams) == 4
    assert all(s.finished for s in streams.values())


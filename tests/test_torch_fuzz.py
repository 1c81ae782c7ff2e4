"""The serve-conformance chaos fuzzer of tests/test_serve_fuzz.py on the
port's serving stack (``repro_torch.serve``, on the CPU): seeded random
mixed traces — ragged arrivals, cancels, page-pressure preemptions,
speculation on/off, knobs drawn per case — with allocator invariants
checked after EVERY step and every finished stream asserted bitwise
against the port's own ``greedy_generate`` (cancelled streams must be an
oracle prefix).

``drive_and_check`` is the port's copy of the reference harness; the
router, elastic and fault tests import it.  Arms: fused and unfused
engines, a fleet with a seeded fault and a kill switch, a fleet grown
and drained mid-trace, and engines drafting with a second model
(``DraftModelDrafter``), and the reference's tp=2 arm, its two shards
named on the CPU.  The drafter is also held against the reference's on
the same draft weights.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro import configs as jconfigs
from repro.models import build_model
from repro.serve import DraftModelDrafter as JDraftModelDrafter
from repro.serve import Request as JRequest
from repro_torch import configs
from repro_torch.checkpoint import params_from_jax
from repro_torch.models.lm import DecoderLM
from repro_torch.serve import (DraftModelDrafter, FaultInjector, Request,
                               RequestRouter, ServeEngine, ServePrograms,
                               greedy_generate)

ARCH = "qwen3-0.6b"
N_CASES = 6
POOLS = [22, 30]      # pages; the small pool forces preemption/replay
CHUNKS = [8, 16]
PREFILL_BATCHES = [1, 3]
SPEC_KS = [0, 3]
PROMPT_LENS = [5, 9, 12, 16, 21, 27]


def jax_params(seed: int = 0):
    """The reference smoke model's params from ``PRNGKey(seed)``, as
    numpy (the weights both packages serve in the cross-checks)."""
    cfg = jconfigs.get_smoke(ARCH)
    return jax.tree.map(np.asarray,
                        build_model(cfg).init(jax.random.PRNGKey(seed)))


def port_bundle(seed: int = 0, dtype: str = "bfloat16"):
    """(cfg, model, params, programs) of the port on the CPU, on the
    reference's weights from ``PRNGKey(seed)``."""
    cfg = dataclasses.replace(configs.get_smoke(ARCH), compute_dtype=dtype)
    model = DecoderLM(cfg, device="cpu")
    params = params_from_jax(jax_params(seed), cfg, device="cpu")
    return cfg, model, params, ServePrograms(model)


def make_oracle(model, params):
    """rid-free memoized ``greedy_generate``: (prompt, gen) -> stream."""
    memo = {}

    def run(prompt: np.ndarray, gen: int) -> np.ndarray:
        key = (np.asarray(prompt).tobytes(), gen)
        if key not in memo:
            memo[key] = greedy_generate(
                model, params, np.asarray(prompt)[None], gen,
                cache_len=len(prompt) + gen)[0].numpy()
        return memo[key]
    return run


@pytest.fixture(scope="module")
def bundle():
    # ONE program bundle for every fuzz engine: the cases vary knobs,
    # not the model
    return port_bundle()


@pytest.fixture(scope="module")
def oracle(bundle):
    return make_oracle(bundle[1], bundle[2])


# ---------------------------------------------------------- the harness
def drive_and_check(engine, trace, *, oracle=None, cancels=None,
                    events=None, max_steps=2000, telemetry=None):
    """Drive ``engine`` through ``trace`` step by step and enforce the
    serve-conformance bar.  Returns {rid: np.ndarray(generated)}.

    ``telemetry``: the stack's ``Telemetry`` (tracing on) — adds the
    trace-exactness sweep to the bar: every request's span is
    well-formed (``telemetry.check_spans``), span token/replay counts
    reconcile with the request state and ``stats()`` counters, and the
    metrics-registry dispatch-identity audit is clean.

    * ``engine`` is any ``ServeBackend`` — a single engine, a router,
      or an elastic controller (anything with a ``replicas`` list gets
      every live replica's allocator checked);
    * ``trace``: Requests with integer ``arrival`` times; all are
      submitted upfront and admission follows the synthetic clock
      (``step(now=t)`` with t = 0, 1, 2, ...), so arrival raggedness
      is deterministic — no wall clock anywhere.
    * allocator invariants (``cache.check_invariants``: refcounts,
      free list, null page) are asserted after EVERY step;
    * ``cancels``: {step t: [rid, ...]} applied before that step;
    * ``events``: {step t: [fn, ...]} — arbitrary chaos callbacks
      (e.g. elastic scale-up/drain) applied to the backend before that
      step, before the step's cancels;
    * ``oracle``: (prompt, gen) -> expected stream.  Finished requests
      must match bitwise; cancelled requests must be a prefix (tokens
      already streamed were confirmed and can never change).
    """
    cancels = cancels or {}
    events = events or {}
    for r in trace:
        engine.submit(r)
    cancelled = set()
    t = 0
    while True:
        for fn in events.get(t, ()):
            fn(engine)
        for rid in cancels.get(t, ()):
            if engine.cancel(rid):
                cancelled.add(rid)
        more = engine.step(now=float(t))
        for cache in ([e.cache for e in engine.replicas]
                      if hasattr(engine, "replicas")
                      else [engine.cache]):
            cache.check_invariants()
        t += 1
        assert t < max_steps, "engine failed to drain the trace"
        if not more and t > max((r.arrival for r in trace), default=0):
            break
    done = {r.rid: np.asarray(r.generated, np.int32)
            for r in engine.finished}
    if telemetry is not None:
        from repro_torch.serve.telemetry import check_spans
        check_spans(trace, cancelled=cancelled, backend=engine)
    if oracle is not None:
        for r in trace:
            want = oracle(r.prompt, r.max_new_tokens)
            if r.rid in done:
                np.testing.assert_array_equal(
                    done[r.rid], want[:len(done[r.rid])],
                    err_msg=f"rid {r.rid} diverged from oracle")
                assert len(done[r.rid]) == r.max_new_tokens
            elif r.rid in cancelled:
                got = np.asarray(r.generated, np.int32)
                np.testing.assert_array_equal(
                    got, want[:len(got)],
                    err_msg=f"cancelled rid {r.rid} not oracle prefix")
            else:
                raise AssertionError(f"rid {r.rid} neither finished "
                                     "nor cancelled")
    return done


def check_dispatch_identity(st) -> None:
    assert st["n_total_dispatches"] == (
        st["n_prefill_dispatches"] + st["n_decode_steps"]
        + st["n_replay_steps"] - st["n_fused_dispatches"]), st


def _case(seed: int, cfg):
    """One seeded chaos case (the reference's draws): trace + engine
    knobs + cancel schedule."""
    rng = np.random.default_rng(1000 + seed)
    n = int(rng.integers(3, 7))
    reqs = []
    for i in range(n):
        L = int(rng.choice(PROMPT_LENS))
        prompt = rng.integers(0, cfg.vocab_size,
                              size=(L,)).astype(np.int32)
        reqs.append(Request(rid=i, prompt=prompt,
                            max_new_tokens=int(rng.integers(2, 9)),
                            arrival=float(rng.integers(0, 6))))
    knobs = dict(max_batch=4, page_size=8, max_pages_per_seq=8,
                 n_pages=int(rng.choice(POOLS)),
                 chunk_size=int(rng.choice(CHUNKS)),
                 prefill_batch=int(rng.choice(PREFILL_BATCHES)),
                 spec_k=int(rng.choice(SPEC_KS)),
                 prefix_sharing=bool(rng.integers(0, 2)))
    cancels = {}
    if rng.random() < 0.4:
        cancels[int(rng.integers(1, 12))] = \
            [int(rng.integers(0, n))]
    return reqs, knobs, cancels


def _fresh(reqs):
    # reset BOTH engine-filled lists: dataclasses.replace copies field
    # references, so reusing a trace list would alias spans across arms
    return [dataclasses.replace(r, generated=[], trace=[])
            for r in reqs]


@pytest.mark.parametrize("seed", range(N_CASES))
def test_fuzz_fused_and_unfused_match_oracle(bundle, oracle, seed):
    cfg, model, params, programs = bundle
    reqs, knobs, cancels = _case(seed, cfg)
    streams = {}
    for fused in (True, False):
        eng = ServeEngine(model, params, fused=fused,
                          programs=programs, **knobs)
        streams[fused] = drive_and_check(eng, _fresh(reqs),
                                         oracle=oracle,
                                         cancels=cancels)
    # requests that finished in both arms streamed identical tokens (a
    # cancel can land on a request still inflight in one arm and
    # finished in the other, hence the intersection)
    for rid in streams[True].keys() & streams[False].keys():
        np.testing.assert_array_equal(streams[True][rid],
                                      streams[False][rid])


@pytest.mark.parametrize("seed", range(3))
def test_fuzz_tp2_matches_oracle(bundle, oracle, seed):
    """The reference's tp=2 arm: the same chaos cases on one engine
    whose programs are sharded over two shards named ``cpu``
    (``serve/parallel.py``), held to the same bar."""
    from repro_torch.serve.parallel import TPServePrograms
    cfg, model, params, _ = bundle
    tp_programs = TPServePrograms(model, devices=["cpu", "cpu"])
    reqs, knobs, cancels = _case(seed, cfg)
    eng = ServeEngine(model, params, fused=True, programs=tp_programs,
                      **knobs)
    drive_and_check(eng, _fresh(reqs), oracle=oracle, cancels=cancels)


@pytest.mark.parametrize("seed", range(N_CASES))
def test_fuzz_fault_recovery_matches_oracle(bundle, oracle, seed):
    """The fault arm: one replica of a 3-replica fleet carries a seeded
    scripted fault (``FaultInjector.seeded``: crash or stall) and a
    seeded kill switch hard-fails a live replica mid-trace, so every
    case sees >= 1 failure.  Lost requests are rebuilt from the journal
    and replayed on survivors under the full bar: invariants every
    step, bitwise oracle parity, exact cancels, span exactness, and the
    fleet dispatch identity after the crash-folds."""
    from repro_torch.serve.telemetry import Telemetry
    cfg, model, params, programs = bundle
    reqs, knobs, cancels = _case(seed, cfg)
    tel = Telemetry(trace=True)

    def mk():
        return ServeEngine(model, params, fused=True,
                           programs=programs, telemetry=tel, **knobs)

    faulty = FaultInjector.seeded(mk(), seed, horizon=10)
    router = RequestRouter([faulty, mk(), mk()], policy="prefix",
                           stall_patience=3, telemetry=tel)
    rng = np.random.default_rng(3000 + seed)

    def kill(r, _rng=rng):
        live = [i for i in range(len(r.replicas))
                if not r.is_draining(i)]
        if len(live) > 1:
            r.fail(live[int(_rng.integers(0, len(live)))])
    events = {int(rng.integers(1, 4)): [kill]}
    drive_and_check(router, _fresh(reqs), oracle=oracle,
                    cancels=cancels, events=events, telemetry=tel)
    assert router.n_failures >= 1
    assert len(router._journal) == 0      # every stream reached an end
    st = router.stats()
    check_dispatch_identity(st)
    assert st["n_replay_steps"] >= router.n_recovery_replayed_tokens


@pytest.mark.parametrize("seed", range(N_CASES))
def test_fuzz_elastic_churn_matches_oracle(bundle, oracle, seed):
    """The elastic-churn arm: a router whose fleet is grown and drained
    mid-trace by seeded events; drains migrate live requests, and the
    bar is the full conformance bar."""
    cfg, model, params, programs = bundle
    reqs, knobs, cancels = _case(seed, cfg)

    def mk():
        return ServeEngine(model, params, fused=True,
                           programs=programs, **knobs)

    router = RequestRouter([mk(), mk()], policy="prefix")
    rng = np.random.default_rng(2000 + seed)
    events = {}
    for t in rng.choice(np.arange(1, 14),
                        size=int(rng.integers(2, 5)), replace=False):
        def churn(r, _rng=rng):
            live = [i for i in range(len(r.replicas))
                    if not r.is_draining(i)]
            grow = len(r.replicas) < 4 and (len(live) < 2
                                            or _rng.random() < 0.5)
            if grow:
                r.add_replica(mk())
            elif len(live) > 1:
                r.drain(int(_rng.choice(live)))
        events.setdefault(int(t), []).append(churn)
    drive_and_check(router, _fresh(reqs), oracle=oracle,
                    cancels=cancels, events=events)
    assert router.n_joined >= 2
    check_dispatch_identity(router.stats())


# ---------------------------------------------------- draft-model arm
@pytest.fixture(scope="module")
def draft(bundle):
    """A second smoke model of another seed: the draft model."""
    cfg, _, _, _ = bundle
    dmodel = DecoderLM(cfg, device="cpu")
    return dmodel, params_from_jax(jax_params(1), cfg, device="cpu")


@pytest.mark.parametrize("seed", range(3))
def test_fuzz_draft_model_drafter_matches_oracle(bundle, oracle, draft,
                                                 seed):
    """Engines drafting with a second model stream the oracle's tokens
    (drafts are advisory), under the chaos traces' preemption and
    cancels, and leave no drafter slot state behind."""
    cfg, model, params, programs = bundle
    reqs, knobs, cancels = _case(seed, cfg)
    drafter = DraftModelDrafter(*draft, cfg_target=cfg)
    eng = ServeEngine(model, params, programs=programs, drafter=drafter,
                      **{**knobs, "spec_k": 3})
    drive_and_check(eng, _fresh(reqs), oracle=oracle, cancels=cancels)
    assert eng.n_drafted > 0
    assert drafter._slots == {}


def test_draft_model_drafter_rejects_vocab_mismatch(bundle, draft):
    cfg = bundle[0]
    with pytest.raises(ValueError, match="vocab"):
        DraftModelDrafter(*draft, cfg_target=dataclasses.replace(
            cfg, vocab_size=cfg.vocab_size + 1))


def test_draft_model_drafter_matches_reference():
    """At f32, on the same draft weights, the port's drafter proposes
    the reference's drafts on one request, round after round, through
    a rollback (the confirmed stream diverges from the drafts)."""
    jcfg = dataclasses.replace(jconfigs.get_smoke(ARCH),
                               compute_dtype="float32")
    jmodel = build_model(jcfg)
    jparams = jax.tree.map(jnp.asarray, jax_params(1))
    cfg = dataclasses.replace(configs.get_smoke(ARCH),
                              compute_dtype="float32")
    model = DecoderLM(cfg, device="cpu")
    params = params_from_jax(jax_params(1), cfg, device="cpu")
    jd = JDraftModelDrafter(jmodel, jparams)
    pd = DraftModelDrafter(model, params)
    rng = np.random.default_rng(5)
    prompt = rng.integers(0, cfg.vocab_size, size=(13,)).astype(np.int32)
    jreq = JRequest(rid=0, prompt=prompt, max_new_tokens=12)
    preq = Request(rid=0, prompt=prompt, max_new_tokens=12)
    for rnd in range(4):
        want = jd.propose(0, jreq, 4)
        got = pd.propose(0, preq, 4)
        assert got == want, (rnd, got, want)
        # confirm one draft token and one other token, so the next
        # round rewinds past rejected drafts
        for r in (jreq, preq):
            r.generated.extend([want[0], (want[1] + 1) % cfg.vocab_size])
    pd.detach(0)
    assert pd._slots == {}

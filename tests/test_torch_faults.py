"""Fault tolerance in the port (tests/test_serve_faults.py on
``repro_torch.serve``, on the CPU): seeded fault injection, the recovery
journal, the router's FAILED path (crash + stall watchdog), elastic
crash repair, and front-end load shedding under degraded capacity.

Unit tests run the injector/journal against a model-free dummy; the
integration tests drive the port's engines and hold recovered streams
to the port's ``greedy_generate`` bitwise, every stream delivered
exactly once, and the fleet dispatch identity intact after the
crash-fold.  One churn-plus-crash trace is also run through the JAX
reference's router on the same weights: every routing, migration,
failure and dispatch counter must be equal.
"""
import jax
import numpy as np
import pytest

from repro import configs as jconfigs
from repro.models import build_model
from repro.serve import FaultInjector as JFaultInjector
from repro.serve import Request as JRequest
from repro.serve import RequestRouter as JRequestRouter
from repro.serve import ServeEngine as JServeEngine
from repro.serve import ServePrograms as JServePrograms
from repro_torch.serve import (
    ElasticController, ElasticPolicy, FaultInjector, ReplicaFailure,
    Request, RequestJournal, RequestRouter, ServeEngine, ServeFrontend,
    ShedRejection, StreamEvent, parse_fault_spec,
)
from test_torch_fuzz import (ARCH, check_dispatch_identity,
                             drive_and_check, make_oracle, port_bundle)

GEN = 6
ENGINE_KW = dict(max_batch=2, n_pages=32, page_size=8, max_pages_per_seq=8,
                 chunk_size=16)


# ================================================== unit: FaultInjector
class _Dummy:
    """Minimal ServeBackend stand-in: each step retires one request."""

    capacity = 4

    def __init__(self, n=3):
        self.uid = "d0"
        self.n_stepped = 0
        self._inflight = n
        self.finished = []

    @property
    def n_inflight(self):
        return self._inflight

    def check_admissible(self, req):
        pass

    def submit(self, req):
        self._inflight += 1

    def step(self, now=float("inf")):
        self.n_stepped += 1
        if self._inflight:
            self._inflight -= 1
        return bool(self._inflight)

    def drain_events(self):
        return []

    def extract(self, rid):
        return None

    def extract_all(self):
        return []

    def cancel(self, rid):
        return False

    def stats(self):
        return {"n_steps": float(self.n_stepped)}


def test_injector_crash_is_permanent():
    d = _Dummy(5)
    inj = FaultInjector(d, crash_at=3)
    assert inj.step() and inj.step()          # steps 1-2 pass through
    assert d.n_stepped == 2
    with pytest.raises(ReplicaFailure) as ei:
        inj.step()
    assert ei.value.kind == "crash" and inj.dead
    assert d.n_stepped == 2                   # crash fired BEFORE work
    for call in (inj.step, lambda: inj.submit(None), inj.drain_events,
                 lambda: inj.extract(0), inj.extract_all,
                 lambda: inj.cancel(0),
                 lambda: inj.check_admissible(None)):
        with pytest.raises(ReplicaFailure):
            call()
    # ... except externally-scraped surfaces the crash-fold needs
    assert inj.stats() == {"n_steps": 2.0}
    assert inj.n_inflight == 3 and inj.capacity == 4
    inj.mark_dead("stall")                    # idempotent, keeps kind
    assert inj.fault_kind == "crash"


def test_injector_stall_window_heals():
    d = _Dummy(2)
    inj = FaultInjector(d, stall_at=2, stall_for=2)
    assert inj.step() is True                 # step 1 delegates
    assert inj.step() is True and inj.stalled  # steps 2-3: wedged but
    assert inj.step() is True and inj.stalled  # busy (work is held)
    assert d.n_stepped == 1                   # no progress in-window
    assert inj.step() is False                # step 4: healed, drains
    assert d.n_stepped == 2 and not inj.stalled and not inj.dead


def test_injector_seeded_schedules_replay_the_reference():
    """Same seed -> same schedule, and the reference's schedule: both
    packages draw it from ``random.Random(seed)``."""
    for seed in range(20):
        a = FaultInjector.seeded(_Dummy(), seed)
        b = FaultInjector.seeded(_Dummy(), seed)
        ref = JFaultInjector.seeded(_Dummy(), seed)
        assert (a.crash_at, a.stall_at, a.stall_for) \
            == (b.crash_at, b.stall_at, b.stall_for) \
            == (ref.crash_at, ref.stall_at, ref.stall_for)
    kinds = {("crash" if FaultInjector.seeded(_Dummy(), s).crash_at
              is not None else "stall") for s in range(20)}
    assert kinds == {"crash", "stall"}        # both arms get exercised


def test_injector_validation():
    with pytest.raises(ValueError):
        FaultInjector(_Dummy(), stall_at=1, stall_for=-1)
    with pytest.raises(ValueError):
        FaultInjector(_Dummy(), stall_for=3)  # stall_for sans stall_at


def test_injector_proxies_the_port_engine(bundle):
    """Attribute reads the router needs reach the wrapped port engine."""
    eng = _mk(bundle)
    inj = FaultInjector(eng)
    assert inj.cache is eng.cache and inj.model is eng.model
    assert inj.uid == eng.uid and inj.max_batch == eng.max_batch


def test_parse_fault_spec():
    assert parse_fault_spec("0:crash@12, 1:stall@8x5") == [
        (0, {"crash_at": 12}), (1, {"stall_at": 8, "stall_for": 5})]
    assert parse_fault_spec("2:stall@6") == \
        [(2, {"stall_at": 6, "stall_for": 4})]
    assert parse_fault_spec("") == []
    for bad in ("0:boom@3", "crash@3", "0:crash", "0@crash:3"):
        with pytest.raises(ValueError):
            parse_fault_spec(bad)


# ================================================ unit: RequestJournal
def _req(rid, arrival=0.0, plen=4):
    return Request(rid=rid, prompt=np.arange(plen, dtype=np.int32),
                   max_new_tokens=8, arrival=arrival)


def test_journal_tracks_confirmed_frontier_and_reconstructs():
    j = RequestJournal()
    r1, r2, r4 = _req(1, arrival=1.0), _req(2, arrival=0.5), \
        _req(4, arrival=0.2)
    for r in (r1, r2, r4):
        j.assign(r, 0)
    j.observe([StreamEvent(rid=1, tokens=(5, 6), finished=False),
               StreamEvent(rid=2, tokens=(9,), finished=True),
               StreamEvent(rid=3, tokens=(7,), finished=False)])
    assert j.entry(1).confirmed == 2
    assert 2 not in j                 # finished streams need no recovery
    assert 3 not in j                 # unknown rids are ignored
    r1.generated.extend([5, 6, 7])    # 7 generated but never drained
    lost = j.lost(0)
    assert [e.req.rid for e in lost] == [4, 1]     # oldest-first
    assert len(j) == 0
    req, burden = RequestJournal.reconstruct(lost[1])
    assert req is r1                  # the SAME object, rebuilt in place
    assert r1.generated == [5, 6] and r1.prefill_pos == 0
    assert burden == 1                # replay all but the last confirmed
    req, burden = RequestJournal.reconstruct(lost[0])
    assert burden == 0 and req.generated == []


def test_journal_reassignment_keeps_frontier():
    j = RequestJournal()
    r = _req(7)
    r.generated.extend([1, 2])        # migration-style: arrives mid-stream
    j.assign(r, 0)
    assert j.entry(7).confirmed == 2
    j.unassign(7)                     # re-queued: no location, kept entry
    assert j.lost(0) == [] and 7 in j
    j.assign(r, 1)                    # re-dispatch: frontier persists
    assert j.entry(7).replica == 1 and j.entry(7).confirmed == 2
    j.discard(7)
    j.discard(7)                      # idempotent
    assert 7 not in j


# ======================================================== integration
@pytest.fixture(scope="module")
def bundle():
    return port_bundle()


@pytest.fixture(scope="module")
def oracle(bundle):
    run = make_oracle(bundle[1], bundle[2])
    return lambda r: [int(t) for t in run(r.prompt, r.max_new_tokens)]


def _mk(bundle, **kw):
    _, model, params, programs = bundle
    return ServeEngine(model, params, programs=programs,
                       **{**ENGINE_KW, **kw})


def _reqs(cfg, n=6, plen=20, seed=0, cls=Request):
    rng = np.random.default_rng(seed)
    return [cls(rid=i, prompt=rng.integers(0, cfg.vocab_size, plen,
                                           dtype=np.int32),
                max_new_tokens=GEN) for i in range(n)]


def _check_parity(done, oracle):
    for r in done:
        assert r.generated == oracle(r), f"rid {r.rid} diverged"


def _check_streams(events, done):
    """Zero dropped, zero duplicated: concatenating the drained events
    per rid reproduces each finished request's stream exactly, with
    exactly one terminal event."""
    toks, fins = {}, {}
    for ev in events:
        toks.setdefault(ev.rid, []).extend(ev.tokens)
        fins[ev.rid] = fins.get(ev.rid, 0) + bool(ev.finished)
    for r in done:
        assert toks.get(r.rid, []) == list(r.generated), r.rid
        assert fins.get(r.rid, 0) == 1, (r.rid, fins.get(r.rid))


def test_crash_recovery_token_parity(bundle, oracle):
    """A replica that crashes mid-decode loses nothing: its requests
    are rebuilt from the journal, replayed on the survivor, and every
    stream matches the oracle bitwise — with the fleet dispatch
    identity intact after the crash-fold."""
    reqs = _reqs(bundle[0])
    inj = FaultInjector(_mk(bundle), crash_at=6)
    router = RequestRouter([inj, _mk(bundle)], policy="round-robin",
                           stall_patience=3)
    done = router.run(reqs)
    assert sorted(r.rid for r in done) == list(range(len(reqs)))
    _check_parity(done, oracle)
    assert router.n_failures == 1
    assert router.n_recovered_requests >= 1
    assert router.n_recovery_replayed_tokens >= 1
    assert router.failed_rids and len(router.replicas) == 1
    assert router.n_departed == 1
    st = router.stats()
    check_dispatch_identity(st)
    assert st["n_replay_steps"] >= router.n_recovery_replayed_tokens
    assert len(router._journal) == 0          # nothing left unprotected
    _check_streams(router.drain_events(), done)


def test_stall_watchdog_fails_wedged_replica(bundle, oracle):
    reqs = _reqs(bundle[0], seed=1)
    inj = FaultInjector(_mk(bundle), stall_at=2, stall_for=50)
    router = RequestRouter([inj, _mk(bundle)], policy="round-robin",
                           stall_patience=3)
    done = router.run(reqs)
    assert sorted(r.rid for r in done) == list(range(len(reqs)))
    _check_parity(done, oracle)
    assert router.n_failures == 1 and len(router.replicas) == 1
    assert inj.dead                  # watchdog made the verdict final
    check_dispatch_identity(router.stats())
    _check_streams(router.drain_events(), done)


def test_stall_shorter_than_patience_heals(bundle, oracle):
    reqs = _reqs(bundle[0], seed=2)
    inj = FaultInjector(_mk(bundle), stall_at=2, stall_for=2)
    router = RequestRouter([inj, _mk(bundle)], policy="round-robin",
                           stall_patience=6)
    done = router.run(reqs)
    assert sorted(r.rid for r in done) == list(range(len(reqs)))
    _check_parity(done, oracle)
    assert router.n_failures == 0 and router.n_recovered_requests == 0
    assert len(router.replicas) == 2 and not inj.dead
    _check_streams(router.drain_events(), done)


def test_extract_cancel_graceful_on_dead_replica(bundle, oracle):
    """extract/cancel of a rid living on a dead replica — before the
    router has noticed the death — return None/False instead of
    raising, and stay idempotent through the recovery that follows."""
    reqs = _reqs(bundle[0], seed=3)
    inj = FaultInjector(_mk(bundle))
    router = RequestRouter([inj, _mk(bundle)], policy="round-robin",
                           stall_patience=3)
    assert router.extract(999) is None        # unknown rid: graceful
    assert router.cancel(999) is False
    for r in reqs:
        router.submit(r)
    router.step()                             # rids 0,2,4 land on inj
    held = sorted({r.rid for r in (list(inj.waiting)
                                   + list(inj.prefilling.values())
                                   + list(inj.active.values()))})
    assert held == [0, 2, 4]
    inj.mark_dead()                           # dies behind router's back
    assert router.extract(0) is None
    assert router.cancel(0) is False
    router.step()                             # detection + recovery
    assert router.n_failures == 1
    assert set(held) <= router.failed_rids
    got = router.extract(0)                   # recovered: now reachable
    assert got is not None and got.rid == 0
    assert got.generated == oracle(got)[:len(got.generated)]
    assert router.cancel(0) is False          # already extracted
    assert router.cancel(2) is True
    assert router.cancel(2) is False          # idempotent double-cancel
    while router.step():
        pass
    assert sorted(r.rid for r in router.finished) == [1, 3, 4, 5]
    _check_parity(router.finished, oracle)
    assert len(router._journal) == 0


def test_elastic_repair_restores_capacity(bundle, oracle):
    """The controller replaces a crash-lost replica via the factory:
    the fleet returns to min_replicas, degradation clears, and a
    front-end accepts batch work again afterwards."""
    reqs = _reqs(bundle[0], seed=4)
    inj = FaultInjector(_mk(bundle), crash_at=4)
    router = RequestRouter([inj, _mk(bundle)], policy="round-robin",
                           stall_patience=3)
    ctrl = ElasticController(router, lambda: _mk(bundle),
                             policy=ElasticPolicy(
                                 min_replicas=2, max_replicas=2,
                                 scale_interval=64, repair_backoff=1))
    done = ctrl.run(reqs)
    assert sorted(r.rid for r in done) == list(range(len(reqs)))
    _check_parity(done, oracle)
    assert router.n_failures == 1
    assert ctrl.n_repairs == 1 and ctrl.n_repair_failures == 0
    assert not ctrl.degraded and len(router.replicas) == 2
    check_dispatch_identity(ctrl.stats())
    fe = ServeFrontend(ctrl)
    extra = Request(rid=100, prompt=reqs[0].prompt,
                    max_new_tokens=GEN, slo_class="batch")
    s = fe.submit_request(extra)
    fe.drain()
    assert s.finished and list(s) == oracle(reqs[0])


def test_repair_backoff_and_bounded_budget(bundle, oracle):
    reqs = _reqs(bundle[0], seed=5)
    calls = []

    def bad_factory():
        calls.append(1)
        raise RuntimeError("no capacity for a replacement")

    inj = FaultInjector(_mk(bundle), crash_at=3)
    router = RequestRouter([inj, _mk(bundle)], policy="round-robin",
                           stall_patience=3)
    ctrl = ElasticController(router, bad_factory, policy=ElasticPolicy(
        min_replicas=2, max_replicas=2, scale_interval=1000,
        repair_backoff=1, repair_budget=2))
    done = ctrl.run(reqs)
    assert sorted(r.rid for r in done) == list(range(len(reqs)))
    _check_parity(done, oracle)
    assert router.n_failures == 1
    assert ctrl.n_repairs == 0
    assert ctrl.n_repair_failures == 2 == len(calls)  # budget-bounded
    assert ctrl.degraded and len(router.replicas) == 1


def test_frontend_sheds_batch_while_degraded(bundle, oracle):
    reqs = _reqs(bundle[0], n=7, seed=6)

    def bad_factory():
        raise RuntimeError("no capacity")

    inj = FaultInjector(_mk(bundle), crash_at=2)
    router = RequestRouter([inj, _mk(bundle)], policy="round-robin",
                           stall_patience=3)
    ctrl = ElasticController(router, bad_factory, policy=ElasticPolicy(
        min_replicas=2, max_replicas=2, scale_interval=1000,
        repair_budget=0))
    fe = ServeFrontend(ctrl)
    live = [fe.submit(reqs[i].prompt, GEN, rid=i,
                      slo_class="interactive") for i in range(4)]
    live.append(fe.submit(reqs[4].prompt, GEN, rid=4,
                          slo_class="batch"))   # pre-crash: accepted
    while not ctrl.degraded and fe.busy:
        fe.pump()
    assert ctrl.degraded
    with pytest.raises(ShedRejection) as ei:
        fe.submit(reqs[5].prompt, GEN, rid=5, slo_class="batch")
    assert ei.value.rid == 5 and ei.value.slo_class == "batch"
    live.append(fe.submit(reqs[6].prompt, GEN, rid=6,
                          slo_class="interactive"))  # still flows
    fe.drain()
    assert fe.n_shed == 1 and fe.stats()["n_shed"] == 1.0
    assert all(s.finished for s in live)
    for s in live:
        assert list(s) == oracle(reqs[s.rid]), f"rid {s.rid} diverged"


# =========================================== against the JAX reference
FLEET_COUNTERS = ("n_affinity_hits", "n_migrations", "n_migrated_tokens",
                  "n_failures", "n_recovered_requests",
                  "n_recovery_replayed_tokens", "n_joined", "n_departed",
                  "n_routed", "n_prefill_dispatches", "n_prefill_chunks",
                  "n_decode_steps", "n_replay_steps", "n_fused_dispatches",
                  "n_total_dispatches")


def fleet_counters(router) -> dict:
    st = router.stats()
    return {"n_dispatched": list(router.n_dispatched),
            **{k: int(st[k]) for k in FLEET_COUNTERS}}


def _churn_and_crash(mk, router_cls, injector_cls, reqs):
    """A 2-replica fleet whose replica 1 crashes at its own step 7, a
    third replica joining at t=2 and replica 0 drained at t=4, on the
    synthetic clock; spec_k=0 and no EOS, so no token value steers a
    decision."""
    router = router_cls([mk(), injector_cls(mk(), crash_at=7)],
                        policy="prefix", stall_patience=3)
    drive_and_check(router, reqs, events={
        2: [lambda r: r.add_replica(mk())], 4: [lambda r: r.drain(0)]})
    return router


def _trace(cfg, cls, seed=8):
    rng = np.random.default_rng(seed)
    prefixes = [rng.integers(0, cfg.vocab_size, 16, dtype=np.int32)
                for _ in range(2)]
    return [cls(rid=i, prompt=np.concatenate(
        [prefixes[i % 2], rng.integers(0, cfg.vocab_size, 5,
                                       dtype=np.int32)]),
        max_new_tokens=7, arrival=float(i // 3)) for i in range(8)]


def test_churn_and_crash_counters_equal_reference(bundle):
    """The port's router and the reference's take the same decisions
    on one churn-plus-crash trace: dispatches per replica, affinity
    hits, migrations, failures, recoveries and every engine dispatch
    counter are equal."""
    cfg, model, params, programs = bundle
    jcfg = jconfigs.get_smoke(ARCH)
    jmodel = build_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    jprograms = JServePrograms(jmodel)
    kw = dict(ENGINE_KW, spec_k=0)
    want = _churn_and_crash(
        lambda: JServeEngine(jmodel, jparams, programs=jprograms, **kw),
        JRequestRouter, JFaultInjector, _trace(jcfg, JRequest))
    got = _churn_and_crash(lambda: _mk(bundle, spec_k=0), RequestRouter,
                           FaultInjector, _trace(cfg, Request))
    assert fleet_counters(got) == fleet_counters(want)
    c = fleet_counters(got)
    assert c["n_failures"] == 1 and c["n_migrations"] >= 1
    assert c["n_recovered_requests"] >= 1 and c["n_joined"] == 3
    check_dispatch_identity(got.stats())



def test_launcher_fleet_with_chaos_on_cpu(capsys):
    """``launch.serve --replicas 2 --chaos-faults`` on the CPU: replica 1
    crashes, its requests are recovered, every request finishes, and
    the counters come from the fleet's own ``stats()``."""
    from repro_torch.launch import serve as launch
    stats = launch.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                         "--requests", "6", "--batch", "2",
                         "--prompt-len", "12", "--gen", "5",
                         "--rate", "1000", "--replicas", "2",
                         "--router-policy", "round-robin",
                         "--chaos-faults", "1:crash@3"])
    assert stats["requests"] == 6 and stats["tokens"] == 30
    assert stats["n_failures"] == 1 and stats["n_recovered_requests"] >= 1
    check_dispatch_identity(stats)
    assert "1 failures" in capsys.readouterr().out
    # --tp 2 takes two CUDA devices; without them it raises, naming
    # the count
    with pytest.raises(ValueError, match="tp=2 exceeds 0 visible CUDA"):
        launch.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                     "--requests", "1", "--tp", "2"])

"""Elastic-fleet conformance of the port (tests/test_serve_elastic.py on
``repro_torch.serve``, on the CPU): live migration round-trips, graceful
drain semantics, departed-replica stats accounting, and the
demand-driven controller — every stream held bitwise to the port's
``greedy_generate``.  One controller trace also runs through the JAX
reference's ``ElasticController`` on the same weights: the scaling,
routing and dispatch counters must be equal."""
import dataclasses

import jax
import numpy as np
import pytest

from repro import configs as jconfigs
from repro.models import build_model
from repro.serve import ElasticController as JElasticController
from repro.serve import ElasticPolicy as JElasticPolicy
from repro.serve import Request as JRequest
from repro.serve import RequestRouter as JRequestRouter
from repro.serve import ServeEngine as JServeEngine
from repro.serve import ServePrograms as JServePrograms
from repro_torch.serve import (ElasticController, ElasticPolicy, Request,
                               RequestRouter, ServeBackend, ServeEngine)
from test_torch_faults import fleet_counters
from test_torch_fuzz import (ARCH, check_dispatch_identity,
                             drive_and_check, make_oracle, port_bundle)

KNOBS = dict(max_batch=4, page_size=8, n_pages=30, max_pages_per_seq=8,
             chunk_size=8, prefill_batch=2, spec_k=0)


@pytest.fixture(scope="module")
def bundle():
    return port_bundle()


@pytest.fixture(scope="module")
def oracle(bundle):
    return make_oracle(bundle[1], bundle[2])


def _mk(bundle, **over):
    _, model, params, programs = bundle
    return ServeEngine(model, params, programs=programs,
                       **{**KNOBS, **over})


def _trace(cfg, seed, n, gen=(3, 8), lens=(5, 21), arrival=0,
           cls=Request):
    rng = np.random.default_rng(seed)
    return [cls(rid=i,
                prompt=rng.integers(0, cfg.vocab_size,
                                    size=(int(rng.integers(*lens)),)
                                    ).astype(np.int32),
                max_new_tokens=int(rng.integers(*gen)),
                arrival=float(arrival))
            for i in range(n)]


# ------------------------------------------------- migration round-trip
@pytest.mark.parametrize("seed", range(4))
def test_migration_roundtrip_token_exact(bundle, oracle, seed):
    """Extract a random live population at random confirmed-token
    frontiers and re-admit it on a FRESH replica: every stream resumes
    token-exact, and the source pool leaks nothing but its trie's
    pages."""
    cfg = bundle[0]
    rng = np.random.default_rng(300 + seed)
    reqs = _trace(cfg, 400 + seed, int(rng.integers(2, 5)))
    src = _mk(bundle)
    free0 = src.cache.free_pages
    for r in reqs:
        src.submit(r)
    for _ in range(int(rng.integers(1, 7))):      # random frontier
        src.step()
    migrated = src.extract_all()
    assert src.n_inflight == 0
    assert sorted(r.rid for r in migrated) \
        == sorted(r.rid for r in reqs if not r.finished)
    src.cache.check_invariants()
    assert src.cache.free_pages == free0 - len(src.cache.prefix.pages())
    dst = _mk(bundle)
    done = drive_and_check(dst, sorted(migrated,
                                       key=lambda r: (r.arrival, r.rid)),
                           oracle=oracle)
    for r in reqs:
        assert r.finished and len(r.generated) == r.max_new_tokens
    assert set(done) == {r.rid for r in migrated}


def test_migration_reuses_resident_prefix(bundle, oracle):
    """A migrated request whose prompt prefix is already resident on
    the target rebuilds its prompt pages by trie donation."""
    cfg = bundle[0]
    rng = np.random.default_rng(7)
    prefix = rng.integers(0, cfg.vocab_size, size=(16,)).astype(np.int32)

    def with_suffix(rid, n):
        sfx = rng.integers(0, cfg.vocab_size, size=(n,)).astype(np.int32)
        return Request(rid=rid, prompt=np.concatenate([prefix, sfx]),
                       max_new_tokens=6)
    warm, mover = with_suffix(0, 5), with_suffix(1, 7)
    dst = _mk(bundle)
    drive_and_check(dst, [warm], oracle=oracle)
    src = _mk(bundle)
    src.submit(mover)
    for _ in range(4):
        src.step()
    assert mover.generated, "mover should be mid-decode before moving"
    [got] = src.extract_all()
    assert got is mover
    shared_before = dst.cache.n_shared_tokens
    drive_and_check(dst, [mover], oracle=oracle)
    assert mover.shared_tokens >= 8        # >= one full page of prefix
    assert dst.cache.n_shared_tokens > shared_before
    np.testing.assert_array_equal(
        np.asarray(mover.generated, np.int32),
        oracle(mover.prompt, mover.max_new_tokens))


def test_migration_no_leak_without_sharing(bundle):
    cfg = bundle[0]
    src = _mk(bundle, prefix_sharing=False)
    free0 = src.cache.free_pages
    for r in _trace(cfg, 11, 3):
        src.submit(r)
    for _ in range(3):
        src.step()
    src.extract_all()
    src.cache.check_invariants()
    assert src.cache.free_pages == free0


# -------------------------------------------------------- drain semantics
def test_draining_replica_accepts_no_new_admissions(bundle, oracle):
    cfg = bundle[0]
    router = RequestRouter([_mk(bundle), _mk(bundle)],
                           policy="least-loaded")
    survivor = router.replicas[1]
    router.drain(0)
    assert router.is_draining(0) and not router.is_draining(1)
    assert router.n_live == 1
    assert router.capacity == survivor.max_batch
    reqs = _trace(cfg, 21, 4)
    drive_and_check(router, reqs, oracle=oracle)
    assert router.replicas == [survivor]
    assert survivor.n_inflight == 0
    assert len(survivor.finished) == len(reqs)
    assert router.stats()["n_routed"] == len(reqs)


def test_drain_migrates_every_inflight_request(bundle, oracle):
    cfg = bundle[0]
    router = RequestRouter([_mk(bundle), _mk(bundle)],
                           policy="least-loaded")
    reqs = _trace(cfg, 22, 6, gen=(6, 10))
    for r in reqs:
        router.submit(r)
    for t in range(3):                       # both replicas now busy
        router.step(now=float(t))
    victim = router.replicas[0]
    inflight = victim.n_inflight
    assert inflight > 0
    router.drain(victim)
    router.step(now=3.0)                     # drain executes here
    assert victim not in router.replicas
    assert victim.n_inflight == 0            # finished or migrated
    assert router.n_migrations == inflight
    t = 4
    while router.step(now=float(t)):
        t += 1
    for r in reqs:
        assert len(r.generated) == r.max_new_tokens
        np.testing.assert_array_equal(
            np.asarray(r.generated, np.int32),
            oracle(r.prompt, r.max_new_tokens))
    assert {r.rid for r in router.finished} == {r.rid for r in reqs}


def test_drain_guards_and_idempotence(bundle):
    router = RequestRouter([_mk(bundle), _mk(bundle)])
    router.drain(0)
    router.drain(0)                          # re-drain: no-op
    assert router.is_draining(0)
    with pytest.raises(ValueError):
        router.drain(1)                      # never empty the fleet
    router.step()
    assert len(router.replicas) == 1 and router.n_departed == 1
    with pytest.raises(ValueError):
        router.drain(0)                      # still the last one


def test_cancel_during_drain_stays_idempotent(bundle, oracle):
    cfg = bundle[0]
    router = RequestRouter([_mk(bundle), _mk(bundle)],
                           policy="least-loaded")
    reqs = _trace(cfg, 23, 4, gen=(6, 10))
    for r in reqs:
        router.submit(r)
    for t in range(2):
        router.step(now=float(t))
    victim = router.replicas[0]
    held = [r.rid for r in list(victim.prefilling.values())
            + list(victim.active.values())]
    assert held
    router.drain(victim)
    assert router.cancel(held[0]) is True
    assert router.cancel(held[0]) is False
    t = 2
    while router.step(now=float(t)):
        t += 1
    assert router.cancel(held[0]) is False   # still gone post-drain
    done = {r.rid for r in router.finished}
    assert held[0] not in done
    assert done == {r.rid for r in reqs} - {held[0]}
    for r in reqs:                           # parity incl. the prefix
        want = oracle(r.prompt, r.max_new_tokens)
        got = np.asarray(r.generated, np.int32)
        np.testing.assert_array_equal(got, want[:len(got)])


# ------------------------------------------------------ stats accounting
def test_stats_survive_replica_departure(bundle):
    cfg = bundle[0]
    router = RequestRouter([_mk(bundle), _mk(bundle)],
                           policy="least-loaded")
    reqs = _trace(cfg, 24, 6)
    drive_and_check(router, reqs)
    before = router.stats()
    assert before["n_routed"] == len(reqs)
    router.drain(0)
    router.step()                            # departure happens here
    after = router.stats()
    assert after["n_replicas"] == 1 and after["n_departed"] == 1
    for k in ("n_total_dispatches", "n_prefill_dispatches",
              "n_decode_steps", "n_replay_steps", "n_fused_dispatches",
              "n_engine_steps", "n_routed", "n_shared_tokens"):
        assert after[k] == before[k], f"{k} changed on departure"
    check_dispatch_identity(after)
    assert {r.rid for r in router.finished} == {r.rid for r in reqs}


# ----------------------------------------------------------- controller
def _controller_trace(cfg, cls):
    short = _trace(cfg, 25, 8, gen=(3, 5), cls=cls)
    long_ = [dataclasses.replace(r, rid=100 + r.rid, max_new_tokens=24)
             for r in _trace(cfg, 26, 2, lens=(5, 12), cls=cls)]
    return short + long_


CONTROL = dict(min_replicas=1, max_replicas=3, scale_interval=2,
               scale_down_patience=1, alpha=0.8)


def test_controller_scales_with_demand(bundle, oracle):
    """Burst -> the fleet grows the same control round; trough (long
    tail requests only) -> patience expires and replicas drain, with
    every stream still oracle-exact."""
    reqs = _controller_trace(bundle[0], Request)
    router = RequestRouter([_mk(bundle)], policy="least-loaded")
    ctl = ElasticController(router, lambda: _mk(bundle),
                            policy=ElasticPolicy(**CONTROL))
    assert isinstance(ctl, ServeBackend)
    drive_and_check(ctl, reqs, oracle=oracle)
    st = ctl.stats()
    assert st["n_scale_ups"] >= 1, "burst never grew the fleet"
    assert st["n_replicas_peak"] >= 2
    assert st["n_scale_downs"] >= 1, "trough never shrank the fleet"
    assert st["n_routed"] == len(reqs) + st["n_migrations"]
    assert len(router.replicas) < st["n_replicas_peak"]


def test_controller_counters_equal_reference(bundle):
    """The same controller trace through the reference's
    ``ElasticController``: equal scale-ups and scale-downs, dispatches
    per replica, migrations and engine dispatch counters."""
    jcfg = jconfigs.get_smoke(ARCH)
    jmodel = build_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    jprograms = JServePrograms(jmodel)

    def jmk():
        return JServeEngine(jmodel, jparams, programs=jprograms, **KNOBS)

    def run(mk, router_cls, ctl_cls, policy_cls, reqs):
        ctl = ctl_cls(router_cls([mk()], policy="least-loaded"), mk,
                      policy=policy_cls(**CONTROL))
        drive_and_check(ctl, reqs)
        st = ctl.stats()
        return {"n_scale_ups": int(st["n_scale_ups"]),
                "n_scale_downs": int(st["n_scale_downs"]),
                "n_replicas_peak": int(st["n_replicas_peak"]),
                **fleet_counters(ctl.router)}

    want = run(jmk, JRequestRouter, JElasticController, JElasticPolicy,
               _controller_trace(jcfg, JRequest))
    got = run(lambda: _mk(bundle), RequestRouter, ElasticController,
              ElasticPolicy, _controller_trace(bundle[0], Request))
    assert got == want
    assert got["n_scale_ups"] >= 1 and got["n_scale_downs"] >= 1


def test_controller_capacity_reports_potential(bundle):
    router = RequestRouter([_mk(bundle)])
    ctl = ElasticController(router, lambda: _mk(bundle),
                            policy=ElasticPolicy(max_replicas=3))
    assert ctl.capacity == 3 * KNOBS["max_batch"]
    assert router.capacity == KNOBS["max_batch"]


def test_policy_validation():
    with pytest.raises(ValueError):
        ElasticPolicy(min_replicas=3, max_replicas=2)
    with pytest.raises(ValueError):
        ElasticPolicy(scale_interval=0)
    with pytest.raises(ValueError):
        ElasticPolicy(target_load=0)


def test_launcher_elastic_fleet_on_cpu():
    """``launch.serve --max-replicas 3`` on the CPU: a burst grows the
    fleet, and the counters of departed replicas stay in the stats."""
    from repro_torch.launch import serve as launch
    stats = launch.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                         "--requests", "12", "--batch", "2",
                         "--prompt-len", "12", "--gen", "5",
                         "--rate", "1000", "--max-replicas", "3",
                         "--scale-interval", "2"])
    assert stats["requests"] == 12 and stats["tokens"] == 60
    assert stats["n_scale_ups"] >= 1 and stats["n_replicas_peak"] >= 2
    check_dispatch_identity(stats)

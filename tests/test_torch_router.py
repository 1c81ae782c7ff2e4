"""The port's multi-replica request router (tests/test_serve_router.py on
``repro_torch.serve``, on the CPU): policy semantics, backpressure and
token parity against the port's ``greedy_generate``.  Against the JAX
reference on the same weights: with ``spec_k=0`` and no EOS (no token
value can steer a decision) each policy dispatches the same requests
to the same replicas with the same engine dispatch counters, and at
``compute_dtype="float32"`` every routed stream equals the reference
router's."""
import dataclasses

import jax
import numpy as np
import pytest

from repro import configs as jconfigs
from repro.models import build_model
from repro.serve import Request as JRequest
from repro.serve import RequestRouter as JRequestRouter
from repro.serve import ServeEngine as JServeEngine
from repro.serve import ServePrograms as JServePrograms
from repro_torch.serve import Request, RequestRouter, ServeEngine
from test_torch_faults import fleet_counters
from test_torch_fuzz import (ARCH, check_dispatch_identity,
                             drive_and_check, make_oracle, port_bundle)

PAGE = 8


@pytest.fixture(scope="module")
def bundle():
    return port_bundle()


def make_replicas(bundle, n, **kw):
    _, model, params, programs = bundle
    kw = dict(max_batch=2, n_pages=32, page_size=PAGE,
              max_pages_per_seq=8, chunk_size=16, programs=programs, **kw)
    return [ServeEngine(model, params, **kw) for _ in range(n)]


def grouped_trace(cfg, n_groups, per_group, *, prefix_len=24,
                  tail_len=6, gen=6, seed=5, cls=Request):
    """Round-robin interleaved requests from ``n_groups`` shared-prefix
    groups: g0, g1, ..., g0, g1, ... — rid % n_groups is the group."""
    rng = np.random.default_rng(seed)
    prefixes = [rng.integers(0, cfg.vocab_size,
                             size=(prefix_len,)).astype(np.int32)
                for _ in range(n_groups)]
    reqs = []
    for i in range(n_groups * per_group):
        tail = rng.integers(0, cfg.vocab_size,
                            size=(tail_len,)).astype(np.int32)
        reqs.append(cls(
            rid=i, prompt=np.concatenate([prefixes[i % n_groups], tail]),
            max_new_tokens=gen))
    return reqs


# ------------------------------------------------------------- parity
def test_router_token_parity_and_affinity_partitioning(bundle):
    """Routed streams match the oracle bit for bit, every request
    finishes exactly once, and prefix affinity pins each prompt group
    to exactly one replica."""
    cfg, model, params, _ = bundle
    oracle = make_oracle(model, params)
    reqs = grouped_trace(cfg, n_groups=2, per_group=4)
    router = RequestRouter(make_replicas(bundle, 2), policy="prefix")
    done = router.run(reqs)
    assert sorted(r.rid for r in done) == list(range(len(reqs)))
    for r in done:
        np.testing.assert_array_equal(
            np.asarray(r.generated, np.int32),
            oracle(r.prompt, r.max_new_tokens),
            err_msg=f"request {r.rid} diverged")
    group_homes = {}
    for i, eng in enumerate(router.replicas):
        for r in eng.finished:
            group_homes.setdefault(r.rid % 2, set()).add(i)
        eng.cache.check_invariants()
    assert all(len(homes) == 1 for homes in group_homes.values()), \
        group_homes
    assert router.n_affinity_hits >= len(reqs) - 2


def test_prefix_affinity_beats_round_robin(bundle):
    """On an interleaved shared-prefix trace (3 groups over 2 replicas,
    so round-robin scatters every group), affinity routing reuses
    strictly more prefix KV and ingests strictly fewer prompt chunks."""
    cfg = bundle[0]

    def serve(policy):
        reps = make_replicas(bundle, 2)
        RequestRouter(reps, policy=policy).run(
            grouped_trace(cfg, n_groups=3, per_group=4))
        return (sum(e.cache.n_shared_tokens for e in reps),
                sum(e.n_prefill_chunks for e in reps))

    aff_shared, aff_chunks = serve("prefix")
    rr_shared, rr_chunks = serve("round-robin")
    assert aff_shared > rr_shared, (aff_shared, rr_shared)
    assert aff_chunks < rr_chunks, (aff_chunks, rr_chunks)


def test_backpressure_holds_but_never_drops(bundle):
    cfg = bundle[0]
    reqs = grouped_trace(cfg, n_groups=2, per_group=4)
    router = RequestRouter(make_replicas(bundle, 2), policy="prefix",
                           max_inflight=1)
    for r in reqs:
        router.submit(r)
    held = False
    while router.step():
        held |= bool(router.queue)
        for eng in router.replicas:
            assert eng.n_inflight <= 1
    assert held, "cap was meant to stall dispatch at least once"
    done = sorted(r.rid for e in router.replicas for r in e.finished)
    assert done == list(range(len(reqs)))


@pytest.mark.parametrize("policy", ["least-loaded", "round-robin"])
def test_least_loaded_balances_outstanding_tokens(bundle, policy):
    cfg = bundle[0]
    router = RequestRouter(make_replicas(bundle, 2), policy=policy)
    router.run(grouped_trace(cfg, n_groups=4, per_group=2, seed=9))
    assert router.n_dispatched == [4, 4], (policy, router.n_dispatched)


def test_heterogeneous_fleet_routes_around_small_replica(bundle):
    cfg, model, params, programs = bundle
    big = ServeEngine(model, params, max_batch=2, n_pages=32,
                      page_size=PAGE, max_pages_per_seq=10,
                      chunk_size=16, programs=programs)
    small = ServeEngine(model, params, max_batch=2, n_pages=6,
                        page_size=PAGE, max_pages_per_seq=4,
                        chunk_size=16, programs=programs)
    router = RequestRouter([small, big], policy="least-loaded")
    rng = np.random.default_rng(2)
    tall = [Request(rid=i,
                    prompt=rng.integers(0, cfg.vocab_size,
                                        size=(40,)).astype(np.int32),
                    max_new_tokens=12) for i in range(3)]
    done = router.run(tall)
    assert sorted(r.rid for r in done) == [0, 1, 2]
    assert router.n_dispatched == [0, 3]
    with pytest.raises(ValueError, match="page budget"):
        router.submit(Request(rid=9, prompt=np.arange(8, dtype=np.int32),
                              max_new_tokens=10_000))


def test_router_rejects_bad_config_and_requests(bundle):
    reps = make_replicas(bundle, 1)
    with pytest.raises(ValueError, match="policy"):
        RequestRouter(reps, policy="fastest")
    with pytest.raises(ValueError):
        RequestRouter([])
    router = RequestRouter(reps)
    with pytest.raises(ValueError, match="page budget"):
        router.submit(Request(rid=0, prompt=np.arange(8, dtype=np.int32),
                              max_new_tokens=10_000))
    assert router.n_inflight == 0


# --------------------------------------------- against the JAX reference
@pytest.fixture(scope="module")
def ref():
    """The reference's smoke model on the same weights (PRNGKey(0)),
    with one program bundle, at the compute dtype asked for."""
    out = {}

    def get(dtype):
        if dtype not in out:
            cfg = dataclasses.replace(jconfigs.get_smoke(ARCH),
                                      compute_dtype=dtype)
            model = build_model(cfg)
            out[dtype] = (cfg, model,
                          model.init(jax.random.PRNGKey(0)),
                          JServePrograms(model))
        return out[dtype]
    return get


def _route(replicas, router_cls, reqs, policy):
    router = router_cls(replicas, policy=policy, max_inflight=3)
    drive_and_check(router, reqs)
    return router


def _arrivals(reqs):
    for i, r in enumerate(reqs):
        r.arrival = float(i // 4)
    return reqs


@pytest.mark.parametrize("policy", ["prefix", "least-loaded",
                                    "round-robin"])
def test_router_counters_equal_reference(bundle, ref, policy):
    """One 3-group trace with staggered arrivals and a per-replica cap
    of 3 per policy: the same dispatch per replica, affinity hits and
    engine dispatch counters as the reference's router."""
    cfg = bundle[0]
    jcfg, jmodel, jparams, jprograms = ref("bfloat16")
    kw = dict(max_batch=2, n_pages=32, page_size=PAGE,
              max_pages_per_seq=8, chunk_size=16, spec_k=0)
    jreps = [JServeEngine(jmodel, jparams, programs=jprograms, **kw)
             for _ in range(2)]
    want = _route(jreps, JRequestRouter, _arrivals(grouped_trace(
        jcfg, 3, 4, seed=11, cls=JRequest)), policy)
    got = _route(make_replicas(bundle, 2, spec_k=0), RequestRouter,
                 _arrivals(grouped_trace(cfg, 3, 4, seed=11)), policy)
    assert fleet_counters(got) == fleet_counters(want)
    check_dispatch_identity(got.stats())
    if policy == "prefix":
        assert got.n_affinity_hits > 0


def test_router_streams_equal_reference_at_f32(ref):
    """At f32 on the same weights the port's fleet streams the tokens
    of the reference's, request by request."""
    jcfg, jmodel, jparams, jprograms = ref("float32")
    cfg, model, params, programs = port_bundle(dtype="float32")
    kw = dict(max_batch=2, n_pages=32, page_size=PAGE,
              max_pages_per_seq=8, chunk_size=16, spec_k=3)
    jreps = [JServeEngine(jmodel, jparams, programs=jprograms, **kw)
             for _ in range(2)]
    want = _route(jreps, JRequestRouter, _arrivals(grouped_trace(
        jcfg, 2, 3, seed=12, cls=JRequest)), "prefix")
    reps = [ServeEngine(model, params, programs=programs, **kw)
            for _ in range(2)]
    got = _route(reps, RequestRouter,
                 _arrivals(grouped_trace(cfg, 2, 3, seed=12)), "prefix")
    streams = {r.rid: list(r.generated) for r in got.finished}
    assert streams == {r.rid: [int(t) for t in r.generated]
                       for r in want.finished}
    assert len(streams) == 6

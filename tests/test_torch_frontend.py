"""The port's streaming front-end (tests/test_serve_frontend.py on
``repro_torch.serve``, on the CPU): stream-vs-batch token parity on the
port's engine (sharing, speculation, preemption, cancel), scheduling
policy (WFQ weights, rate limits, SLO preemption) on a model-free fake
backend, and the same admission order and per-tenant token split as the
reference's ``ServeFrontend`` over the same fake backend."""
import asyncio

import numpy as np
import pytest

from repro.serve import ServeFrontend as JServeFrontend
from repro.serve import TenantPolicy as JTenantPolicy
from repro_torch.serve import (
    Request, ServeBackend, ServeFrontend, ServeOptions, StreamEvent,
    TenantPolicy,
)
from test_torch_fuzz import make_oracle, port_bundle


@pytest.fixture(scope="module")
def bundle():
    return port_bundle()


def _prompts(cfg, n=6, plen=20, shared=0, seed=0):
    rng = np.random.default_rng(seed)
    prefix = rng.integers(0, cfg.vocab_size, shared, dtype=np.int32)
    return [np.concatenate([prefix,
                            rng.integers(0, cfg.vocab_size, plen,
                                         dtype=np.int32)])
            for _ in range(n)]


def _oracle(bundle, prompts, gen):
    run = make_oracle(bundle[1], bundle[2])
    return [[int(t) for t in run(p, gen)] for p in prompts]


def _backend(bundle, **kw):
    _, model, params, programs = bundle
    reqs = [Request(rid=0, prompt=np.zeros(64, np.int32),
                    max_new_tokens=16)]
    opts = ServeOptions(batch=kw.pop("batch", 3), page_size=8,
                        chunk_size=16, **kw)
    return opts.sized_for(reqs).build(model, params, programs=programs)


# ----------------------------------------------------- fake backend
class FakeBackend:
    """Deterministic ServeBackend stand-in: each step confirms one
    token (rid*1000 + index) per dispatched request."""

    def __init__(self, capacity=1):
        self._capacity = capacity
        self.active = {}
        self.events = []
        self.dispatch_order = []

    @property
    def capacity(self):
        return self._capacity

    @property
    def n_inflight(self):
        return len(self.active)

    def check_admissible(self, req):
        pass

    def submit(self, req):
        assert len(self.active) < self._capacity, "frontend over-dispatched"
        self.active[req.rid] = req
        self.dispatch_order.append(req.rid)

    def step(self, now=float("inf")):
        for rid, req in list(self.active.items()):
            req.generated.append(rid * 1000 + len(req.generated))
            done = len(req.generated) >= req.max_new_tokens
            if done:
                req.finish_time = now
                del self.active[rid]
            self.events.append(StreamEvent(rid=rid,
                                           tokens=(req.generated[-1],),
                                           finished=done))
        return bool(self.active)

    def drain_events(self):
        ev, self.events = self.events, []
        return ev

    def extract(self, rid):
        return self.active.pop(rid, None)

    def cancel(self, rid):
        return self.extract(rid) is not None

    def run(self, requests, *, realtime=False):
        raise NotImplementedError

    def stats(self):
        return {}


def test_fake_backend_satisfies_protocol():
    assert isinstance(FakeBackend(), ServeBackend)


# ------------------------------------------------------------ parity
def test_stream_matches_batch_run(bundle):
    """Streamed tokens are bitwise-equal to the offline ServeEngine.run
    path and the oracle, with prefix sharing AND speculation on."""
    prompts = _prompts(bundle[0], shared=16)
    gen = 8
    want = _oracle(bundle, prompts, gen)
    eng = _backend(bundle, spec_k=3)
    done = eng.run([Request(rid=i, prompt=p, max_new_tokens=gen)
                    for i, p in enumerate(prompts)], realtime=False)
    assert sorted((r.rid, tuple(r.generated)) for r in done) \
        == [(i, tuple(t)) for i, t in enumerate(want)]
    fe = ServeFrontend(_backend(bundle, spec_k=3))
    streams = [fe.submit(p, gen) for p in prompts]
    for s, toks in zip(streams, want):
        assert list(s) == toks
    st = fe.stats()
    assert st["n_completed"] == len(prompts) and st["n_inflight"] == 0


def test_cancel_mid_stream_and_resubmit_reuses_trie(bundle):
    prompts = _prompts(bundle[0], n=2)
    gen = 8
    want = _oracle(bundle, prompts, gen)
    eng = _backend(bundle)
    fe = ServeFrontend(eng)
    s0, s1 = (fe.submit(p, gen) for p in prompts)
    it = iter(s0)
    head = [next(it) for _ in range(3)]
    assert head == want[0][:3]
    shared_before = eng.cache.n_shared_tokens
    assert s0.cancel()
    assert not s0.cancel()                     # idempotent
    with pytest.raises(StopIteration):
        next(it)
    assert list(s1) == want[1]                 # unaffected neighbor
    s0b = fe.submit(prompts[0], gen)
    assert list(s0b) == want[0]
    assert eng.cache.n_shared_tokens > shared_before
    assert fe.stats()["n_cancelled"] == 1


def test_cancel_while_queued():
    be = FakeBackend(capacity=1)
    fe = ServeFrontend(be)
    s0 = fe.submit([1, 2], 3)
    s1 = fe.submit([3, 4], 3)
    assert s1.cancel()
    list(s0)
    assert not fe.busy and be.dispatch_order == [s0.rid]
    assert s1.cancelled and list(s1) == []


def test_async_consumption(bundle):
    prompts = _prompts(bundle[0], n=3)
    gen = 6
    want = _oracle(bundle, prompts, gen)

    async def go():
        fe = ServeFrontend(_backend(bundle))
        task = asyncio.create_task(fe.serve())

        async def consume(p):
            return [t async for t in fe.submit(p, gen)]

        outs = await asyncio.gather(*(consume(p) for p in prompts))
        fe.close()
        await task
        return outs

    assert asyncio.run(go()) == want


def test_stream_over_a_routed_fleet(bundle):
    """The front-end over a 2-replica router built by ``ServeOptions``
    (tenant weights materialized as policies) streams the oracle."""
    _, model, params, programs = bundle
    prompts = _prompts(bundle[0], n=5, shared=8, seed=3)
    want = _oracle(bundle, prompts, 6)
    opts = ServeOptions(batch=2, page_size=8, chunk_size=16, replicas=2,
                        stream=True, tenant_weights={"gold": 3, "free": 1})
    fe = opts.sized_for([Request(rid=0, prompt=prompts[0],
                                 max_new_tokens=6)]).build_frontend(
        model, params, programs=programs)
    assert set(fe.policies) == {"gold", "free"}
    streams = [fe.submit(p, 6, tenant=("gold", "free")[i % 2],
                         slo_class=("interactive", "batch")[i % 2])
               for i, p in enumerate(prompts)]
    assert [list(s) for s in streams] == want
    assert sum(fe.tenant_tokens.values()) == 5 * 6


# ------------------------------------------------------------- policy
def test_wfq_weighted_share():
    be = FakeBackend(capacity=1)
    fe = ServeFrontend(be, tenants={"gold": TenantPolicy(weight=3.0),
                                    "free": TenantPolicy(weight=1.0)})
    streams = [fe.submit([1, 2, 3, 4], 2, tenant=t)
               for t in ("gold", "free") for _ in range(12)]
    fe.drain()
    assert all(s.finished for s in streams)
    first16 = be.dispatch_order[:16]
    gold = sum(1 for rid in first16 if rid < 12)
    assert 10 <= gold <= 13, first16    # ~12/16 = weight 3 of 4


def test_wfq_idle_tenant_earns_no_credit():
    be = FakeBackend(capacity=1)
    fe = ServeFrontend(be, tenants={"a": TenantPolicy(),
                                    "b": TenantPolicy()})
    for _ in range(6):
        fe.submit([1, 2], 2, tenant="a")
    for _ in range(4):                   # a streams alone for a while
        fe.pump()
    for _ in range(6):
        fe.submit([1, 2], 2, tenant="b")
    fe.drain()
    tail = be.dispatch_order[-8:]
    a_tail = sum(1 for rid in tail if rid < 6)
    assert 2 <= a_tail <= 6, be.dispatch_order   # interleaved, no b-burst


def test_rate_limit_throttles_sustained_load():
    be = FakeBackend(capacity=2)
    fe = ServeFrontend(be, tenants={
        "lim": TenantPolicy(rate=1.0),    # 1 cost unit per step
        "unl": TenantPolicy()})
    cost = 4 + 2                          # prompt 4 + gen 2
    lim = [fe.submit([1, 2, 3, 4], 2, tenant="lim") for _ in range(3)]
    unl = [fe.submit([1, 2, 3, 4], 2, tenant="unl") for _ in range(3)]
    t_lim, t_unl = [], []
    step = 0
    while fe.busy:
        step += 1
        n_before = len(be.dispatch_order)
        fe.pump(now=float(step))
        for rid in be.dispatch_order[n_before:]:
            (t_lim if any(s.rid == rid for s in lim)
             else t_unl).append(step)
    assert all(s.finished for s in lim + unl)
    assert t_unl[-1] - t_unl[0] <= 4
    gaps = [b - a for a, b in zip(t_lim, t_lim[1:])]
    assert all(g >= cost - 1 for g in gaps), (t_lim, gaps)


@pytest.mark.parametrize("aware,expect_preempt", [(True, 1), (False, 0)])
def test_slo_interactive_preempts_batch(aware, expect_preempt):
    be = FakeBackend(capacity=2)
    fe = ServeFrontend(be, slo_aware=aware)
    batch = [fe.submit([1, 2], 8) for _ in range(2)]
    fe.pump()                             # both dispatched, 1 token each
    inter = fe.submit([3, 4], 2, slo_class="interactive")
    fe.drain()
    assert fe.stats()["n_slo_preemptions"] == expect_preempt
    assert all(s.finished for s in batch + [inter])
    if aware:
        victim = min(batch, key=lambda s: s.rid)
        assert len(victim.req.generated) == 8
        assert victim.req.n_preemptions == 1
        assert inter.req.finish_time <= victim.req.finish_time


def test_slo_preemption_parity_on_engine(bundle):
    prompts = _prompts(bundle[0], n=3)
    gen = 16
    want = _oracle(bundle, prompts, gen)
    fe = ServeFrontend(_backend(bundle, batch=2))
    b0 = fe.submit(prompts[0], gen)
    b1 = fe.submit(prompts[1], gen)
    for _ in range(3):                    # let batch work get going
        fe.pump()
    hi = fe.submit(prompts[2], gen, slo_class="interactive")
    fe.drain()
    assert fe.stats()["n_slo_preemptions"] >= 1
    assert [list(b0), list(b1), list(hi)] == want


def test_submit_rejects_inadmissible(bundle):
    fe = ServeFrontend(_backend(bundle))
    with pytest.raises(ValueError):
        fe.submit(np.zeros(100000, np.int32), 4)      # never fits
    with pytest.raises(ValueError):
        fe.submit([1, 2], 4, slo_class="platinum")    # unknown class
    with pytest.raises(ValueError):
        fe.submit([1, 2], 4, rid=fe.submit([3, 4], 2).rid)


# --------------------------------------------- against the JAX reference
def _mixed_workload(frontend_cls, policy_cls):
    """Three tenants (weights 3 and 1, one rate-limited), interactive
    arrivals preempting batch work mid-trace, a cancel, over a
    capacity-2 fake backend on the deterministic pump clock."""
    be = FakeBackend(capacity=2)
    fe = frontend_cls(be, tenants={"gold": policy_cls(weight=3.0),
                                   "free": policy_cls(weight=1.0),
                                   "lim": policy_cls(rate=2.0)})
    rng = np.random.default_rng(4)
    streams = []
    for step in range(24):
        for _ in range(int(rng.integers(0, 3))):
            tenant = ("gold", "free", "lim")[int(rng.integers(0, 3))]
            slo = "interactive" if rng.random() < 0.25 else "batch"
            streams.append(fe.submit(
                list(range(int(rng.integers(2, 6)))),
                int(rng.integers(2, 7)), tenant=tenant, slo_class=slo))
        if step == 9:
            assert streams[-1].cancel()
        fe.pump()
    fe.drain()
    return (be.dispatch_order, dict(fe.tenant_tokens),
            {k: v for k, v in fe.stats().items()},
            {s.rid: list(s.req.generated) for s in streams})


def test_admission_order_and_tenant_split_equal_reference():
    got = _mixed_workload(ServeFrontend, TenantPolicy)
    want = _mixed_workload(JServeFrontend, JTenantPolicy)
    assert got == want
    order, tokens, st, _ = got
    assert len(order) > 20 and len(tokens) == 3
    assert st["n_slo_preemptions"] >= 1 and st["n_cancelled"] == 1


def test_launcher_streams_on_cpu(capsys):
    """``launch.serve --stream --tenant-weights`` on the CPU: every
    stream yields its request's tokens, split over both tenants."""
    from repro_torch.launch import serve as launch
    stats = launch.main(["--arch", "qwen3-0.6b", "--smoke", "--device",
                         "cpu", "--requests", "8", "--batch", "2",
                         "--prompt-len", "12", "--gen", "5", "--rate",
                         "1000", "--stream", "--tenant-weights",
                         "gold=3,free=1"])
    assert stats["requests"] == 8 and stats["tokens"] == 40
    for s in stats["streams"].values():
        assert s.finished and list(s) == s.req.generated
    assert sum(stats["tenant_tokens"].values()) == 40
    assert set(stats["ttft_by_class"]) == {"interactive", "batch"}
    assert "tenant tokens: gold=" in capsys.readouterr().out

"""The serving programs that replay as CUDA graphs besides the engine's
paged ones (``tests/test_torch_compiled.py``): the tensor-parallel
programs in pieces cut at their gathers (``serve/parallel.py``,
``PiecewiseProgram``), and the lockstep decode with ``pos`` a device
scalar (``ServePrograms.lockstep``), which ``greedy_generate``,
``run_naive`` and the draft model's drafter replay.

They run on the CPU through ``torch_graph_tape.Tape``, a stand-in that
records the aten ops a capture runs and replays them on the same
tensors, as a graph does: a value read on the host while capturing
raises, and one baked into a replay shows as a wrong result.  Graphed
runs are held to eager ones bit for bit, and to the reference."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import build_model as jbuild
from repro.serve.step import greedy_generate as jgreedy
from repro_torch import configs
from repro_torch.launch.serve import run_naive, synthetic_batch
from repro_torch.models import build_model
from repro_torch.serve import (DraftModelDrafter, Request, ServeEngine,
                               ServePrograms, greedy_generate)
from repro_torch.serve import compiled
from repro_torch.serve.parallel import (PiecewiseProgram, ShardedPages,
                                        TPServePrograms)
from test_torch_compiled import ticking  # noqa: F401 - a fixture
from test_torch_families import FAMILIES, _batches, _jcfg, _port
from test_torch_model import CONTIG_TOL, PAGED_TOL, reference
from torch_graph_tape import BrokenTape, Tape

ARCH = "qwen3-0.6b"
LOCKSTEP = (ARCH,) + FAMILIES
#: the engine trace of the tp tests: 6 prompts through 3 slots (slots
#: and pages served again), chunked prefill, fused steps
TP_KW = dict(max_batch=3, n_pages=48, page_size=8, max_pages_per_seq=8,
             chunk_size=8, prefill_batch=2, prefix_sharing=False)


@pytest.fixture(scope="module")
def qwen3():
    cfg = configs.get_smoke(ARCH)
    model = build_model(cfg, device="cpu")
    return cfg, model, model.init(seed=0)


def _tokens(cfg, seed, B, T=1):
    rng = np.random.default_rng(seed)
    return torch.tensor(rng.integers(0, cfg.vocab_size, (B, T)),
                        dtype=torch.int32)


def _flat(x):
    return list(x) if isinstance(x, tuple) else [x]


# --------------------------------------------- tensor-parallel, in pieces
def _tp_state(progs, cfg, seed, n_pages=16, ps=8):
    g = torch.Generator().manual_seed(seed)
    shape = (cfg.n_layers, n_pages, ps, cfg.n_kv_heads, cfg.head_dim)
    pools = {n: torch.randn(shape, generator=g).bfloat16()
             for n in compiled.POOL_KEYS}
    return {**{n: progs.prepare_pages(t) for n, t in pools.items()},
            "page_tables": torch.arange(1, 9, dtype=torch.int32
                                        ).reshape(4, 2),
            "lengths": torch.tensor([3, 9, 0, 12], dtype=torch.int32)}


def _tp_clone(st):
    return {k: (ShardedPages([s.clone() for s in v.shards])
                if isinstance(v, ShardedPages) else v.clone())
            for k, v in st.items()}


def _tp_pools_equal(a, b):
    return all(torch.equal(x[:, 1:], y[:, 1:])
               for n in compiled.POOL_KEYS
               for x, y in zip(a[n].shards, b[n].shards))


def test_tp_pieces_a_capture_a_key_and_a_segment_a_gather(qwen3):
    """A key's first call runs eagerly and captures every shard in
    gathers + 1 segments (two gathers a layer: the heads before ``wo``,
    the FFN's hidden dim before ``wd``); each repeat replays them into
    the same static output, equal to the eager programs on other tokens
    and lengths, the host's replay seconds split between the segments
    and the gathers; a replaced pool shard or parameter leaf is a new
    key."""
    cfg, model, params = qwen3
    progs = TPServePrograms(model, devices=["cpu", "cpu"], capture=Tape)
    g = progs.for_engine()
    assert progs.graphs and isinstance(g.decode, PiecewiseProgram)
    ptp = progs.prepare_params(params)
    st = _tp_state(progs, cfg, 0)
    outs = []
    for seed in (1, 2, 3):
        tok = _tokens(cfg, seed, 4)
        st["lengths"] = torch.tensor([3, 9, 1, 10], dtype=torch.int32) \
            + seed
        want, want_st = progs.decode(ptp, _tp_clone(st), tok)
        got, got_st = g.decode(ptp, st, tok)
        assert got_st is st
        assert torch.equal(got, want)
        assert _tp_pools_equal(st, want_st)
        outs.append(got)
    assert outs[1] is outs[2] and outs[0] is not outs[1]
    stats = progs.graph_stats
    assert stats.captures == {"decode": 1} and stats.replays == {"decode": 2}
    # the replays' host seconds, split between launches and gathers
    assert set(stats.host_s) == {"segments", "gathers"}
    assert all(v > 0 for v in stats.host_s.values())
    (graph,) = g.decode._graphs.values()
    assert len(graph.gathers) == 2 * cfg.n_layers
    assert [len(s) for s in graph.segments] == [2 * cfg.n_layers + 1] * 2
    tok = _tokens(cfg, 4, 4)
    moved = {**st, "k_pages": ShardedPages(
        [st["k_pages"].shards[0].clone(), st["k_pages"].shards[1]])}
    want, _ = progs.decode(ptp, _tp_clone(moved), tok)
    got, _ = g.decode(ptp, moved, tok)
    assert torch.equal(got, want) and stats.captures["decode"] == 2
    leaf = ptp[1]["layers"]["mix"]["wq"]
    other = [ptp[0], {**ptp[1], "layers": {**ptp[1]["layers"], "mix": {
        **ptp[1]["layers"]["mix"], "wq": leaf.clone()}}}]
    g.decode(other, st, tok)
    assert stats.captures["decode"] == 3
    g.decode(ptp, st, tok)                   # the first key again
    assert stats.captures["decode"] == 3 and stats.replays["decode"] == 3
    assert g.graphs() == {"decode": 3, "chunk": 0, "verify": 0, "fused": 0}


def test_tp_each_program_replays_the_eager_logits(qwen3):
    """One dispatch of each program captured on some inputs, then
    replayed on others: the logits (each program's own output, not its
    argmax) and both pools' shards equal the eager programs' on the
    replay's inputs (the chip's tp gate, at tp 2 on the CPU)."""
    cfg, model, params = qwen3
    progs = TPServePrograms(model, devices=["cpu", "cpu"], capture=Tape)
    ptp = progs.prepare_params(params)
    methods = {"chunk": "prefill_chunk_paged", "decode": "decode_step_paged",
               "verify": "verify_step_paged", "fused": "fused_step_paged"}
    st0 = _tp_state(progs, cfg, 5)

    def inputs(name, seed):
        rng = np.random.default_rng(seed)
        rows = {"page_tables": st0["page_tables"].clone(),
                "lengths": torch.tensor(rng.integers(1, 8, 4),
                                        dtype=torch.int32)}
        p = (_tokens(cfg, seed, 2, 8), torch.tensor([[9, 10], [11, 12]],
                                                    dtype=torch.int32),
             torch.zeros(2, dtype=torch.int32),
             torch.tensor(rng.integers(1, 9, 2), dtype=torch.int32))
        return {"chunk": ({}, p),
                "decode": (rows, (_tokens(cfg, seed, 4),)),
                "verify": (rows, (_tokens(cfg, seed, 4, 3),)),
                "fused": (rows, (_tokens(cfg, seed, 4, 3), *p))}[name]
    for name, method in methods.items():
        prog = PiecewiseProgram(name, progs, {torch.device("cpu"):
                                              Tape("cpu")},
                                compiled.GraphStats())
        prog.maker = lambda m, gather, method=method: (
            lambda p, st, *a: getattr(m, method)(p, st, *a, gather=gather))
        st = _tp_clone(st0)
        extra, args = inputs(name, 1)
        prog(ptp, {**st, **extra}, *args)                  # eager, capture
        for n in compiled.POOL_KEYS:
            for a, b in zip(st[n].shards, st0[n].shards):
                a.copy_(b)
        extra, args = inputs(name, 2)
        got, _ = prog(ptp, {**st, **extra}, *args)         # replay
        want_st = _tp_clone(st0)
        want = progs.map_shards(
            lambda m, gather, p, s, *a: getattr(m, method)(
                p, s, *a, gather=gather)[0],
            ptp, {**want_st, **extra}, *args)[0]
        assert all(torch.equal(a, b)
                   for a, b in zip(_flat(got), _flat(want))), name
        assert _tp_pools_equal(st, want_st), name
        assert prog.stats.replays == {name: 1}


def test_tp_graphed_engine_equals_eager(qwen3, ticking):
    """An engine trace at tp 2 on the CPU through the pieces: streams,
    dispatch counters, both pools' shards and the kernels' launches
    (each replay credited with its capture's) equal the eager tp
    engine's."""
    cfg, model, params = qwen3
    rng = np.random.default_rng(9)
    prompts = [rng.integers(0, cfg.vocab_size, (L,)).astype(np.int32)
               for L in (12, 20, 9, 16, 14, 11)]
    runs = {}
    for graphs in (False, True):
        progs = TPServePrograms(model, devices=["cpu", "cpu"],
                                capture=Tape if graphs else None)
        compiled.set_launch_counts(dict.fromkeys(compiled.launch_counts(),
                                                 0))
        eng = ServeEngine(model, params, programs=progs, **TP_KW)
        done = eng.run([Request(rid=i, prompt=p, max_new_tokens=6)
                        for i, p in enumerate(prompts)])
        st = eng.stats()
        runs[graphs] = ({r.rid: list(r.generated) for r in done},
                        {k: v for k, v in st.items() if k.startswith("n_")},
                        compiled.launch_counts(), eng, progs.graph_stats)
    (e_streams, e_counters, e_launch, e_eng, _), \
        (g_streams, g_counters, g_launch, g_eng, stats) = \
        runs[False], runs[True]
    assert len(g_streams) == 6 and g_streams == e_streams
    assert g_counters == e_counters
    assert g_launch == e_launch and sum(g_launch.values()) > 0
    assert sum(stats.replays.values()) > 0
    assert sum(stats.captures.values()) == sum(g_eng.compiled.graphs()
                                               .values())
    for n in compiled.POOL_KEYS:
        for a, b in zip(getattr(g_eng.cache, n).shards,
                        getattr(e_eng.cache, n).shards):
            assert torch.equal(a[:, 1:], b[:, 1:])


def test_tp_graphs_only_through_a_backend_and_a_failed_capture_raises(
        qwen3):
    cfg, model, params = qwen3
    eager = TPServePrograms(model, devices=["cpu", "cpu"])
    assert not eager.graphs and eager.for_engine() is eager
    with pytest.raises(ValueError, match="CUDA"):
        TPServePrograms(model, devices=["cpu", "cpu"], graphs=True)
    broken = TPServePrograms(model, devices=["cpu", "cpu"],
                             capture=BrokenTape)
    eng = ServeEngine(model, params, programs=broken, **TP_KW)
    with pytest.raises(RuntimeError, match="capture failed"):
        eng.run([Request(rid=0, prompt=np.arange(10, dtype=np.int32),
                         max_new_tokens=4)])


# ------------------------------------------------------ pos on the device
def _is_pos(t, want: int) -> bool:
    return (isinstance(t, torch.Tensor) and t.dim() == 0
            and t.dtype == torch.int32 and int(t) == want)


@pytest.mark.parametrize("arch", [ARCH, "whisper-tiny"])
def test_pos_is_a_device_scalar(arch):
    """``init_cache``, ``prefill`` and every decode step keep ``pos`` a
    0-d int32 tensor (``cache_specs``' int32 scalar)."""
    model, params = _port(arch)
    _, tb = _batches(_jcfg(arch))
    assert _is_pos(model.init_cache(2, 8)["pos"], 0)
    _, cache = model.prefill(params, tb, max_len=40)
    assert _is_pos(cache["pos"], tb["tokens"].shape[1])
    for i in range(2):
        _, cache = model.decode_step(params, cache, tb["tokens"][:, :1])
        assert _is_pos(cache["pos"], tb["tokens"].shape[1] + i + 1)


def test_ring_decode_across_the_wrap_matches_reference():
    """recurrentgemma's decode from an empty cache, token by token past
    its smoke window (16 slots): positions 0 .. 23 before and after the
    ring wraps.  Every step's logits against the reference's decode in
    f32; in bf16 (an RG-LRU's conv state keeps the cache's dtype there)
    the graphed step, one capture and every later step a replay, bit
    for bit against the eager one, tokens and caches."""
    arch, steps = "recurrentgemma-2b", 24
    jcfg = _jcfg(arch)
    assert steps > jcfg.local_window
    jmodel, jparams = jbuild(jcfg), reference(jcfg)[1]
    model, params = _port(arch)
    jcache, cache = jmodel.init_cache(2, steps), model.init_cache(2, steps)
    toks = np.random.default_rng(4).integers(
        0, jcfg.vocab_size, (steps, 2, 1)).astype(np.int32)
    jdecode = jax.jit(jmodel.decode_step)
    for t in toks:
        jlog, jcache = jdecode(jparams, jcache, jnp.asarray(t))
        log, cache = model.decode_step(params, cache, torch.from_numpy(t))
        # a few keys a row: the port's flash decode rounds p to bf16
        # before P.V (the kernel's contract) where the reference keeps
        # its exact f32 softmax, the paged programs' PAGED_TOL case
        tol = PAGED_TOL * max(1.0, float(np.abs(jlog).max()))
        np.testing.assert_allclose(log.numpy(), np.asarray(jlog),
                                   rtol=0, atol=tol)
    model, params = _port(arch, "bfloat16")
    eager, graphed = model.init_cache(2, steps), model.init_cache(2, steps)
    progs = ServePrograms(model, capture=Tape)
    step = progs.lockstep()
    for i, t in enumerate(toks):
        log, eager = model.decode_step(params, eager, torch.from_numpy(t))
        tok, graphed = step(params, graphed, torch.from_numpy(t))
        assert torch.equal(tok, log.argmax(-1).int()[:, None]), i
        assert _is_pos(graphed["pos"], i + 1)
        assert all(torch.equal(a, b) for a, b in zip(
            compiled.tensors_of(graphed), compiled.tensors_of(eager))), i
    assert progs.graph_stats.captures == {"lockstep": 1}
    assert progs.graph_stats.replays == {"lockstep": steps - 1}
    f32, _ = _port(arch)
    with pytest.raises(ValueError, match="dtype"):
        ServePrograms(f32, capture=Tape).lockstep()(
            params, f32.init_cache(2, steps), torch.from_numpy(toks[0]))


@pytest.mark.parametrize("arch", ["whisper-tiny", "qwen2-vl-7b"])
def test_graphed_decode_after_prefill_matches_reference(arch):
    """After the prompt, each graphed decode step's cache and tokens
    equal the eager step's, and its logits (the eager step's) the
    reference's."""
    jcfg = _jcfg(arch)
    jmodel, jparams = jbuild(jcfg), reference(jcfg)[1]
    model, params = _port(arch)
    jb, tb = _batches(jcfg)
    S, n = tb["tokens"].shape[1], 5
    jlast, jcache = jax.jit(lambda p, b: jmodel.prefill(
        p, b, max_len=S + n))(jparams, jb)
    _, eager = model.prefill(params, tb, max_len=S + n)
    _, graphed = model.prefill(params, tb, max_len=S + n)
    step = ServePrograms(model, capture=Tape).lockstep()
    tok = np.array(jnp.argmax(jlast, -1), np.int32)[:, None]
    jdecode = jax.jit(jmodel.decode_step)
    for _ in range(n):
        jlog, jcache = jdecode(jparams, jcache, jnp.asarray(tok))
        log, eager = model.decode_step(params, eager, torch.from_numpy(tok))
        np.testing.assert_allclose(log.numpy(), np.asarray(jlog),
                                   rtol=CONTIG_TOL, atol=CONTIG_TOL)
        got, graphed = step(params, graphed, torch.from_numpy(tok))
        tok = np.array(jnp.argmax(jlog, -1), np.int32)[:, None]
        assert np.array_equal(got.numpy(), tok)
    assert all(torch.equal(a, b) for a, b in zip(
        compiled.tensors_of(graphed), compiled.tensors_of(eager)))


@pytest.mark.parametrize("arch", LOCKSTEP)
def test_graphed_greedy_generate_equals_eager_and_reference(arch):
    """``greedy_generate`` through one graph (a capture, then n - 2
    replays) gives the eager loop's tokens and the reference's."""
    jcfg = _jcfg(arch)
    model, params = _port(arch)
    jb, tb = _batches(jcfg)
    n, cap = 8, tb["tokens"].shape[1] + 8
    want = jgreedy(jbuild(jcfg), reference(jcfg)[1], jb, n, cache_len=cap)
    eager = greedy_generate(model, params, tb, n, cache_len=cap,
                            programs=ServePrograms(model, graphs=False))
    progs = ServePrograms(model, capture=Tape)
    got = greedy_generate(model, params, tb, n, cache_len=cap,
                          programs=progs)
    assert torch.equal(got, eager)
    assert np.array_equal(got.numpy(), np.asarray(want))
    assert progs.graph_stats.captures == {"lockstep": 1}
    assert progs.graph_stats.replays == {"lockstep": n - 2}


def test_graphed_naive_loop_equals_eager():
    """The launcher's ``--naive`` loop on its graph: the eager loop's
    tokens, one capture, its counters in the result."""
    cfg = configs.get_smoke("rwkv6-3b")
    model = build_model(cfg, device="cpu")
    params = model.init(seed=0)
    batch = synthetic_batch(cfg, 2, 16, device="cpu")
    eager = run_naive(model, params, batch, 6,
                      programs=ServePrograms(model, graphs=False))
    got = run_naive(model, params, batch, 6,
                    programs=ServePrograms(model, capture=Tape))
    assert torch.equal(got["tokens"], eager["tokens"])
    assert got["graph_stats"]["captures"] == {"lockstep": 1}
    assert got["graph_stats"]["replays"] == {"lockstep": 4}


# ------------------------------------------------------------ the drafter
def _draft_model():
    cfg = dataclasses.replace(configs.get_smoke(ARCH), n_layers=1,
                              name="draft")
    model = build_model(cfg, device="cpu")
    return model, model.init(seed=3)


def _req(rid, n_prompt, gen, seed):
    rng = np.random.default_rng(seed)
    r = Request(rid=rid, prompt=rng.integers(0, 100, n_prompt).astype(
        np.int32), max_new_tokens=gen)
    return r, rng


def _proposals(drafter, reqs, slot=0, k=3):
    """Each request in turn in ``slot``: proposals as its generation
    grows by one to three tokens a round, then its detach."""
    out = []
    for r, rng in reqs:
        r.generated = []
        while len(r.generated) < r.max_new_tokens:
            out.append(drafter.propose(slot, r, k))
            r.generated += [int(t) for t in rng.integers(0, 100, 2)]
        drafter.detach(slot)
    return out


def test_drafter_reuses_its_slot_cache_and_drafts_as_a_fresh_one():
    """Two requests through one slot: the graphed drafter (one capture
    for the slot, every other decode a replay) proposes what an eager
    drafter does, and what a fresh eager drafter a request does; a
    request that needs more room than the slot has remakes its cache
    (a second capture)."""
    model, params = _draft_model()

    def reqs():
        return [_req(0, 12, 6, 1), _req(1, 9, 5, 2), _req(2, 20, 14, 3)]
    eager = _proposals(DraftModelDrafter(
        model, params, programs=ServePrograms(model, graphs=False)),
        reqs())
    fresh = [p for r in reqs() for p in _proposals(DraftModelDrafter(
        model, params, programs=ServePrograms(model, graphs=False)), [r])]
    progs = ServePrograms(model, capture=Tape)
    drafter = DraftModelDrafter(model, params, programs=progs)
    got = _proposals(drafter, reqs()[:2])
    assert progs.graph_stats.captures == {"lockstep": 1}
    got += _proposals(drafter, reqs()[2:])
    assert got == eager == fresh and any(got)
    assert progs.graph_stats.captures == {"lockstep": 2}
    assert progs.graph_stats.replays["lockstep"] > 20
    assert drafter._slots == {} and list(drafter._caches) == [0]


# -------------------------------------------------- a broken capture raises
def test_a_failed_lockstep_capture_raises(qwen3):
    """No lockstep path carries on eagerly when a capture fails:
    ``greedy_generate``, ``run_naive`` and the drafter."""
    cfg, model, params = qwen3
    broken = ServePrograms(model, capture=BrokenTape)
    prompt = torch.from_numpy(np.arange(8, dtype=np.int32))[None]
    with pytest.raises(RuntimeError, match="capture failed"):
        greedy_generate(model, params, prompt, 4, 12, programs=broken)
    with pytest.raises(RuntimeError, match="capture failed"):
        run_naive(model, params, {"tokens": prompt}, 4, programs=broken)
    drafter = DraftModelDrafter(model, params, programs=broken)
    with pytest.raises(RuntimeError, match="capture failed"):
        drafter.propose(0, _req(0, 6, 4, 0)[0], 2)

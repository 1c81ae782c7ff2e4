"""The serving programs' CUDA graphs (``repro_torch.serve.compiled``)
run on the CPU through a stand-in capture backend: the stand-in runs
the program where the card would capture or replay it, so the keying,
the static-buffer copies, the binding of each graph to its engine's
pools and the launch counters' credit run here.  The engine on the
stand-in gives the eager engine's streams, counters, pools and
launches, and the JAX engine's dispatch counters.  On the card the
smoke run (``chip_smoke.py``) holds the real graphs to eager."""
import jax
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import build_model
from repro.serve import Request as JRequest
from repro.serve import ServeEngine as JServeEngine
from repro_torch import configs
from repro_torch.checkpoint import params_from_jax
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.paged_attention import ops as pa_ops
from repro_torch.kernels.gemm_dataflow import ops as gd_ops
from repro_torch.models import components
from repro_torch.models.lm import DecoderLM
from repro_torch.serve import Request, ServeEngine, ServePrograms
from repro_torch.serve import compiled
from repro_torch.serve.parallel import TPServePrograms

ARCH = "qwen3-0.6b"
COUNTERS = ["n_prefill_dispatches", "n_prefill_chunks", "n_decode_steps",
            "n_replay_steps", "n_fused_dispatches", "n_total_dispatches"]
#: the fused-step trace of tests/test_torch_engine.py (6 requests x 16
#: tokens, chunk 8, co-ingest 2, 4 slots), spec_k 0, no EOS
FUSED_KW = dict(max_batch=4, n_pages=64, page_size=8, max_pages_per_seq=8,
                chunk_size=8, prefill_batch=2, prefix_sharing=False)
GEN = 6


class StandIn:
    """``compiled.CudaGraphs``'s place on the CPU.  ``warm`` runs the
    program.  ``capture`` runs its Python once, as a capture does; here
    its arithmetic runs too, writing again the K/V the warm-up wrote
    (each program writes a slot before it reads it).  A replay runs the
    program on the static inputs into the static outputs and takes back
    its counters' ticks: a graph's replay runs no Python."""

    def __init__(self, device):
        self.device = device

    def warm(self, fn):
        return fn()

    def capture(self, fn):
        out = fn()

        def replay():
            before = compiled.launch_counts()
            got = fn()
            compiled.set_launch_counts(before)
            for o, g in zip(_flat(out), _flat(got)):
                o.copy_(g)
        return replay, out


class BrokenCapture(StandIn):
    def capture(self, fn):
        raise RuntimeError("capture failed")


def _flat(x):
    return [t for y in x for t in _flat(y)] if isinstance(x, tuple) else [x]


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


def _drive(engine, request_cls, prompts):
    for i, p in enumerate(prompts):
        engine.submit(request_cls(rid=i, prompt=p, max_new_tokens=GEN,
                                  arrival=0.0))
    while engine.step(now=0.0):
        pass
    st = engine.stats()
    return {k: int(st[k]) for k in COUNTERS}


@pytest.fixture(scope="module")
def ref_counters(ref, port):
    """The JAX engine's dispatch counters on the fused trace."""
    prompts = _prompts(port[0], 7, [16] * 6)
    return _drive(JServeEngine(ref[0], ref[1], **FUSED_KW), JRequest,
                  prompts)


@pytest.fixture
def ticking(monkeypatch):
    """The path kernels' counters tick on the CPU too: their plain
    versions count a launch where the card's wrappers would."""
    def counted(mod, fn, f32=False):
        def call(*args, **kw):
            mod.launches += 1
            if f32:
                mod.launches_f32 += int(args[0].dtype == torch.float32)
            return fn(*args, **kw)
        return call
    monkeypatch.setattr(pa_ops, "paged_attention_plain",
                        counted(pa_ops, pa_ops.paged_attention_plain))
    monkeypatch.setattr(fa_ops, "flash_attention_plain",
                        counted(fa_ops, fa_ops.flash_attention_plain))
    monkeypatch.setattr(components, "project",
                        counted(gd_ops, components.project, f32=True))
    monkeypatch.setattr(components, "project_f32",
                        counted(gd_ops, components.project_f32, f32=True))
    before = compiled.launch_counts()
    compiled.set_launch_counts(dict.fromkeys(before, 0))
    yield
    compiled.set_launch_counts(before)


def _state(cfg, seed, B=4, n_pages=12, ps=8, per_row=2):
    """A page pool with random K/V, each row two pages of its own, a
    length each row."""
    g = torch.Generator().manual_seed(seed)
    shape = (cfg.n_layers, n_pages, ps, cfg.n_kv_heads, cfg.head_dim)
    tables = torch.arange(1, 1 + B * per_row,
                          dtype=torch.int32).reshape(B, per_row)
    return {"k_pages": torch.randn(shape, generator=g).bfloat16(),
            "v_pages": torch.randn(shape, generator=g).bfloat16(),
            "page_tables": tables,
            "lengths": torch.tensor([3, 9, 0, 12], dtype=torch.int32)}


def _tokens(cfg, seed, B=4, T=1):
    rng = np.random.default_rng(seed)
    return torch.tensor(rng.integers(0, cfg.vocab_size, (B, T)),
                        dtype=torch.int32)


def _clone(st):
    return {k: v.clone() for k, v in st.items()}


def _graphed(model):
    progs = ServePrograms(model, capture=StandIn)
    return progs, progs.for_engine()


# ------------------------------------------------------------ the keys
def test_one_capture_a_key_and_a_replay_a_repeat(port):
    """The first call of a key runs eagerly and captures; each repeat
    replays, into the same static output, with the eager program's
    tokens and pools; another width is another key."""
    cfg, model, params = port
    progs, g = _graphed(model)
    params = progs.prepare_params(params)
    st = _state(cfg, 0)
    outs = []
    for seed in (1, 2, 3):
        tok = _tokens(cfg, seed)
        want, want_st = progs.decode(params, _clone(st), tok)
        got, got_st = g.decode(params, st, tok)
        assert torch.equal(got, want)
        assert got_st is st
        for n in compiled.POOL_KEYS:
            assert torch.equal(st[n], want_st[n])
        outs.append(got)
    stats = progs.graph_stats
    assert stats.captures == {"decode": 1} and stats.replays == {"decode": 2}
    assert outs[1] is outs[2]               # the graph's static output
    assert outs[0] is not outs[1]           # the first call ran eagerly
    g.verify(params, st, _tokens(cfg, 4, T=5))
    g.verify(params, st, _tokens(cfg, 5, T=5))
    assert stats.captures == {"decode": 1, "verify": 1}
    assert stats.replays == {"decode": 2, "verify": 1}
    assert g.graphs() == {"decode": 1, "chunk": 0, "verify": 1, "fused": 0}


def test_a_replaced_pool_or_parameter_leaf_is_a_new_key(port):
    cfg, model, params = port
    progs, g = _graphed(model)
    params = progs.prepare_params(params)
    st = _state(cfg, 0)
    tok = _tokens(cfg, 1)
    g.decode(params, st, tok)
    g.decode(params, st, tok)
    assert progs.graph_stats.captures["decode"] == 1
    moved = {**st, "k_pages": st["k_pages"].clone()}
    want, _ = progs.decode(params, _clone(moved), tok)
    got, _ = g.decode(params, moved, tok)
    assert progs.graph_stats.captures["decode"] == 2
    assert torch.equal(got, want)
    leaf = params["layers"]["mix"]["wq"]
    other = {**params, "layers": {**params["layers"], "mix": {
        **params["layers"]["mix"], "wq": leaf.clone()}}}
    g.decode(other, st, tok)
    assert progs.graph_stats.captures["decode"] == 3
    # the first pool and leaves again: their graph replays
    g.decode(params, st, tok)
    assert progs.graph_stats.captures["decode"] == 3
    assert progs.graph_stats.replays["decode"] == 2


def test_two_engines_on_one_bundle_never_share_a_graph(port):
    """Each engine binds its own graphs and backend, every graph keyed
    on that engine's own pools."""
    cfg, model, params = port
    progs = ServePrograms(model, capture=StandIn)
    prompts = _prompts(cfg, 7, [16] * 6)
    engines = [ServeEngine(model, params, programs=progs, **FUSED_KW)
               for _ in range(2)]
    for e in engines:
        _drive(e, Request, prompts)
    a, b = (e.compiled for e in engines)
    assert a is not b and a.decode.backend is not b.decode.backend
    for e in engines:
        pools = {e.cache.k_pages.data_ptr(), e.cache.v_pages.data_ptr()}
        for p in (e.compiled.decode, e.compiled.chunk, e.compiled.fused):
            assert len(p) >= 1
            for key in p._graphs:
                assert {key[0][-2][0], key[0][-1][0]} == pools
    held = sum(sum(e.compiled.graphs().values()) for e in engines)
    assert sum(progs.graph_stats.captures.values()) == held
    assert a.graphs() == b.graphs()


def test_graphs_on_the_cpu_only_through_a_stand_in(port):
    cfg, model, params = port
    with pytest.raises(ValueError, match="CUDA"):
        ServePrograms(model, graphs=True)
    eager = ServePrograms(model)
    assert not eager.graphs and eager.for_engine() is eager
    assert ServePrograms(model, graphs=False).for_engine().graphs is False
    tp = TPServePrograms(model, devices=["cpu", "cpu"])
    assert tp.for_engine() is tp
    with pytest.raises(ValueError, match="CUDA"):
        compiled.CudaGraphs("cpu")


def test_a_failed_capture_raises(port):
    """No path carries on eagerly when a capture fails."""
    cfg, model, params = port
    progs = ServePrograms(model, capture=BrokenCapture)
    eng = ServeEngine(model, params, programs=progs, **FUSED_KW)
    with pytest.raises(RuntimeError, match="capture failed"):
        _drive(eng, Request, _prompts(cfg, 7, [16] * 6))


# ------------------------------------------- the engine on the graphs
@pytest.mark.parametrize("fused", [True, False])
def test_graphed_engine_equals_eager_and_the_reference(port, ref_counters,
                                                       ticking, fused):
    """The fused-step trace through the stand-in's graphs: streams,
    dispatch counters and pools equal the eager engine's, the kernels'
    launches too (each replay credited with its capture's rise), and
    the dispatch counters the JAX engine's."""
    cfg, model, params = port
    prompts = _prompts(cfg, 7, [16] * 6)
    kw = dict(FUSED_KW, fused=fused)
    runs = {}
    for graphs in (False, True):
        progs = ServePrograms(model, capture=StandIn if graphs else None)
        compiled.set_launch_counts(dict.fromkeys(compiled.launch_counts(),
                                                 0))
        eng = ServeEngine(model, params, programs=progs, **kw)
        counters = _drive(eng, Request, prompts)
        runs[graphs] = (eng, counters, compiled.launch_counts(),
                        progs.graph_stats)
    (e_eng, e_counters, e_launch, _), (g_eng, g_counters, g_launch,
                                       stats) = runs[False], runs[True]
    assert sum(stats.replays.values()) > 0
    assert set(stats.captures) == ({"chunk", "decode", "fused"} if fused
                                   else {"chunk", "decode"})
    assert {r.rid: r.generated for r in g_eng.finished} == \
        {r.rid: r.generated for r in e_eng.finished}
    assert g_counters == e_counters
    if fused:
        assert g_counters == ref_counters
        assert g_counters["n_total_dispatches"] == 14
    for n in compiled.POOL_KEYS:
        assert torch.equal(getattr(g_eng.cache, n)[:, 1:],
                           getattr(e_eng.cache, n)[:, 1:])
    assert g_launch == e_launch
    assert all(g_launch[(m.__name__, "launches")] > 0
               for m in (pa_ops, fa_ops, gd_ops))

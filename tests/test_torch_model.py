"""The port's model (``repro_torch.models.lm.DecoderLM``) and weight
bridge against the JAX reference on the qwen3 smoke config.

* The bridge and the checkpoint reader keep every bit.
* ``apply`` / ``prefill`` / ``decode_step`` and the four paged programs
  give logits close to the reference's on the same weights and inputs,
  with ``compute_dtype="float32"`` (a random-init bf16 model sits on
  argmax knife-edges), and the same greedy tokens.
* In bf16, inside the port and bit for bit: chunked prefill == whole
  prefill and the fused step == its two unfused halves.  (On this CPU,
  torch's bf16 matmul gives a row the same bits whatever the number of
  rows; its f32 matmul does not, so these checks run in bf16.)

The checks are functions of a reference smoke config (``check_*``);
``tests/test_torch_archs.py`` runs them on the other architectures the
port serves.  The reference starts norm scales and biases at constants
(0 or 1); ``reference`` perturbs them, seeded, so that each of their
code paths moves the logits.
"""
import dataclasses
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.checkpoint.ckpt import save_checkpoint
from repro.models import build_model
from repro_torch import configs
from repro_torch.checkpoint import (load_reference_checkpoint,
                                    params_from_jax, params_to_numpy)
from repro_torch.models.lm import DecoderLM
from repro_torch.serve.step import ServePrograms

ARCH = "qwen3-0.6b"


def share_cores() -> None:
    """Under pytest-xdist, give torch's CPU pool in each worker its share
    of the cores (ceil(cores / workers)) instead of every core: with 6
    workers of 8 threads each on 8 cores, the port's test files took
    about 2.8 times the worker time they take with 2 threads a worker
    (their junit, ``-n 6 --dist loadfile``, 8 cores).  A single pytest
    process keeps torch's default pool."""
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    if workers > 1:
        cores = len(os.sched_getaffinity(0))
        torch.set_num_threads(max(1, -(-cores // workers)))


def warm_torch_threads() -> None:
    """Have every thread of torch's CPU pool make its first call of the
    transcendental functions now, and drop the results.  torch's CPU
    ``exp`` on f32 runs MKL's VML, and a pool thread's *first* call now
    and then returns its share of the array at about 1.5e-4 relative
    error (a VML low-accuracy result) while other work keeps the cores
    busy: measured with torch 2.13 (CPU), 8 threads, a 2^20-element exp
    racing an XLA CPU matmul, 1 to 4 runs in 40; every later call of
    the same thread was exact, and under ``MKL_CBWR=COMPATIBLE`` no run
    in 40 was off.  So the first call is made here, where its value is
    not used: this module is imported by every test process (pytest's
    workers collect it), and ``test_torch_plans.py`` imports it."""
    x = torch.linspace(-4.0, 4.0, 1 << 20)
    for fn in (torch.exp, torch.log1p, torch.tanh, torch.sin, torch.cos,
               torch.sigmoid):
        fn(x)


share_cores()
warm_torch_threads()
# f32 logits of the contiguous path: both sides compute in f32 and keep
# an f32 cache; they differ only in summation order (attention tiles,
# matmul blocking), a few f32 ulps per op over 2 layers.
CONTIG_TOL = 1e-4
# paged programs at f32 compute: K/V are stored in bf16 pages on both
# sides and p is rounded to bf16 before P.V (the page dtype), after an
# exact softmax in the reference and an online one in the port, so a
# K/V or p value can land one bf16 ulp (2^-8 relative) apart.  The
# error is relative to the logits' scale: an untied fan-in head gives
# logits ~6x those of a tied 0.02-normal table, so the tolerance is
# PAGED_TOL times the largest |logit| where that exceeds 1.  (With f32
# pages on both sides the same programs agree to ~2e-6.)
PAGED_TOL = 1e-2

#: leaves the reference initializes to a constant
_CONST_LEAVES = {"scale", "bias", "bq", "bk", "bv", "b1", "b2", "q_norm",
                 "k_norm"}


def _f32(cfg):
    return dataclasses.replace(cfg, compute_dtype="float32")


def with_capacity(cfg, capacity_factor: float):
    """An MoE config (either package's) at another capacity factor."""
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=capacity_factor))


def to_port_config(jcfg):
    """The port's ModelConfig with every field of the reference's."""
    fields = {f.name: getattr(jcfg, f.name)
              for f in dataclasses.fields(configs.ModelConfig)}
    if jcfg.moe is not None:
        fields["moe"] = configs.MoEConfig(**dataclasses.asdict(jcfg.moe))
    return configs.ModelConfig(**fields)


def _perturb(tree, rng):
    return {k: (_perturb(v, rng) if isinstance(v, dict)
                else (v + 0.1 * rng.standard_normal(v.shape).astype(v.dtype)
                      ).astype(v.dtype)
                if k in _CONST_LEAVES else v)
            for k, v in sorted(tree.items())}


@functools.lru_cache(maxsize=None)
def reference(jcfg):
    """(config, params, the params in numpy) of the reference model of
    ``jcfg`` from PRNGKey(0), its constant leaves perturbed."""
    tree = jax.tree.map(np.asarray,
                        build_model(jcfg).init(jax.random.PRNGKey(0)))
    tree = _perturb(tree, np.random.default_rng(0))
    return jcfg, jax.tree.map(jnp.asarray, tree), tree


@pytest.fixture(scope="module")
def ref():
    """Reference model + params, and the same params in numpy."""
    return reference(jconfigs.get_smoke(ARCH))


def _port(ref, dtype="float32"):
    cfg = dataclasses.replace(to_port_config(ref[0]), compute_dtype=dtype)
    model = DecoderLM(cfg, device="cpu")
    return model, params_from_jax(ref[2], cfg, device="cpu")


def _close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


def _tokens(seed, shape, vocab):
    return np.random.default_rng(seed).integers(
        0, vocab, size=shape).astype(np.int32)


# ------------------------------------------------------------ bridge
def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], prefix + (k,))
    else:
        yield prefix, tree


def check_bridge(jcfg):
    ref = reference(jcfg)
    back = params_to_numpy(params_from_jax(ref[2], to_port_config(jcfg),
                                           device="cpu"))
    want = dict(_leaves(ref[2]))
    got = dict(_leaves(back))
    assert got.keys() == want.keys()
    for path, arr in want.items():
        assert got[path].dtype == arr.dtype, path
        np.testing.assert_array_equal(got[path], arr, err_msg=str(path))


def test_bridge_is_bit_identical(ref):
    check_bridge(ref[0])


def test_bridge_rejects_mismatched_tree(ref):
    cfg = configs.get_smoke(ARCH)
    tree = jax.tree.map(lambda a: a, ref[2])
    tree["layers"]["mix"]["wq"] = tree["layers"]["mix"]["wq"][:, :, :8]
    with pytest.raises(ValueError, match="wq"):
        params_from_jax(tree, cfg, device="cpu")
    del tree["final_norm"]
    with pytest.raises(ValueError, match="leaves"):
        params_from_jax(tree, cfg, device="cpu")


def test_reference_checkpoint_reader_round_trips_bf16(tmp_path, ref):
    rng = np.random.default_rng(0)
    tree = {"params": ref[1],
            "extra": {"bf": jnp.asarray(rng.standard_normal((5, 7)),
                                        jnp.bfloat16),
                      "i": jnp.arange(4, dtype=jnp.int32)}}
    save_checkpoint(tmp_path, 3, tree)
    got, step = load_reference_checkpoint(tmp_path, device="cpu")
    assert step == 3
    bf = got["extra"]["bf"]
    assert bf.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        bf.view(torch.uint16).numpy(),
        np.asarray(tree["extra"]["bf"]).view(np.uint16))
    np.testing.assert_array_equal(got["extra"]["i"].numpy(), np.arange(4))
    params = params_from_jax(
        jax.tree.map(lambda t: t.numpy(), got["params"]),
        configs.get_smoke(ARCH), device="cpu")
    for (p, a), (_, b) in zip(_leaves(params_to_numpy(params)),
                              _leaves(ref[2])):
        np.testing.assert_array_equal(a, b, err_msg=str(p))


def test_n_params_and_init_distributions():
    for arch_cfg in (configs.get_smoke(ARCH), configs.get(ARCH)):
        want = (jconfigs.get_smoke(ARCH) if arch_cfg.n_layers == 2
                else jconfigs.get(ARCH)).n_params()
        assert arch_cfg.n_params() == want
    cfg = configs.get_smoke(ARCH)
    p = DecoderLM(cfg, device="cpu").init(seed=0)
    L, d = cfg.n_layers, cfg.d_model
    assert p["layers"]["mix"]["wq"].dtype == torch.float32
    # fan_in of a layer-stacked weight counts the layer axis, as the
    # reference's models/base.py:fan_in does
    std = float(p["layers"]["mix"]["wq"].std())
    assert abs(std * np.sqrt(L * d) - 1) < 0.05
    assert abs(float(p["embed"]["tok"].std()) / 0.02 - 1) < 0.05
    for k in ("ln1", "ln2"):
        assert not p["layers"][k]["scale"].any()
    assert not p["layers"]["mix"]["q_norm"].any()
    again = DecoderLM(cfg, device="cpu").init(seed=0)
    assert torch.equal(again["layers"]["ffn"]["wd"], p["layers"]["ffn"]["wd"])


# -------------------------------------------------- contiguous path
def check_contiguous_path(jcfg):
    ref = reference(jcfg)
    jmodel = build_model(_f32(jcfg))
    model, params = _port(ref)
    toks = _tokens(1, (2, 21), jcfg.vocab_size)
    want, _ = jax.jit(lambda p, b: jmodel.apply(p, b, train=False))(
        ref[1], {"tokens": jnp.asarray(toks)})
    got = model.apply(params, torch.from_numpy(toks))
    _close(got, want, CONTIG_TOL)
    assert np.array_equal(got.argmax(-1).numpy(),
                          np.asarray(jnp.argmax(want, -1)))

    jlast, jcache = jax.jit(lambda p, b: jmodel.prefill(p, b, max_len=26))(
        ref[1], {"tokens": jnp.asarray(toks)})
    last, cache = model.prefill(params, torch.from_numpy(toks), max_len=26)
    _close(last, jlast, CONTIG_TOL)
    tok = np.array(jnp.argmax(jlast, -1), np.int32)[:, None]
    jdecode = jax.jit(jmodel.decode_step)
    for _ in range(4):
        jlog, jcache = jdecode(ref[1], jcache, jnp.asarray(tok))
        log, cache = model.decode_step(params, cache, torch.from_numpy(tok))
        _close(log, jlog, CONTIG_TOL)
        tok = np.array(jnp.argmax(jlog, -1), np.int32)[:, None]
        assert np.array_equal(log.argmax(-1).numpy(), tok[:, 0])


def test_apply_prefill_decode_match_reference(ref):
    check_contiguous_path(ref[0])


# ------------------------------------------------------- paged path
def _paged_state(cfg, rng, B, n_pages=24, ps=8, width=6):
    shape = (cfg.n_layers, n_pages, ps, cfg.n_kv_heads, cfg.head_dim)
    k = rng.standard_normal(shape).astype(np.float32)
    v = rng.standard_normal(shape).astype(np.float32)
    tables = np.zeros((B, width), np.int32)
    tables[:, :3] = rng.permutation(np.arange(1, n_pages))[:B * 3] \
        .reshape(B, 3)
    return k, v, tables


def _both_states(k, v, tables, lengths):
    jst = {"k_pages": jnp.asarray(k, jnp.bfloat16),
           "v_pages": jnp.asarray(v, jnp.bfloat16),
           "page_tables": jnp.asarray(tables),
           "lengths": jnp.asarray(lengths)}
    tst = {"k_pages": torch.from_numpy(k).bfloat16(),
           "v_pages": torch.from_numpy(v).bfloat16(),
           "page_tables": torch.from_numpy(tables),
           "lengths": torch.from_numpy(lengths)}
    return jst, tst


def _close_paged(got, want):
    _close(got, want, PAGED_TOL * max(1.0, float(np.abs(want).max())))


def _close_pages(tst, jst):
    for n in ("k_pages", "v_pages"):
        _close(tst[n], jst[n], PAGED_TOL)


def check_paged_programs(jcfg):
    ref = reference(jcfg)
    jcfg = _f32(jcfg)
    jmodel = build_model(jcfg)
    model, params = _port(ref)
    rng = np.random.default_rng(2)
    B, T, C = 3, 4, 8
    k, v, tables = _paged_state(jcfg, rng, B)
    lengths = np.asarray([5, 13, 0], np.int32)
    V = jcfg.vocab_size

    # chunked prefill: ragged starts and valid counts, one inactive row
    starts = np.asarray([0, 8, 0], np.int32)
    n_valid = np.asarray([8, 5, 0], np.int32)
    ptoks = _tokens(3, (B, C), V)
    jst, tst = _both_states(k, v, tables, lengths)
    jl, jst = jax.jit(jmodel.prefill_chunk_paged)(
        ref[1], jst, jnp.asarray(ptoks), jnp.asarray(tables[:, :2]),
        jnp.asarray(starts), jnp.asarray(n_valid))
    tl, tst = model.prefill_chunk_paged(
        params, tst, torch.from_numpy(ptoks),
        torch.from_numpy(tables[:, :2].copy()), torch.from_numpy(starts),
        torch.from_numpy(n_valid))
    _close_paged(tl[:2], jl[:2])
    assert np.array_equal(tl[:2].argmax(-1).numpy(),
                          np.asarray(jnp.argmax(jl[:2], -1)))
    _close_pages(tst, jst)

    # decode (T = 1) and verify (T = 4)
    for width in (1, T):
        dtoks = _tokens(4 + width, (B, width), V)
        jst, tst = _both_states(k, v, tables, lengths)
        if width == 1:
            jl, jst = jax.jit(jmodel.decode_step_paged)(
                ref[1], jst, jnp.asarray(dtoks))
            tl, tst = model.decode_step_paged(params, tst,
                                              torch.from_numpy(dtoks))
        else:
            jl, jst = jax.jit(jmodel.verify_step_paged)(
                ref[1], jst, jnp.asarray(dtoks))
            tl, tst = model.verify_step_paged(params, tst,
                                              torch.from_numpy(dtoks))
        _close_paged(tl, jl)
        assert np.array_equal(tl.argmax(-1).numpy(),
                              np.asarray(jnp.argmax(jl, -1)))
        _close_pages(tst, jst)

    # fused: decode rows 0-1 (row 2 masked out), prefill row 2
    dtoks = _tokens(9, (B, T), V)
    dtables = tables.copy()
    dtables[2] = 0
    dlen = lengths.copy()
    dlen[2] = 0
    ptab = np.zeros((1, 2), np.int32)
    ptab[0] = tables[2, :2]
    ptoks = _tokens(10, (1, C), V)
    jst, tst = _both_states(k, v, dtables, dlen)
    (jd, jp), jst = jax.jit(jmodel.fused_step_paged)(
        ref[1], jst, jnp.asarray(dtoks), jnp.asarray(ptoks),
        jnp.asarray(ptab), jnp.asarray([0], jnp.int32),
        jnp.asarray([6], jnp.int32))
    (td, tp), tst = model.fused_step_paged(
        params, tst, torch.from_numpy(dtoks), torch.from_numpy(ptoks),
        torch.from_numpy(ptab), torch.tensor([0], dtype=torch.int32),
        torch.tensor([6], dtype=torch.int32))
    _close_paged(td[:2], jd[:2])
    _close_paged(tp, jp)
    assert np.array_equal(td[:2].argmax(-1).numpy(),
                          np.asarray(jnp.argmax(jd[:2], -1)))
    _close_pages(tst, jst)


def test_paged_programs_match_reference(ref):
    check_paged_programs(ref[0])


# ------------------------------------- bitwise invariants in the port
def check_chunked_prefill_equals_whole(jcfg):
    model, params = _port(reference(jcfg), "bfloat16")
    cfg = model.cfg
    ps, C = 8, 16
    a = torch.from_numpy(_tokens(11, (40,), cfg.vocab_size))
    b = torch.from_numpy(_tokens(12, (13,), cfg.vocab_size))
    want_a, cache_a = model.prefill(params, a[None])
    want_b, _ = model.prefill(params, b[None])
    L, KVH, Dh = cfg.n_layers, cfg.n_kv_heads, cfg.head_dim
    state = {n: torch.zeros(L, 16, ps, KVH, Dh, dtype=torch.bfloat16)
             for n in ("k_pages", "v_pages")}
    table_a = torch.tensor([1, 2, 3, 4, 5], dtype=torch.int32)
    table_b = torch.tensor([6, 7], dtype=torch.int32)
    # row a ingests 16 + 16 + 8 tokens; row b's whole prompt co-ingests
    # with a's first chunk, under a wider context bucket than it needs
    for start, (na, nb_) in zip((0, 16, 32), ((16, 13), (16, 0), (8, 0))):
        width = 8 if start == 0 else 4 * (1 + start // 16)
        toks = torch.zeros(2, C, dtype=torch.int32)
        toks[0, :na] = a[start:start + na]
        toks[1, :nb_] = b[:nb_]
        rows = torch.zeros(2, width, dtype=torch.int32)
        rows[0, :min(5, width)] = table_a[:min(5, width)]
        if nb_:
            rows[1, :2] = table_b
        logits, state = model.prefill_chunk_paged(
            params, state, toks, rows,
            torch.tensor([start, 0], dtype=torch.int32),
            torch.tensor([na, nb_], dtype=torch.int32))
        if start == 0:
            assert torch.equal(logits[1], want_b[0])
    assert torch.equal(logits[0], want_a[0])
    pages = state["k_pages"][:, table_a.long()].reshape(L, 40, KVH, Dh)
    assert torch.equal(pages, torch.stack(
        [c["kv"]["k"][0] for c in cache_a["layers"]]))


def test_chunked_prefill_equals_whole_prefill_bitwise(ref):
    check_chunked_prefill_equals_whole(ref[0])


def check_fused_equals_unfused(jcfg):
    model, params = _port(reference(jcfg), "bfloat16")
    progs = ServePrograms(model)
    params = progs.prepare_params(params)
    cfg = model.cfg
    rng = np.random.default_rng(5)
    k, v, tables = _paged_state(cfg, rng, 3)
    dtables = tables.copy()
    dtables[2] = 0
    lengths = np.asarray([7, 15, 0], np.int32)
    dtoks = torch.from_numpy(_tokens(6, (3, 3), cfg.vocab_size))
    ptoks = torch.from_numpy(_tokens(7, (2, 8), cfg.vocab_size))
    ptab = torch.zeros(2, 2, dtype=torch.int32)
    ptab[0] = torch.from_numpy(tables[2, :2])
    pst = torch.tensor([0, 0], dtype=torch.int32)
    pnv = torch.tensor([7, 0], dtype=torch.int32)

    _, fused = _both_states(k, v, dtables, lengths)
    (fd, fp), fused = model.fused_step_paged(params, fused, dtoks, ptoks,
                                             ptab, pst, pnv)
    for order in ("prefill-first", "decode-first"):
        _, st = _both_states(k, v, dtables, lengths)
        if order == "decode-first":
            d, st = model.verify_step_paged(params, st, dtoks)
        p, st = model.prefill_chunk_paged(params, st, ptoks, ptab, pst, pnv)
        if order == "prefill-first":
            d, st = model.verify_step_paged(params, st, dtoks)
        assert torch.equal(d[:2], fd[:2]), order
        assert torch.equal(p[0], fp[0]), order
        for n in ("k_pages", "v_pages"):
            # page 0 is the null page: masked writes of both groups
            assert torch.equal(st[n][:, 1:], fused[n][:, 1:]), (order, n)


def test_fused_step_equals_unfused_bitwise(ref):
    check_fused_equals_unfused(ref[0])

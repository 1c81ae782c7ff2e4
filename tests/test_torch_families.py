"""The families the reference runs on its contiguous-cache (lockstep) path
only — deepseek-moe-16b (a leading dense layer before the MoE stack),
qwen2-vl-7b (M-RoPE, patch-embedding stub), whisper-tiny
(encoder-decoder), recurrentgemma-2b (RG-LRU, ring-buffer local
attention, scaled embeddings, soft-capped logits) and rwkv6-3b (WKV) —
against the JAX package on their smoke configs, and the pieces they
brought into the port: the projection helper ``components.linear``,
flash attention with a sliding window and at Dh 256, paged attention at
Dh 256.

* The port's config copies equal the reference's; the bridge keeps
  every bit (``dense_layer_0``, unscanned ``layer_NN``, ``enc_NN`` /
  ``dec_NN``, RG-LRU and RWKV leaves).
* In f32 on the reference's synthetic batch (frames, patch embeddings
  and M-RoPE positions included): ``apply``, ``prefill`` and
  ``decode_step`` logits within CONTIG_TOL of the reference's, and
  ``greedy_generate`` gives the reference's tokens.
* In bf16, inside the port: decode extends prefill, the reference's
  own check (``tests/test_smoke_archs.py``, 4e-2).
* The ``--naive`` launcher serves each family; the engine refuses them.
* One decode step sends every projection through ``linear``.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.data.pipeline import SyntheticPipeline
from repro.kernels.paged_attention.ref import paged_attention_ref
from repro.models import build_model as jbuild
from repro.models.components import flash_attention as jax_flash
from repro.models.components import local_attention as jax_local
from repro.serve.step import greedy_generate as jgreedy
from repro_torch import configs
from repro_torch.checkpoint import params_from_jax
from repro_torch.kernels.flash_attention import flash_attention_plain
from repro_torch.kernels.paged_attention import paged_attention_plain
from repro_torch.launch import serve as launch
from repro_torch.models import build_model
from repro_torch.models import components as C
from repro_torch.models.base import flatten_specs
from repro_torch.serve import ServeEngine, ServePrograms, greedy_generate
from repro_torch.serve.step import projection_cast
from test_torch_model import (CONTIG_TOL, _leaves, check_bridge, reference,
                              to_port_config)

FAMILIES = ("deepseek-moe-16b", "qwen2-vl-7b", "whisper-tiny",
            "recurrentgemma-2b", "rwkv6-3b")
#: prompt batch of the model-level checks (S a multiple of the smoke
#: recurrentgemma's 16-key window, the reference's local-attention
#: contract), and decode steps
B, S, GEN = 2, 32, 4
#: the reference's decode-extends-prefill tolerance (bf16 compute)
EXTEND_TOL = 4e-2
#: an MoE capacity with no drops, as the reference's own check sets it
NO_DROP = 64.0


def _jcfg(arch, dtype="float32", no_drop=False):
    jcfg = dataclasses.replace(jconfigs.get_smoke(arch), compute_dtype=dtype)
    if no_drop and jcfg.moe is not None:
        jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(
            jcfg.moe, capacity_factor=NO_DROP))
    return jcfg


def _port(arch, dtype="float32", no_drop=False):
    """The port's model of ``_jcfg(arch, dtype, no_drop)`` on the CPU
    with the reference's (perturbed) weights, which depend on neither."""
    cfg = to_port_config(_jcfg(arch, dtype, no_drop))
    return build_model(cfg, device="cpu"), params_from_jax(
        reference(_jcfg(arch))[2], cfg, device="cpu")


def _batches(jcfg, seq=S):
    """The reference's synthetic batch (labels dropped) for both
    packages."""
    nb = SyntheticPipeline(jcfg, batch=B, seq=seq).device_batch(0)
    nb = {k: np.asarray(v.astype(jnp.float32)) if v.dtype != jnp.int32
          else np.asarray(v) for k, v in nb.items() if k != "labels"}
    return ({k: jnp.asarray(v) for k, v in nb.items()},
            {k: torch.from_numpy(v.copy()) for k, v in nb.items()})


def _close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("arch", FAMILIES)
def test_configs_equal_reference(arch):
    assert configs.get(arch) == to_port_config(jconfigs.get(arch))
    assert configs.get_smoke(arch) == to_port_config(jconfigs.get_smoke(arch))
    assert configs.get(arch).n_params() == jconfigs.get(arch).n_params()


@pytest.mark.parametrize("arch", FAMILIES)
def test_bridge_is_bit_identical(arch):
    check_bridge(_jcfg(arch))


@pytest.mark.parametrize("arch", FAMILIES)
def test_synthetic_batch_matches_reference(arch):
    cfg = configs.get_smoke(arch)
    want = SyntheticPipeline(jconfigs.get_smoke(arch), batch=B,
                             seq=S).device_batch(0)
    got = launch.synthetic_batch(cfg, B, S, device="cpu")
    assert set(got) == set(want) - {"labels"}
    for k, t in got.items():
        w = np.asarray(want[k].astype(jnp.float32))
        np.testing.assert_array_equal(t.float().numpy(), w, err_msg=k)


@pytest.mark.parametrize("arch", FAMILIES)
def test_apply_prefill_decode_match_reference(arch):
    jcfg = _jcfg(arch)
    jmodel = jbuild(jcfg)
    jparams = reference(jcfg)[1]
    model, params = _port(arch)
    jb, tb = _batches(jcfg)
    want, _ = jax.jit(lambda p, b: jmodel.apply(p, b, train=False))(
        jparams, jb)
    _close(model.apply(params, tb), want, CONTIG_TOL)
    jlast, jcache = jax.jit(lambda p, b: jmodel.prefill(
        p, b, max_len=S + GEN))(jparams, jb)
    last, cache = model.prefill(params, tb, max_len=S + GEN)
    _close(last, jlast, CONTIG_TOL)
    tok = np.array(jnp.argmax(jlast, -1), np.int32)[:, None]
    jdecode = jax.jit(jmodel.decode_step)
    for _ in range(GEN - 1):
        jlog, jcache = jdecode(jparams, jcache, jnp.asarray(tok))
        log, cache = model.decode_step(params, cache, torch.from_numpy(tok))
        _close(log, jlog, CONTIG_TOL)
        tok = np.array(jnp.argmax(jlog, -1), np.int32)[:, None]
        assert np.array_equal(log.argmax(-1).numpy(), tok[:, 0])


@pytest.mark.parametrize("arch", FAMILIES)
def test_greedy_tokens_equal_reference(arch):
    jcfg = _jcfg(arch)
    model, params = _port(arch)
    jb, tb = _batches(jcfg)
    want = jgreedy(jbuild(jcfg), reference(jcfg)[1], jb, 2 * GEN,
                   cache_len=S + 2 * GEN)
    got = greedy_generate(model, params, tb, 2 * GEN, cache_len=S + 2 * GEN)
    assert np.array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("arch", FAMILIES)
def test_decode_extends_prefill(arch):
    """decode(prefill(x), t) == apply(x + t)[S] in bf16, as the
    reference's ``test_decode_step_extends_consistently``: the forward is
    padded to a window multiple (causality makes the padding irrelevant
    to the logits at S)."""
    model, params = _port(arch, "bfloat16", no_drop=True)
    _, tb = _batches(model.cfg)
    nxt = tb["tokens"][:, -1:]
    pad = 32
    ext = dict(tb, tokens=torch.cat([tb["tokens"], nxt.repeat(1, pad)], 1))
    if "mrope_positions" in tb:
        mp = tb["mrope_positions"]
        extra = mp[:, :, -1:] + 1 + torch.arange(pad)[None, None]
        ext["mrope_positions"] = torch.cat([mp, extra], 2)
    _, cache = model.prefill(params, tb, max_len=S + 8)
    got, _ = model.decode_step(params, cache, nxt)
    want = model.apply(params, ext)[:, S]
    _close(got, want.numpy(), EXTEND_TOL)


@pytest.mark.parametrize("arch", FAMILIES)
def test_naive_launcher_serves_and_engine_refuses(arch, capsys):
    stats = launch.main(["--arch", arch, "--smoke", "--device", "cpu",
                         "--naive", "--batch", "2", "--prompt-len", "16",
                         "--gen", "4"])
    assert stats["tokens"].shape == (2, 4)
    assert "decoded 4 tokens/seq" in capsys.readouterr().out
    model = build_model(configs.get_smoke(arch), device="cpu")
    assert not model.supports_paged_decode()
    with pytest.raises(ValueError, match="paged decode unsupported"):
        ServeEngine(model, model.init(seed=0))


def _product_weights(model, params):
    """{(data_ptr, shape): path} of every weight that enters a product
    through ``linear``: 2D projections (per layer of a stacked stack),
    routers, RWKV6's per-slice token-mix maps; not the experts' batched
    weights or the embedding."""
    out = {}

    def add(t, path):
        out[(t.data_ptr(), tuple(t.shape))] = path
    for path, spec in flatten_specs(model.param_specs()):
        if path[0] == "embed" or len(spec.init_shape) < 2:
            continue
        name = path[-1]
        if name in ("conv_w", "u", "ln_x_scale", "ln_x_bias"):
            continue
        t = params
        for k in path:
            t = t[k]
        stacked = path[0] == "layers"
        views = list(t) if stacked else [t]
        for i, w in enumerate(views):
            if name == "tm_w2":
                for j, s in enumerate(w):
                    add(s, path + (i, j))
            elif w.dim() == 2:
                add(w, path + ((i,) if stacked else ()))
    return out


@pytest.mark.parametrize("arch", FAMILIES)
def test_decode_step_sends_every_projection_through_linear(arch,
                                                          monkeypatch):
    model, params = _port(arch, no_drop=True)
    _, tb = _batches(model.cfg)
    seen = []
    linear = C.linear

    def recording(x, w, bias=None, **kw):
        seen.append((w.data_ptr(), tuple(w.shape)))
        return linear(x, w, bias, **kw)
    monkeypatch.setattr(C, "linear", recording)
    _, cache = model.prefill(params, tb, max_len=S + 1)
    at_prefill = set(seen)
    seen.clear()
    model.decode_step(params, cache, tb["tokens"][:, -1:])
    want = _product_weights(model, params)
    assert set(seen) <= set(want)
    # whisper: the encoder and the cross-attention K/V run once, at
    # prefill; every other product runs in each decode step
    once = {k for k, path in want.items()
            if path[0].startswith("enc_")
            or (path[1:2] == ("cross_attn",) and path[2] in ("wk", "wv"))}
    assert set(seen) == set(want) - once
    assert once <= at_prefill
    n_decode = sum(1 for k, p in want.items() if k not in once)
    assert len(seen) == n_decode          # one call per weight


def test_linear_matches_matmul_and_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 5, 48)).astype(np.float32)
    w = rng.standard_normal((48, 40)).astype(np.float32)
    b = rng.standard_normal(40).astype(np.float32)
    tx, tw, tb = (torch.from_numpy(a) for a in (x, w, b))
    got = C.linear(tx, tw, tb)
    assert torch.equal(got, tx @ tw + tb)
    np.testing.assert_allclose(got.numpy(), np.asarray(
        jnp.asarray(x) @ jnp.asarray(w) + jnp.asarray(b)), rtol=1e-5,
        atol=1e-5)
    # bf16: the product in bf16, then the bias in bf16 (the reference's
    # order in _project_qkv)
    xb = tx.bfloat16()
    assert torch.equal(C.linear(xb, tw, tb),
                       xb @ tw.bfloat16() + tb.bfloat16())


def test_init_cast_equals_prepare_params():
    model = build_model(configs.get_smoke("rwkv6-3b"), device="cpu")
    cast = model.init(seed=3, cast=projection_cast(torch.bfloat16))
    want = ServePrograms(model).prepare_params(model.init(seed=3))
    got, ref = dict(_leaves(cast)), dict(_leaves(want))
    assert got.keys() == ref.keys()
    for k, t in ref.items():
        assert got[k].dtype == t.dtype and torch.equal(got[k], t), k
    # the f32 products stay f32; the projections are bf16
    assert ref[("layers", "mix", "wd1")].dtype == torch.float32
    assert ref[("layers", "mix", "wr")].dtype == torch.bfloat16
    rg = build_model(configs.get_smoke("recurrentgemma-2b"), device="cpu")
    p = ServePrograms(rg).prepare_params(rg.init(seed=0))
    assert p["layer_00"]["mix"]["wr"].dtype == torch.float32
    assert p["layer_00"]["mix"]["w_in"].dtype == torch.bfloat16
    assert p["layer_02"]["mix"]["wq"].dtype == torch.bfloat16


# ------------------------------------------------------------ kernels
def _rand(rng, shape):
    return rng.standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("dh,window,skv", [(256, 16, 48), (64, 7, 40),
                                           (256, None, 33)])
def test_flash_plain_window_and_dh256_match_reference(dh, window, skv):
    """The plain flash version with a sliding window and at Dh 256
    against the reference's ``flash_attention(window=...)`` (causal, and
    non-causal over a ragged Skv for whisper's cross-attention), in f32;
    with S % window == 0 also against ``local_attention``."""
    rng = np.random.default_rng(dh + (window or 0))
    H, KVH = 4, 1
    causal = window is not None
    sq = skv if causal else 5
    q = _rand(rng, (2, sq, H, dh))
    k, v = _rand(rng, (2, skv, KVH, dh)), _rand(rng, (2, skv, KVH, dh))
    got = flash_attention_plain(*(torch.from_numpy(a) for a in (q, k, v)),
                                q_offset=0, causal=causal, window=window)
    want = jax.jit(functools.partial(
        jax_flash, causal=causal, window=window, kv_chunk=16))(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)
    if causal and skv % window == 0:
        loc = jax.jit(functools.partial(jax_local, window=window))(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
        np.testing.assert_allclose(got.numpy(), np.asarray(loc), rtol=2e-5,
                                   atol=2e-5)


def test_paged_plain_dh256_ring_matches_reference():
    """Paged attention at Dh 256 over a ring of 48 slots viewed as one
    page a row (recurrentgemma's decode), against
    ``paged_attention_ref``."""
    rng = np.random.default_rng(5)
    Bq, W, H, KVH, dh = 3, 48, 10, 1, 256
    q = _rand(rng, (Bq, 1, H, dh))
    kp, vp = _rand(rng, (Bq, W, KVH, dh)), _rand(rng, (Bq, W, KVH, dh))
    lengths = np.asarray([48, 20, 1], np.int32)       # attendable keys
    tables = np.arange(Bq, dtype=np.int32)[:, None]
    got = paged_attention_plain(
        torch.from_numpy(q), torch.from_numpy(kp), torch.from_numpy(vp),
        torch.from_numpy(tables), torch.from_numpy(lengths - 1))
    want = jax.jit(paged_attention_ref)(
        jnp.asarray(q[:, 0]), jnp.asarray(kp), jnp.asarray(vp),
        jnp.asarray(tables), jnp.asarray(lengths))
    np.testing.assert_allclose(got[:, 0].numpy(), np.asarray(want),
                               rtol=2e-5, atol=2e-5)


def test_row_sum_is_a_sum_over_any_dim():
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (3, 5, 7)).astype(np.float32))
    for dim in (0, 1, 2, -1, -2):
        np.testing.assert_allclose(C.row_sum(x, dim).numpy(),
                                   x.sum(dim, keepdim=True).numpy(),
                                   rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("pos", [20, 47, 100])
def test_flash_decode_attention_on_a_ring_gives_the_prefill_row(pos):
    """The query at ``pos`` against a ring of W slots (slot = position %
    W) gives the bits of row ``pos`` of a windowed prefill over every
    position, wrapped (47, 100) or not (20)."""
    rng = np.random.default_rng(pos)
    W, H, KVH, Dh = 32, 4, 1, 16
    k = torch.from_numpy(_rand(rng, (2, pos + 1, KVH, Dh))).bfloat16()
    v = torch.from_numpy(_rand(rng, (2, pos + 1, KVH, Dh))).bfloat16()
    q = torch.from_numpy(_rand(rng, (2, pos + 1, H, Dh))).bfloat16()
    ring_k = torch.zeros(2, W, KVH, Dh, dtype=torch.bfloat16)
    ring_v = torch.zeros_like(ring_k)
    for p in range(max(0, pos + 1 - W), pos + 1):
        ring_k[:, p % W], ring_v[:, p % W] = k[:, p], v[:, p]
    got = C.flash_decode_attention(q[:, pos:], ring_k, ring_v, pos,
                                   window=W)
    want = flash_attention_plain(q, k, v, causal=True, window=W)[:, pos:]
    assert torch.equal(got, want)


def test_wkv_scan_matches_reference_chunked_form():
    """The port's step-by-step WKV over a prompt against the reference's
    chunked-parallel form, in f32 (S = 40: a ragged chunking there)."""
    from repro.models.rwkv6 import wkv_chunked
    from repro_torch.models.rwkv6 import wkv_scan
    rng = np.random.default_rng(3)
    B, S, H, Dh = 2, 40, 3, 8
    r, k, v = (_rand(rng, (B, S, H, Dh)) for _ in range(3))
    lw = -np.exp(np.minimum(_rand(rng, (B, S, H, Dh)) - 2.0, 1.0))
    u = _rand(rng, (H, Dh))
    o, st = wkv_scan(*(torch.from_numpy(a) for a in (r, k, v, lw, u)))
    jo, jst = jax.jit(wkv_chunked)(*(jnp.asarray(a)
                                     for a in (r, k, v, lw, u)))
    np.testing.assert_allclose(o.numpy(), np.asarray(jo), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(st.numpy(), np.asarray(jst), rtol=1e-4,
                               atol=1e-4)


def test_wkv_chunked_matches_reference():
    """The port's chunked-parallel WKV (``parallel=True``) against the
    reference's, in f32, at S = 64 (two chunks of 32) and S = 40 (a
    ragged chunking: chunks of 20)."""
    from repro.models.rwkv6 import wkv_chunked as jax_chunked
    from repro_torch.models.rwkv6 import wkv_chunked
    rng = np.random.default_rng(4)
    for S in (64, 40):
        B, H, Dh = 2, 3, 8
        r, k, v = (_rand(rng, (B, S, H, Dh)) for _ in range(3))
        lw = -np.exp(np.minimum(_rand(rng, (B, S, H, Dh)) - 2.0, 1.0))
        u = _rand(rng, (H, Dh))
        o, st = wkv_chunked(*(torch.from_numpy(a) for a in (r, k, v, lw, u)))
        jo, jst = jax.jit(jax_chunked)(*(jnp.asarray(a)
                                         for a in (r, k, v, lw, u)))
        np.testing.assert_allclose(o.numpy(), np.asarray(jo), rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(st.numpy(), np.asarray(jst), rtol=1e-5,
                                   atol=1e-5)


@pytest.mark.parametrize("S", [1, 33, 64])
def test_rglru_scan_and_steps_match_reference(S):
    """The port's associative RG-LRU scan over a prompt, and its decode
    step applied token by token, against the reference's
    ``lax.associative_scan``, in f32: outputs and final state."""
    from repro.models.rglru import rglru_scan as jax_scan
    from repro_torch.models.rglru import rglru_scan, rglru_step
    rng = np.random.default_rng(S)
    Wd = 16
    p = {"wr": _rand(rng, (Wd, Wd)) / 4, "br": _rand(rng, (Wd,)),
         "wi": _rand(rng, (Wd, Wd)) / 4, "bi": _rand(rng, (Wd,)),
         "lam": rng.uniform(0.38, 0.8, Wd).astype(np.float32)}
    x = _rand(rng, (2, S, Wd))
    jh, jlast = jax.jit(jax_scan)({k: jnp.asarray(a) for k, a in p.items()},
                                  jnp.asarray(x))
    tp = {k: torch.from_numpy(a) for k, a in p.items()}
    tx = torch.from_numpy(x)
    h, last = rglru_scan(tp, tx)
    steps, hs = [], torch.zeros(2, Wd)
    for t in range(S):
        o, hs = rglru_step(tp, tx[:, t:t + 1], hs)
        steps.append(o)
    for got, got_last in ((h, last), (torch.cat(steps, 1), hs)):
        np.testing.assert_allclose(got.numpy(), np.asarray(jh), rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(got_last.numpy(), np.asarray(jlast),
                                   rtol=1e-5, atol=1e-5)


def test_chunked_wkv_prefill_matches_reference():
    """``wkv_prefill="chunked"`` (the reference's own prompt form):
    ``apply`` and ``prefill`` logits within CONTIG_TOL of the JAX
    model's in f32, and a decode step from its cache too."""
    jcfg = _jcfg("rwkv6-3b")
    jmodel = jbuild(jcfg)
    jparams = reference(jcfg)[1]
    cfg = to_port_config(jcfg)
    model = build_model(cfg, device="cpu", wkv_prefill="chunked")
    params = params_from_jax(reference(jcfg)[2], cfg, device="cpu")
    jb, tb = _batches(jcfg)
    want, _ = jax.jit(lambda p, b: jmodel.apply(p, b, train=False))(
        jparams, jb)
    _close(model.apply(params, tb), want, CONTIG_TOL)
    jlast, jcache = jax.jit(lambda p, b: jmodel.prefill(
        p, b, max_len=S + GEN))(jparams, jb)
    last, cache = model.prefill(params, tb, max_len=S + GEN)
    _close(last, jlast, CONTIG_TOL)
    tok = np.array(jnp.argmax(jlast, -1), np.int32)[:, None]
    jlog, _ = jax.jit(jmodel.decode_step)(jparams, jcache, jnp.asarray(tok))
    log, _ = model.decode_step(params, cache, torch.from_numpy(tok))
    _close(log, jlog, CONTIG_TOL)


def test_wkv_prefill_is_checked():
    with pytest.raises(ValueError, match="wkv_prefill"):
        build_model(configs.get_smoke("rwkv6-3b"), device="cpu",
                    wkv_prefill="parallel")

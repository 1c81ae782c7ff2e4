"""The port's training path against the JAX package on the CPU: AdamW,
clipping and the microbatch rule on the same numpy trees, the loss and
every leaf's gradient of one step, three steps of ``make_train_step``,
and the attention backward's plain version against ``jax.grad``.

In f32 (``compute_dtype="float32"``) the two packages compute the same
function with sums in other orders: the loss is held within rel 1e-5,
each gradient within rtol 1e-4 / atol 1e-6 and the parameters after
three steps within atol 2e-5.  The optimizer's arithmetic is the same
f32 arithmetic on the same inputs: rtol 1e-6.  After three steps one
element (of 16,384) of stablelm-smoke's ``layers/ffn/wg`` lands 4e-5
apart: its first gradient is -3.3e-8 against the reference's -4.2e-8,
f32 noise of a leaf whose gradients reach 0.16, and Adam's first step
moves it by lr g / (|g| + eps), 7.7e-4 against 8.1e-4.  Elements whose
reference gradient ever falls below the gradient atol (and is not 0:
an embedding row no token of the batch reads gets exactly 0 in both)
are therefore held to 2 lr a step, and must be fewer than 1 % of
their leaf (qwen3-smoke's ``layers/ffn/wd`` has 0.14 %).

The int8 compression's noise comes from ``torch.Generator`` in the port and ``jax.random`` in
the reference, so its bits cannot match; it is held to the reference
tests' properties (bounded error, error feedback keeps the signal).
The kernels themselves (the dataflow GEMM under ``LinearFn``, the
attention backward) run on the card only: ``chip_smoke.py`` holds them
against these plain versions there.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.data.pipeline import SyntheticPipeline as JPipeline
from repro.models import build_model as jbuild
from repro.models import components as JC
from repro.train import optimizer as jopt
from repro.train import step as jstep
from repro_torch import configs
from repro_torch.checkpoint import params_from_jax
from repro_torch.data import SyntheticPipeline
from repro_torch.kernels.flash_attention import ops as fa
from repro_torch.models.lm import DecoderLM
from repro_torch.train import optimizer as topt
from repro_torch.train import step as tstep
from repro_torch.tree import tree_items, tree_leaves, tree_map
from test_torch_model import reference, to_port_config

B, S = 2, 24
LOSS_RTOL = 1e-5
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-6
PARAM_ATOL = 2e-5
OPT_RTOL = 1e-6


def _np(x):
    return np.asarray(x.detach().float().numpy() if isinstance(
        x, torch.Tensor) else np.asarray(x, np.float32))


def _opt_trees(seed):
    """Parameters and gradients of a stacked-tree shape: a stacked
    (L, D) norm scale (decayed, as ndim >= 2), a (D,) final norm (not),
    a stacked (L, D, F) weight and a 2D table."""
    rng = np.random.default_rng(seed)
    shapes = {"final_norm": {"scale": (8,)},
              "layers": {"ln1": {"scale": (3, 8)}, "w": (3, 8, 5)},
              "embed": {"tok": (11, 8)}}

    def draw(node, scale):
        if isinstance(node, dict):
            return {k: draw(v, scale) for k, v in node.items()}
        return (scale * rng.standard_normal(node)).astype(np.float32)
    return draw(shapes, 1.0), draw(shapes, 0.3)


def _to_torch(tree):
    if isinstance(tree, dict):
        return {k: _to_torch(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


def _to_jax(tree):
    return jax.tree.map(jnp.asarray, tree)


def _assert_trees_close(got, want, rtol, atol=0.0):
    want = {"/".join(str(k.key) for k in path): leaf for path, leaf in
            jax.tree_util.tree_flatten_with_path(want)[0]}
    got = {"/".join(p): leaf for p, leaf in tree_items(got)}
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(_np(got[k]), np.asarray(want[k],
                                                           np.float32),
                                   rtol=rtol, atol=atol, err_msg=k)


@pytest.mark.parametrize("opt", [
    topt.OptConfig(),
    topt.OptConfig(lr=1e-2, warmup_steps=1, grad_clip=0.5),
    topt.OptConfig(weight_decay=0.0, keep_master=True, b2=0.999),
], ids=["defaults", "clipped", "master"])
def test_adamw_matches_reference(opt):
    params, grads = _opt_trees(0)
    jcfg = jopt.OptConfig(**dataclasses.asdict(opt))
    tp, tg = _to_torch(params), _to_torch(grads)
    jp, jg = _to_jax(params), _to_jax(grads)
    ts, js = topt.init_opt_state(tp, opt), jopt.init_opt_state(jp, jcfg)
    for _ in range(3):
        tp, ts, tm = topt.adamw_update(tp, tg, ts, opt)
        jp, js, jm = jopt.adamw_update(jp, jg, js, jcfg)
    _assert_trees_close(tp, jp, OPT_RTOL)
    _assert_trees_close({k: ts[k] for k in ts if k != "step"},
                        {k: js[k] for k in js if k != "step"}, OPT_RTOL)
    assert int(ts["step"]) == int(js["step"]) == 3
    for k in ("grad_norm", "lr"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]),
                                   rtol=OPT_RTOL)


def test_decay_follows_the_stacked_tree():
    """ndim >= 2 on the stored tree: the stacked (L, D) norm scale is
    decayed, the final norm's (D,) is not."""
    params, _ = _opt_trees(1)
    tp = _to_torch(params)
    zero = tree_map(torch.zeros_like, tp)
    opt = topt.OptConfig(weight_decay=0.1, grad_clip=1e9, warmup_steps=1)
    new, _, _ = topt.adamw_update(tp, zero, topt.init_opt_state(tp, opt),
                                  opt)
    assert torch.equal(new["final_norm"]["scale"],
                       tp["final_norm"]["scale"])
    assert not torch.equal(new["layers"]["ln1"]["scale"],
                           tp["layers"]["ln1"]["scale"])


def test_global_norm_clip_matches_reference():
    _, grads = _opt_trees(2)
    for max_norm in (0.5, 1e9):
        got, gn = topt.clip_by_global_norm(_to_torch(grads), max_norm)
        want, jgn = jopt.clip_by_global_norm(_to_jax(grads), max_norm)
        np.testing.assert_allclose(float(gn), float(jgn), rtol=OPT_RTOL)
        _assert_trees_close(got, want, OPT_RTOL)


@pytest.mark.parametrize("arch,batch,seq,dp", [
    ("qwen1.5-110b", 256, 4096, 16), ("qwen3-0.6b", 256, 4096, 16),
    ("qwen3-0.6b", 8, 256, 1), ("stablelm-1.6b", 64, 2048, 4)])
def test_auto_microbatches_matches_reference(arch, batch, seq, dp):
    assert (tstep.auto_microbatches(configs.get(arch), batch, seq, dp)
            == jstep.auto_microbatches(jconfigs.get(arch), batch, seq, dp))


@pytest.mark.parametrize("seed", range(4))
def test_int8_compression_bounded_error(seed):
    """The reference test's property (its bits come from jax.random and
    cannot be matched): the dequantized gradient is within one step."""
    g = torch.from_numpy(np.random.default_rng(seed).normal(
        size=(256,)).astype(np.float32))
    q, scale = topt.compress_int8(g, torch.Generator().manual_seed(seed))
    assert q.dtype == torch.int8
    assert float((topt.decompress_int8(q, scale) - g).abs().max()) <= (
        float(scale) * 1.01)


def test_error_feedback_preserves_signal():
    """With error feedback, gradients far below the quantization step
    of their leaf's max still move the parameters."""
    opt = topt.OptConfig(lr=1e-2, compress_grads=True, grad_clip=1e9,
                         warmup_steps=1)
    p = {"w": torch.zeros(64)}
    g = torch.full((64,), 1e-3)
    g[0] = 1.0
    s = topt.init_opt_state(p, opt)
    for i in range(10):
        p, s, _ = topt.adamw_update(p, {"w": g}, s, opt,
                                    compress_gen=torch.Generator()
                                    .manual_seed(i))
    assert float(p["w"][5].abs()) > 0


# --------------------------------------------------------------- model
def _jcfg(arch, **kw):
    return dataclasses.replace(jconfigs.get_smoke(arch),
                               compute_dtype="float32", **kw)


def _pair(jcfg):
    """(reference model, its params, port model, its params) on the
    same weights."""
    _, jparams, tree = reference(jcfg)
    cfg = to_port_config(jcfg)
    return (jbuild(jcfg), jparams, DecoderLM(cfg, device="cpu"),
            params_from_jax(tree, cfg, device="cpu"))


@pytest.mark.parametrize("arch", configs.ARCH_NAMES)
def test_pipelines_give_equal_batches(arch):
    """Tokens and labels, and per architecture whisper's frames,
    qwen2-vl's patch embeddings and M-RoPE positions: the numpy draws
    equal, and the device batch casts float inputs to bf16 as the
    reference's does."""
    cfg = configs.get_smoke(arch)
    for step in (0, 5):
        jpipe = JPipeline(jconfigs.get_smoke(arch), B, S)
        pipe = SyntheticPipeline(cfg, B, S)
        want, got = jpipe.batch_for_step(step), pipe.batch_for_step(step)
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        dev, jdev = pipe.device_batch(step, "cpu"), jpipe.device_batch(step)
        for k in want:
            assert str(dev[k].dtype).split(".")[1] == str(jdev[k].dtype), k
            np.testing.assert_array_equal(dev[k].float().numpy(), np.asarray(
                jdev[k].astype(jnp.float32)), err_msg=k)


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "stablelm-1.6b"])
def test_loss_grads_and_steps_match_reference(arch):
    jcfg = _jcfg(arch)
    jmodel, jparams, model, params = _pair(jcfg)
    jbatch = JPipeline(jcfg, B, S).device_batch(0)
    batch = SyntheticPipeline(model.cfg, B, S).device_batch(0, "cpu")

    jgrad = jax.jit(jax.value_and_grad(jstep.make_loss_fn(jmodel, jcfg),
                                       has_aux=True))
    (jloss, _), jgrads = jgrad(jparams, jbatch)
    leaves = [p.requires_grad_() for p in tree_leaves(params)]
    loss, _ = tstep.make_loss_fn(model, model.cfg)(params, batch)
    grads = torch.autograd.grad(loss, leaves)
    np.testing.assert_allclose(float(loss.detach()), float(jloss),
                               rtol=LOSS_RTOL)
    for (path, _), g, jg in zip(tree_items(params), grads,
                                jax.tree.leaves(jgrads)):
        np.testing.assert_allclose(_np(g), np.asarray(jg), rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL, err_msg="/".join(path))

    # three steps; an element whose reference gradient was ever below
    # GRAD_ATOL but not 0 (f32 noise of its leaf) moves by up to lr a step either
    # way in either package: Adam divides it by its own root mean square
    # the reference's step at one microbatch is its gradient (which also
    # marks the noise elements) and its AdamW update on it
    opt = topt.OptConfig(lr=1e-3, warmup_steps=1)
    jopt_cfg = jopt.OptConfig(lr=1e-3, warmup_steps=1)
    assert not jopt_cfg.compress_grads     # its step adds no noise
    jadamw = jax.jit(lambda p, g, s: jopt.adamw_update(p, g, s, jopt_cfg))
    train = tstep.make_train_step(model, model.cfg, opt=opt)
    js, ts = jopt.init_opt_state(jparams, jopt_cfg), topt.init_opt_state(
        params, opt)
    noise = [np.zeros(np.shape(g), bool) for g in jax.tree.leaves(jgrads)]
    for step in range(3):
        jb = JPipeline(jcfg, B, S).device_batch(step)
        (jl, _), jg = jgrad(jparams, jb)
        noise = [n | ((np.abs(g) < GRAD_ATOL) & (g != 0)) for n, g in
                 zip(noise, map(np.asarray, jax.tree.leaves(jg)))]
        jparams, js, _ = jadamw(jparams, jg, js)
        jm = {"loss": jl}
        params, ts, m = train(params, ts, SyntheticPipeline(
            model.cfg, B, S).device_batch(step, "cpu"))
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                                   rtol=LOSS_RTOL)
    for (path, p), jp, n in zip(tree_items(params),
                                jax.tree.leaves(jparams), noise):
        d = np.abs(p.numpy() - np.asarray(jp))
        assert n.mean() < 1e-2, "/".join(path)
        assert d[~n].max(initial=0) <= PARAM_ATOL, "/".join(path)
        assert d[n].max(initial=0) <= 2 * 3 * opt.lr, "/".join(path)


def test_chunked_ce_equals_plain():
    cfg = dataclasses.replace(configs.get_smoke("qwen3-0.6b"),
                              compute_dtype="float32", loss_chunk=8)
    model = DecoderLM(cfg, device="cpu")
    params = model.init(seed=1)
    batch = SyntheticPipeline(cfg, B, S).device_batch(0, "cpu")
    hidden = model.apply(params, batch, train=True, want_hidden=True)
    got = tstep.chunked_cross_entropy(hidden, params["embed"],
                                      batch["labels"], cfg, 8)
    want = tstep.cross_entropy(model.logits(params, hidden),
                               batch["labels"])
    np.testing.assert_allclose(float(got), float(want), rtol=2e-6)


def test_microbatched_grads_match_full_batch():
    cfg = dataclasses.replace(configs.get_smoke("stablelm-1.6b"),
                              compute_dtype="float32")
    model = DecoderLM(cfg, device="cpu")
    params = model.init(seed=2)
    batch = SyntheticPipeline(cfg, 4, 16).device_batch(0, "cpu")
    opt = topt.OptConfig()
    p1, _, m1 = tstep.make_train_step(model, cfg, opt=opt, n_micro=1)(
        params, topt.init_opt_state(params, opt), batch)
    p4, _, m4 = tstep.make_train_step(model, cfg, opt=opt, n_micro=4)(
        params, topt.init_opt_state(params, opt), batch)
    np.testing.assert_allclose(float(m1["loss"]), float(m4["loss"]),
                               rtol=1e-5)
    for a, b in zip(tree_leaves(p1), tree_leaves(p4)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=5e-3,
                                   atol=5e-5)


def test_gradient_reaches_every_leaf():
    """bf16 compute, the port's own init: every parameter leaf gets a
    gradient that is not all zero (a kernel call that autograd cannot
    see would leave every leaf above it without one)."""
    cfg = configs.get_smoke("qwen3-0.6b")
    model = DecoderLM(cfg, device="cpu")
    params = model.init(seed=3)
    leaves = [p.requires_grad_() for p in tree_leaves(params)]
    loss, _ = tstep.make_loss_fn(model, cfg)(
        params, SyntheticPipeline(cfg, B, S).device_batch(0, "cpu"))
    for (path, _), g in zip(tree_items(params),
                            torch.autograd.grad(loss, leaves,
                                                allow_unused=True)):
        assert g is not None and bool(g.ne(0).any()), "/".join(path)


def test_train_forward_is_the_serving_forward():
    """``apply(train=True)`` computes the serving forward: the same
    logits in f32 (the projections' 2D products against the serving
    path's batched ones)."""
    cfg = dataclasses.replace(configs.get_smoke("qwen3-0.6b"),
                              compute_dtype="float32")
    model = DecoderLM(cfg, device="cpu")
    params = model.init(seed=4)
    batch = SyntheticPipeline(cfg, B, S).device_batch(0, "cpu")
    want = model.apply(params, batch)
    for p in tree_leaves(params):
        p.requires_grad_()
    got = model.apply(params, batch, train=True)
    np.testing.assert_allclose(got.detach().numpy(), want.numpy(),
                               rtol=1e-5, atol=1e-5)


# ------------------------------------------------------------ attention
@pytest.mark.parametrize("B_,S_,Skv,H,KVH,Dh,causal,window,form", [
    (2, 48, 48, 4, 4, 16, True, None, "flash"),
    (2, 48, 48, 4, 4, 16, False, None, "flash"),
    (1, 64, 64, 6, 2, 32, True, None, "flash"),
    (2, 70, 70, 4, 2, 16, True, None, "flash"),
    (2, 80, 80, 4, 2, 16, True, 24, "flash"),
    (1, 96, 96, 4, 1, 16, True, 32, "local"),
    (2, 20, 50, 4, 4, 16, False, None, "cross"),
    (1, 30, 140, 6, 2, 16, False, None, "cross"),
    (1, 70, 70, 4, 2, 16, False, 40, "flash")],
    ids=["causal", "not_causal", "gqa", "ragged", "window_gqa",
         "local_attention", "cross", "cross_gqa", "window_not_causal"])
def test_attention_backward_matches_reference(B_, S_, Skv, H, KVH, Dh,
                                              causal, window, form):
    """``flash_attention_bwd_plain`` (the kernel's function) against
    ``jax.grad`` of the reference's attention (``flash_attention`` with
    its window; ``local_attention``, the banded form recurrentgemma
    trains through; the cross-attention's Sq queries over Skv keys) and
    ``torch.autograd`` of the port's plain forward, in f32."""
    rng = np.random.default_rng(Dh + S_ + Skv)
    q, do = (rng.standard_normal((B_, S_, H, Dh)).astype(np.float32)
             for _ in range(2))
    k, v = (rng.standard_normal((B_, Skv, KVH, Dh)).astype(np.float32)
            for _ in range(2))
    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, do))
    _, lse = fa.flash_attention_plain(tq, tk, tv, causal=causal,
                                      window=window, return_lse=True)
    got = fa.flash_attention_bwd_plain(tq, tk, tv, lse, tdo, causal, window)

    def f(q, k, v):
        if form == "local":
            o = JC.local_attention(q, k, v, window=window)
        else:
            o = JC.flash_attention(q, k, v, causal=causal, window=window,
                                   kv_chunk=16)
        return jnp.sum(o * do)
    want = jax.jit(jax.grad(f, argnums=(0, 1, 2)))(q, k, v)
    leaves = [t.clone().requires_grad_() for t in (tq, tk, tv)]
    auto = torch.autograd.grad(
        fa.flash_attention_plain(*leaves, causal=causal, window=window),
        leaves, tdo)
    for name, g, w, a in zip("qkv", got, want, auto):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-5, err_msg=name)
        np.testing.assert_allclose(g.numpy(), a.numpy(), rtol=1e-4,
                                   atol=1e-5, err_msg=name)


@pytest.mark.parametrize("causal", [True, False],
                         ids=["causal", "not_causal"])
def test_attention_backward_bf16_keys_sharing_a_component(causal):
    """``flash_attention_bwd_plain`` in bf16 where every key of a head
    shares a component 16 times its own (as the keys of whisper's
    decoder, which carry no rotary position, share one at init): dQ =
    dS K sees the shared part only through each dS row's sum, zero up to
    f32 rounding when D = rowsum(P dP), so dQ stays within 3.5e-2
    relative L2 of the f32 backward of the same bf16 inputs.  D taken
    from the forward's output rounded to bf16 (rowsum(dout * out)) left
    every row a residue that put dQ 4.5e-2 to 4.8e-2 away."""
    g = torch.Generator().manual_seed(0)
    B_, S_, H, Dh = 2, 192, 2, 64
    q = torch.randn(B_, S_, H, Dh, generator=g)
    shared = 16 * torch.randn(B_, 1, H, Dh, generator=g)
    k = shared + torch.randn(B_, S_, H, Dh, generator=g)
    v, do = (torch.randn(B_, S_, H, Dh, generator=g) for _ in range(2))
    q, k, v, do = (t.bfloat16() for t in (q, k, v, do))
    _, lse = fa.flash_attention_plain(q, k, v, causal=causal,
                                      return_lse=True)
    got = fa.flash_attention_bwd_plain(q, k, v, lse, do, causal)
    f32 = [t.float() for t in (q, k, v, do)]
    _, lse32 = fa.flash_attention_plain(*f32[:3], causal=causal,
                                        return_lse=True)
    want = fa.flash_attention_bwd_plain(*f32[:3], lse32, f32[3], causal)
    for name, a, w in zip("qkv", got, want):
        rel = float((a.float() - w).norm() / w.norm())
        assert rel < 3.5e-2, (name, rel)


def test_attention_backward_refuses_what_it_does_not_cover():
    """Only a q_offset: no training path attends from another position
    (windows and Sq != Skv train since the families' slice)."""
    q = torch.zeros(1, 8, 2, 16)
    k = torch.zeros(1, 8, 2, 16)
    for off in (3, torch.tensor([3])):
        with pytest.raises(ValueError, match="q_offset 0"):
            fa.flash_attention_train(q, k, k, q_offset=off)

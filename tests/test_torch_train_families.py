"""Training of the MoE stacks and the five lockstep-only families in the
port against the JAX package on the CPU: deepseek-moe-16b and
llama4-scout-17b-a16e (the load-balance term of the loss, the experts'
dispatch under grad), qwen2-vl-7b (M-RoPE, patch embeddings),
whisper-tiny (encoder-decoder, cross-attention's backward at Sq != Skv),
recurrentgemma-2b (RG-LRU, windowed attention's backward) and rwkv6-3b
(the chunked WKV).

* On bridged weights and the reference's synthetic batch, in f32: the
  loss, every leaf's gradient and one AdamW step equal the reference's
  ``make_loss_fn`` / ``make_train_step`` within the tolerances of
  ``tests/test_torch_train.py``.
* Every architecture of ``configs.ARCH_NAMES`` lowers its loss over four
  steps (n_micro 2) on one batch: the port's counterpart of
  ``tests/test_smoke_archs.py::test_train_step_decreases_loss``.
* An encoder-decoder never takes the chunked loss, as in the reference.
* The MoE's gradient is the same in two calls; a deepseek-moe-smoke
  checkpoint written by the port restores in the reference bit for bit;
  the launcher trains each family.

The kernels (the dataflow GEMM under ``LinearFn``, the attention
backward at windows, Dh 256 and Sq != Skv) run on the card only:
``chip_smoke.py``'s ``train_families`` phase holds them there.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.checkpoint import restore_checkpoint as jrestore
from repro.data.pipeline import SyntheticPipeline as JPipeline
from repro.models import build_model as jbuild
from repro.train import optimizer as jopt
from repro.train import step as jstep
from repro_torch import configs
from repro_torch.checkpoint import params_from_jax, save_checkpoint
from repro_torch.data import SyntheticPipeline
from repro_torch.launch import train as launch_train
from repro_torch.models import build_model
from repro_torch.train import optimizer as topt
from repro_torch.train import step as tstep
from repro_torch.tree import tree_items, tree_leaves, tree_map
from test_torch_model import reference, to_port_config
from test_torch_runtime import _bits
from test_torch_train import (GRAD_ATOL, GRAD_RTOL, LOSS_RTOL, PARAM_ATOL,
                              _np)

#: the architectures this slice made trainable
NEW = ("deepseek-moe-16b", "llama4-scout-17b-a16e", "qwen2-vl-7b",
       "whisper-tiny", "recurrentgemma-2b", "rwkv6-3b")
#: the recurrent stacks, whose f32 gradients carry the noise of a
#: recurrence's backward (RG-LRU's scan, the chunked WKV): relative L2
#: ~7e-6 in every leaf, so an element of 0.01 in an embedding leaf whose
#: largest gradient is 1.7 lands 2.5e-5 from the reference.  Their
#: elements are held to GRAD_RTOL of the leaf's largest gradient besides
#: their own (every leaf's relative L2 within GRAD_RTOL all the same).
RECURRENT = ("recurrentgemma-2b", "rwkv6-3b")
#: batch of the checks (S a multiple of the smoke recurrentgemma's
#: 16-key window, the reference's local-attention contract)
B, S = 2, 32
LR = 1e-3


def _pair(arch, **kw):
    """(reference config, model, params; port config, model, params) in
    f32 on the same (perturbed) weights."""
    jcfg = dataclasses.replace(jconfigs.get_smoke(arch),
                               compute_dtype="float32", **kw)
    _, jparams, tree = reference(jcfg)
    cfg = to_port_config(jcfg)
    return (jcfg, jbuild(jcfg), jparams, cfg, build_model(cfg, device="cpu"),
            params_from_jax(tree, cfg, device="cpu"))


def reference_step(jparams, jgrads, opt):
    """(params, opt state) after the reference's ``make_train_step`` at
    one microbatch, from the gradients it takes (``value_and_grad`` of
    its loss, already computed by the caller): its ``adamw_update`` on
    them from a fresh state, as the step applies it while no gradient
    is compressed."""
    assert not opt.compress_grads
    return jax.jit(lambda p, g: jopt.adamw_update(
        p, g, jopt.init_opt_state(p, opt), opt)[:2])(jparams, jgrads)


@pytest.mark.parametrize("arch", NEW)
def test_loss_grads_and_step_match_reference(arch):
    jcfg, jmodel, jparams, cfg, model, params = _pair(arch)
    jbatch = JPipeline(jcfg, B, S).device_batch(0)
    batch = SyntheticPipeline(cfg, B, S).device_batch(0, "cpu")

    jgrad = jax.jit(jax.value_and_grad(jstep.make_loss_fn(jmodel, jcfg),
                                       has_aux=True))
    (jloss, jaux), jgrads = jgrad(jparams, jbatch)
    leaves = [p.requires_grad_() for p in tree_leaves(params)]
    loss, aux = tstep.make_loss_fn(model, cfg)(params, batch)
    grads = torch.autograd.grad(loss, leaves)
    np.testing.assert_allclose(float(loss.detach()), float(jloss),
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(aux["moe_aux"].detach()),
                               float(jaux["moe_aux"]), rtol=LOSS_RTOL,
                               atol=1e-7)
    if cfg.moe is not None:
        assert float(aux["moe_aux"].detach()) > 0
    jleaves = [np.asarray(g) for g in jax.tree.leaves(jgrads)]
    assert len(jleaves) == len(grads)
    atols = [GRAD_ATOL + (GRAD_RTOL * float(np.abs(jg).max())
                          if arch in RECURRENT else 0.0) for jg in jleaves]
    for (path, _), g, jg, atol in zip(tree_items(params), grads, jleaves,
                                      atols):
        name = "/".join(path)
        np.testing.assert_allclose(_np(g), jg, rtol=GRAD_RTOL, atol=atol,
                                   err_msg=name)
        assert (np.linalg.norm(_np(g) - jg)
                <= GRAD_RTOL * np.linalg.norm(jg)), name

    # one AdamW step.  Adam moves an element by about lr sign(g), so an
    # element whose gradient is below GRAD_ATOL but not 0, or whose sign
    # differs between the packages (possible only below its atol), may
    # move by up to lr either way in either package; those are held to
    # 2 lr.  They are many in some small leaves (rwkv6's decay LoRA and
    # token-mix maps, drawn at 1e-3 scale: 7.1 % of rwkv6-smoke's tree;
    # RG-LRU's gates), so the check only bounds their share of the whole
    # tree, at a tenth.
    opt = topt.OptConfig(lr=LR, warmup_steps=1)
    jcfg_opt = jopt.OptConfig(lr=LR, warmup_steps=1)
    jp, _ = reference_step(jparams, jgrads, jcfg_opt)
    jm = {"loss": jloss}
    tp, _, m = tstep.make_train_step(model, cfg, opt=opt)(
        params, topt.init_opt_state(params, opt), batch)
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                               rtol=LOSS_RTOL)
    n_noise = n_all = 0
    for (path, p), want, jg, g in zip(tree_items(tp), jax.tree.leaves(jp),
                                      jleaves, grads):
        noise = (jg != 0) & ((np.abs(jg) < GRAD_ATOL)
                             | (np.sign(jg) != np.sign(_np(g))))
        n_noise, n_all = n_noise + noise.sum(), n_all + noise.size
        d = np.abs(p.numpy() - np.asarray(want))
        assert d[~noise].max(initial=0) <= PARAM_ATOL, "/".join(path)
        assert d[noise].max(initial=0) <= 2 * LR, "/".join(path)
    assert n_noise < 0.1 * n_all, n_noise / n_all


def test_encoder_decoder_takes_no_chunked_loss():
    """whisper with ``loss_chunk > 0``: the reference computes its plain
    loss (the chunked loss would need the decoder's hidden states), and
    so does the port."""
    jcfg, jmodel, jparams, cfg, model, params = _pair("whisper-tiny",
                                                      loss_chunk=8)
    jloss, _ = jax.jit(jstep.make_loss_fn(jmodel, jcfg))(
        jparams, JPipeline(jcfg, B, S).device_batch(0))
    loss, _ = tstep.make_loss_fn(model, cfg)(
        params, SyntheticPipeline(cfg, B, S).device_batch(0, "cpu"))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=LOSS_RTOL)


@pytest.mark.parametrize("arch", configs.ARCH_NAMES)
def test_train_step_decreases_loss(arch):
    """The smoke config in bf16, the port's own init: four steps with
    n_micro 2 on one batch lower the loss."""
    cfg = configs.get_smoke(arch)
    model = build_model(cfg, device="cpu")
    params = model.init(seed=0)
    batch = SyntheticPipeline(cfg, 4, S).device_batch(0, "cpu")
    step = tstep.make_train_step(model, cfg, n_micro=2)
    state = topt.init_opt_state(params)
    losses = []
    for _ in range(4):
        params, state, m = step(params, state, batch)
        losses.append(float(m["loss"]))
    assert all(np.isfinite(losses))
    assert losses[-1] < losses[0], losses


def _moe_grads(seed):
    cfg = configs.get_smoke("deepseek-moe-16b")
    model = build_model(cfg, device="cpu")
    params = model.init(seed=seed)
    leaves = [p.requires_grad_() for p in tree_leaves(params)]
    loss, aux = tstep.make_loss_fn(model, cfg)(
        params, SyntheticPipeline(cfg, B, S).device_batch(0, "cpu"))
    return loss, aux["moe_aux"], torch.autograd.grad(loss, leaves)


def test_moe_gradient_is_the_same_in_two_calls():
    """bf16 compute: the dispatch's backward adds a token's K copies in
    choice order and writes every other slot once, so two calls give the
    same bits."""
    a, b = _moe_grads(1), _moe_grads(1)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert all(torch.equal(x, y) for x, y in zip(a[2], b[2]))
    assert all(bool(g.ne(0).any()) for g in a[2])


def test_moe_checkpoint_restores_in_the_reference_bit_for_bit(tmp_path):
    """A deepseek-moe-smoke checkpoint (params and AdamW state after one
    step) written by the port restores through the reference's reader
    into its own parameter tree, every leaf bit for bit."""
    cfg = configs.get_smoke("deepseek-moe-16b")
    model = build_model(cfg, device="cpu")
    params = model.init(seed=2)
    opt = topt.OptConfig(warmup_steps=1)
    params, state, _ = tstep.make_train_step(model, cfg, opt=opt)(
        params, topt.init_opt_state(params, opt),
        SyntheticPipeline(cfg, B, S).device_batch(0, "cpu"))
    tree = {"params": params, "opt": state}
    save_checkpoint(tmp_path, 1, tree)
    like = tree_map(lambda t: jnp.zeros(t.shape, jnp.dtype(
        str(t.dtype).split(".")[1])), tree)
    got, step = jrestore(tmp_path, like)
    assert step == 1
    jparams = jbuild(jconfigs.get_smoke("deepseek-moe-16b")).init(
        jax.random.PRNGKey(0))
    assert (jax.tree.structure(got["params"]) ==
            jax.tree.structure(jparams))
    assert ([np.shape(x) for x in jax.tree.leaves(got["params"])] ==
            [np.shape(x) for x in jax.tree.leaves(jparams)])
    want = dict(tree_items(tree))
    for path, leaf in jax.tree_util.tree_flatten_with_path(got)[0]:
        key = tuple(str(p.key) for p in path)
        np.testing.assert_array_equal(_bits(leaf), _bits(want[key]),
                                      err_msg="/".join(key))


@pytest.mark.parametrize("arch", NEW)
def test_launcher_trains_the_architecture(arch, tmp_path):
    drv = launch_train.main(["--arch", arch, "--smoke", "--device", "cpu",
                             "--steps", "2", "--batch", "2", "--seq",
                             str(S), "--ckpt-dir", str(tmp_path),
                             "--log-every", "1"])
    assert [m["step"] for m in drv.metrics_log] == [0, 1]
    assert all(np.isfinite(m["loss"]) and m["grad_norm"] > 0
               for m in drv.metrics_log)

"""Parameters stored in ``cfg.param_dtype`` (the reference's
``models/base.py:with_param_dtype``): at "bfloat16" every f32 leaf of 2
or more dimensions of the stacked tree is stored bf16, the 1-D norms and
biases stay f32, in both packages leaf for leaf.

The bridge and the checkpoints carry bf16 leaves both ways with their
bits.  A model that stores bf16 serves exactly as the f32 model whose
weights are the bf16 values upcast (every product reads an upcast or a
cast of the stored bits).  One ``make_train_step`` with
``keep_master=True`` matches the reference's on the same bridged
weights, in f32 compute, at ``tests/test_torch_train.py``'s
tolerances: the loss within LOSS_RTOL and the f32 master within
PARAM_ATOL (its elements whose gradient sits in f32 noise within 2 lr,
as there).  The bf16 parameters the step returns are the port's own
master rounded to bf16, bit for bit, and so lie within PARAM_ATOL plus
one bf16 rounding step of the reference's.  The gradients of bf16
leaves are bf16 in both packages: two f32 gradients 1e-7 apart can
round one bf16 place apart, so they are not compared here
(``tests/test_torch_train.py`` compares them in f32 storage).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.checkpoint import restore_checkpoint as jrestore
from repro.checkpoint import save_checkpoint as jsave
from repro.data.pipeline import SyntheticPipeline as JPipeline
from repro.models import build_model as jbuild
from repro.models.base import ParamSpec as JParamSpec
from repro.train import optimizer as jopt
from repro.train import step as jstep
from repro_torch import configs
from repro_torch.checkpoint import (params_from_jax, params_to_numpy,
                                    restore_checkpoint, save_checkpoint)
from repro_torch.data import SyntheticPipeline
from repro_torch.models import build_model, param_specs
from repro_torch.models.base import flatten_specs
from repro_torch.serve.step import ServePrograms, greedy_generate
from repro_torch.train import optimizer as topt
from repro_torch.train import step as tstep
from repro_torch.tree import tree_items, tree_leaves, tree_map, tree_unflatten
from test_torch_model import reference, to_port_config
from test_torch_runtime import _bits
from test_torch_train import LOSS_RTOL, PARAM_ATOL, _np
from test_torch_train_families import reference_step

BF16 = dict(param_dtype="bfloat16")
B, S = 2, 32
LR = 1e-3


def _jcfg(arch, **kw):
    return dataclasses.replace(jconfigs.get_smoke(arch), **BF16, **kw)


def _reference_dtypes(jcfg):
    flat = jax.tree_util.tree_flatten_with_path(
        jbuild(jcfg).param_specs(),
        is_leaf=lambda x: isinstance(x, JParamSpec))[0]
    return {tuple(k.key for k in path): np.dtype(ps.dtype).name
            for path, ps in flat}


@pytest.mark.parametrize("arch", configs.ARCH_NAMES)
def test_leaf_dtypes_match_reference(arch):
    """Every leaf's storage dtype is the reference's, and ``init``
    stores each leaf so (a stacked (L, D) norm scale is bf16 in both,
    a (D,) final norm f32)."""
    want = _reference_dtypes(_jcfg(arch))
    cfg = to_port_config(_jcfg(arch))
    specs = dict(flatten_specs(param_specs(cfg)))
    got = {p: str(ps.dtype).split(".")[1] for p, ps in specs.items()}
    assert got == want
    assert set(want.values()) == {"bfloat16", "float32"}
    for path, leaf in tree_items(build_model(cfg, device="cpu").init(0)):
        assert leaf.dtype == specs[path].dtype, path
    # f32 storage is unchanged: every leaf f32
    f32 = dict(flatten_specs(param_specs(configs.get_smoke(arch))))
    assert {ps.dtype for ps in f32.values()} == {torch.float32}


def test_bridge_and_checkpoints_carry_bf16_bits(tmp_path):
    """Reference bf16 tree -> port -> numpy keeps every bit; the port's
    checkpoint restores in the reference and the reference's in the
    port, bit for bit and dtype for dtype; the bridge refuses a tree
    stored in another dtype than the config's."""
    jcfg = _jcfg("qwen3-0.6b")
    _, jparams, tree = reference(jcfg)
    cfg = to_port_config(jcfg)
    params = params_from_jax(tree, cfg, device="cpu")
    back = dict(tree_items(params_to_numpy(params)))
    for path, arr in tree_items(tree):
        assert back[path].dtype == (np.uint16 if arr.dtype.name ==
                                    "bfloat16" else arr.dtype), path
        np.testing.assert_array_equal(back[path].view(arr.dtype), arr)
    save_checkpoint(tmp_path / "port", 1, params)
    got, _ = jrestore(tmp_path / "port", jparams)
    for (path, want), leaf in zip(tree_items(params), jax.tree.leaves(got)):
        assert str(leaf.dtype) == str(want.dtype).split(".")[1], path
        np.testing.assert_array_equal(_bits(leaf), _bits(want))
    jsave(tmp_path / "ref", 2, jparams)
    got, step = restore_checkpoint(tmp_path / "ref", params)
    assert step == 2
    for (path, leaf), want in zip(tree_items(got), jax.tree.leaves(jparams)):
        assert leaf.dtype == params_like(params, path).dtype, path
        np.testing.assert_array_equal(_bits(leaf), _bits(want))
    f32_tree = jax.tree.map(lambda a: np.asarray(a, np.float32), tree)
    with pytest.raises(ValueError, match="dtype"):
        params_from_jax(f32_tree, cfg, device="cpu")


def params_like(params, path):
    node = params
    for k in path:
        node = node[k]
    return node


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "llama4-scout-17b-a16e"])
def test_bf16_storage_serves_as_its_f32_upcast(arch):
    """bf16 compute: the bf16-stored model and the f32 model holding the
    same values give equal prefill logits and equal greedy tokens
    (``prepare_params`` leaves bf16 projections as they are; the router,
    an ``f32`` leaf, enters its product as an upcast of its bf16
    bits)."""
    cfg = dataclasses.replace(configs.get_smoke(arch), **BF16)
    model = build_model(cfg, device="cpu")
    params = model.init(seed=3)
    f32_model = build_model(configs.get_smoke(arch), device="cpu")
    f32_params = tree_map(lambda t: t.float(), params)
    served = ServePrograms(model).prepare_params(params)
    for path, leaf in tree_items(served):
        assert leaf.dtype == params_like(params, path).dtype, path
    prompt = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 12)).astype(np.int64))
    a = model.apply(params, prompt)
    b = f32_model.apply(f32_params, prompt)
    assert torch.equal(a, b)
    assert torch.equal(greedy_generate(model, served, prompt, 6, 24),
                       greedy_generate(f32_model, ServePrograms(
                           f32_model).prepare_params(f32_params),
                           prompt, 6, 24))


def _half_ulp_bf16(x):
    """Half of one bf16 place at each element of x (f32 array)."""
    e = np.floor(np.log2(np.maximum(np.abs(x), 1e-30)))
    return np.exp2(e - 8)


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "deepseek-moe-16b",
                                  "whisper-tiny"])
def test_keep_master_step_matches_reference(arch):
    jcfg = _jcfg(arch, compute_dtype="float32")
    _, jparams, tree = reference(jcfg)
    cfg = to_port_config(jcfg)
    jmodel, model = jbuild(jcfg), build_model(cfg, device="cpu")
    params = params_from_jax(tree, cfg, device="cpu")
    jbatch = JPipeline(jcfg, B, S).device_batch(0)
    batch = SyntheticPipeline(cfg, B, S).device_batch(0, "cpu")

    # the reference's gradients: they mark the elements in f32 noise
    # (below 1e-6, or of other signs), as tests/test_torch_train_families
    # does, and its step applies AdamW to them (``reference_step``)
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(
        jstep.make_loss_fn(jmodel, jcfg), has_aux=True))(jparams, jbatch)
    leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
    loss, _ = tstep.make_loss_fn(model, cfg)(
        tree_unflatten(params, leaves), batch)
    grads = torch.autograd.grad(loss, leaves)

    opt = topt.OptConfig(lr=LR, warmup_steps=1, keep_master=True)
    jopt_cfg = jopt.OptConfig(lr=LR, warmup_steps=1, keep_master=True)
    jp, js = reference_step(jparams, jgrads, jopt_cfg)
    jm = {"loss": jloss}
    state = topt.init_opt_state(params, opt)
    assert {t.dtype for t in tree_leaves(state["master"])} == {torch.float32}
    tp, ts, m = tstep.make_train_step(model, cfg, opt=opt)(
        params, state, batch)
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                               rtol=LOSS_RTOL)
    n_noise = n_all = 0
    for (path, p), master, jpv, jmaster, jg, g in zip(
            tree_items(tp), tree_leaves(ts["master"]), jax.tree.leaves(jp),
            jax.tree.leaves(js["master"]), jax.tree.leaves(jgrads), grads):
        name = "/".join(path)
        assert p.dtype == params_like(params, path).dtype, name
        assert master.dtype == torch.float32, name
        assert torch.equal(p, master.to(p.dtype)), name
        jg, g = np.asarray(jg, np.float32), _np(g)
        noise = (jg != 0) & ((np.abs(jg) < 1e-6) | (np.sign(jg) != np.sign(g)))
        n_noise, n_all = n_noise + noise.sum(), n_all + noise.size
        d = np.abs(master.numpy() - np.asarray(jmaster))
        assert d[~noise].max(initial=0) <= PARAM_ATOL, name
        assert d[noise].max(initial=0) <= 2 * LR, name
        jpv = np.asarray(jpv, np.float32)
        d = np.abs(_np(p) - jpv)
        bound = np.where(noise, 2 * LR, PARAM_ATOL) + 2 * _half_ulp_bf16(jpv)
        assert (d <= bound).all(), name
    assert n_noise < 0.1 * n_all, n_noise / n_all

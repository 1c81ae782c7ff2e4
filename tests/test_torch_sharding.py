"""The port's logical-axis sharding rules and spec trees against the JAX
package, without processes: ``sharding.logical_spec`` equals the
reference's on the reference test's duck-typed ``FakeMesh`` (the
``(16, 16)`` and ``(2, 16, 16)`` production meshes, ``DEFAULT_RULES`` and
``SP_RULES``, hard and soft), and every leaf of the port's
``param_specs()``, ``cache_specs()`` and ``opt_state_specs()`` carries
the reference's logical axes, for all ten architectures.  The leaves'
shapes and dtypes are held elsewhere (``test_torch_model.py``,
``test_torch_param_dtype.py``); the cache's and the optimizer state's
are checked here with their axes.  Where ``model`` divides H but not
KVH, a rank's KV heads (``spmd.rank_kv_heads``) repeated to its query
heads (``components.expand_kv``) are the reference's G-fold repeat of
every KV head cut to the rank's query heads, ``torch.equal``."""
import dataclasses

import jax
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st
from jax.sharding import PartitionSpec as P

from repro import configs as jconfigs
from repro.models import build_model as jbuild
from repro.models.base import ParamSpec as JParamSpec
from repro.sharding import DEFAULT_RULES as JDEFAULT
from repro.sharding import SP_RULES as JSP
from repro.sharding import logical_spec as jlogical_spec
from repro.train import optimizer as jopt
from repro_torch import configs
from repro_torch.models import build_model
from repro_torch.models import components as C
from repro_torch.models.base import ParamSpec
from repro_torch.sharding import (DEFAULT_RULES, RULE_VARIANTS, SP_RULES,
                                  UNCONSTRAINED, logical_spec, spmd,
                                  tree_shardings)
from repro_torch.train import optimizer as topt
from test_sharding_rules import FakeMesh

MESHES = {"data16_model16": {"data": 16, "model": 16},
          "pod2_data16_model16": {"pod": 2, "data": 16, "model": 16}}
RULES = {"default": (DEFAULT_RULES, JDEFAULT), "sp": (SP_RULES, JSP)}
NAMES = [f.name for f in dataclasses.fields(DEFAULT_RULES)] + [None]


def _port_entry(e):
    return UNCONSTRAINED if e is P.UNCONSTRAINED else e


def _want(axes, shape, mesh, rules, soft=False):
    """The reference's spec as the port writes it: a tuple of entries."""
    return tuple(_port_entry(e) for e in
                 jlogical_spec(axes, shape, mesh, rules, soft=soft))


def _flat(tree, is_leaf):
    """{path: leaf} of a nested dict / list / tuple tree."""
    out = {}

    def walk(node, path):
        if is_leaf(node):
            out["/".join(path)] = node
        elif isinstance(node, dict):
            for k, v in node.items():
                walk(v, path + (str(k),))
        else:
            for i, v in enumerate(node):
                walk(v, path + (str(i),))
    walk(tree, ())
    return out


def _port_flat(tree):
    return _flat(tree, lambda x: isinstance(x, ParamSpec))


def _ref_flat(tree):
    return _flat(tree, lambda x: isinstance(x, JParamSpec))


def _dtype(ps) -> str:
    """A spec's dtype by name (a torch or a numpy / jax dtype)."""
    dt = ps.dtype
    return str(dt).split(".")[-1] if "torch" in str(dt) else \
        np.dtype(dt).name


def _models(arch):
    return (jbuild(jconfigs.get(arch)),
            build_model(configs.get(arch), device="cpu"))


def test_rule_tables_equal_reference():
    for port, ref in RULES.values():
        for name in NAMES[:-1]:
            assert port.get(name) == ref.get(name), name
    assert set(RULE_VARIANTS) == {"default", "sp"}
    with pytest.raises(KeyError):
        DEFAULT_RULES.get("no_such_dim")


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("rules", list(RULES))
@given(data=st.data())
@settings(max_examples=40, deadline=None)
def test_logical_spec_matches_reference(mesh, rules, data):
    """Hypothesis-drawn logical axes (any rule name or None) and dims
    (divisible by 1 to 512, or any size) resolve to the reference's
    spec, hard and soft."""
    fm = FakeMesh(MESHES[mesh])
    port, ref = RULES[rules]
    rank = data.draw(st.integers(1, 4))
    axes = tuple(data.draw(st.sampled_from(NAMES)) for _ in range(rank))
    shape = tuple(data.draw(st.one_of(
        st.integers(1, 4096),
        st.sampled_from([1, 2, 4, 16, 32, 64, 128, 256, 512]).flatmap(
            lambda k: st.integers(1, 16).map(lambda m: k * m))))
        for _ in range(rank))
    for soft in (False, True):
        assert logical_spec(axes, shape, fm, port, soft=soft) == _want(
            axes, shape, fm, ref, soft), (axes, shape, soft)


def test_logical_spec_safety_rules():
    """The reference test's cases: divisibility with prefix fallback,
    exclusivity, the soft mode's UNCONSTRAINED, rank checking."""
    fm = FakeMesh({"pod": 2, "data": 16, "model": 16})
    assert logical_spec(("batch", None), (256, 7), fm) == (("pod", "data"),)
    assert logical_spec(("batch",), (16,), fm) == ("pod",)
    assert logical_spec(("batch",), (3,), fm) == ()
    assert logical_spec(("ff", "vocab"), (64, 64), fm) == ("model",)
    assert logical_spec(("act_heads",), (10,), fm, soft=True) == (
        UNCONSTRAINED,)
    with pytest.raises(ValueError, match="rank"):
        logical_spec(("batch",), (4, 4), fm)


@pytest.mark.parametrize("arch", configs.ARCH_NAMES)
def test_param_axes_match_reference(arch):
    jmodel, model = _models(arch)
    want = _ref_flat(jmodel.param_specs())
    got = _port_flat(model.param_specs())
    assert set(got) == set(want)
    for k, ps in got.items():
        assert ps.axes == tuple(want[k].axes), k
        assert ps.shape == tuple(want[k].shape), k


def _ref_cache_as_port(jmodel, model, tree):
    """The reference's cache spec tree in the port's layout: a list of
    layers (the stacked ``layers`` leaves unstacked), or whisper's as
    it is."""
    cfg = model.cfg
    if cfg.is_encoder_decoder:
        return tree
    fd = model.first_dense
    layers = []
    for i in range(cfg.n_layers):
        if not model.scanned:
            layers.append(tree[f"layer_{i:02d}"])
        elif i < fd:
            layers.append(tree[f"dense_layer_{i}"])
        else:
            layers.append(jax.tree.map(
                lambda ps: JParamSpec(ps.shape[1:], ps.axes[1:], ps.dtype),
                tree["layers"], is_leaf=lambda x: isinstance(x, JParamSpec)))
    return {"layers": layers, "pos": tree["pos"]}


@pytest.mark.parametrize("arch", configs.ARCH_NAMES)
def test_cache_axes_match_reference(arch):
    """The decode cache's specs (shapes, axes, dtypes): the attention
    K/V on ("batch", "kv_seq", "act_heads", None), rings, recurrent
    states."""
    jmodel, model = _models(arch)
    want = _ref_flat(_ref_cache_as_port(jmodel, model,
                                        jmodel.cache_specs(4, 96)))
    got = _port_flat(model.cache_specs(4, 96))
    assert set(got) == set(want)
    for k, ps in got.items():
        w = want[k]
        assert (ps.shape, ps.axes) == (tuple(w.shape), tuple(w.axes)), k
        assert _dtype(ps) == _dtype(w), k


@pytest.mark.parametrize("arch", configs.ARCH_NAMES)
def test_opt_state_axes_match_reference(arch):
    """The moments (and master / error feedback) mirror their
    parameter's axes in f32; the step is an int32 scalar."""
    jmodel, model = _models(arch)
    for kw in ({}, {"keep_master": True, "compress_grads": True}):
        want = _ref_flat(jopt.opt_state_specs(jmodel.param_specs(),
                                              jopt.OptConfig(**kw)))
        got = _port_flat(topt.opt_state_specs(model.param_specs(),
                                              topt.OptConfig(**kw)))
        assert set(got) == set(want)
        for k, ps in got.items():
            w = want[k]
            assert (ps.shape, ps.axes) == (tuple(w.shape),
                                           tuple(w.axes)), k
            assert _dtype(ps) == _dtype(w), k


@pytest.mark.parametrize("arch", configs.ARCH_NAMES)
def test_leaf_specs_match_reference_on_fake_meshes(arch):
    """``tree_shardings`` of every parameter and cache leaf on the
    production meshes equals the reference's ``logical_spec`` of that
    leaf, under both rule variants."""
    jmodel, model = _models(arch)
    trees = ((model.param_specs(), jmodel.param_specs(), lambda t: t),
             (model.cache_specs(8, 4096), jmodel.cache_specs(8, 4096),
              lambda t: _ref_cache_as_port(jmodel, model, t)))
    for port_tree, ref_tree, as_port in trees:
        want = _ref_flat(as_port(ref_tree))
        for sizes in MESHES.values():
            fm = FakeMesh(sizes)
            for port, ref in RULES.values():
                got = tree_shardings(port_tree, fm, port)
                for k in _port_flat(port_tree):
                    node = got
                    for key in k.split("/"):
                        node = node[int(key) if isinstance(
                            node, (list, tuple)) else key]
                    assert node == _want(want[k].axes, want[k].shape, fm,
                                         ref), k


#: every (H, KVH, m) up to H = 64 with m | H, KVH | H and m not dividing
#: KVH: the heads split over ``model`` and the KV heads expanded
KV_EXPANDED = [(h, kvh, m) for h in range(1, 65) for kvh in range(1, h + 1)
               for m in range(2, h + 1)
               if h % kvh == 0 and h % m == 0 and kvh % m]


@given(case=st.sampled_from(KV_EXPANDED), dh=st.integers(1, 3),
       seed=st.integers(0, 2**16))
@settings(max_examples=300, deadline=None)
def test_rank_kv_heads_expand_to_the_rank_query_heads(case, dh, seed):
    """On every rank: the KV heads its query heads read, [r h // G,
    ((r + 1) h - 1) // G], repeated to its h = H / m query heads equal
    every KV head repeated G-fold (the reference's ``jnp.repeat`` in
    ``attention_block``, numpy's ``repeat``; and the port's earlier
    ``repeat_interleave``) and cut to its query heads, ``torch.equal``."""
    h, kvh, m = case
    g, hl = h // kvh, h // m
    t = torch.from_numpy(np.random.default_rng(seed).standard_normal(
        (2, 3, kvh, dh)).astype(np.float32))
    ref = torch.from_numpy(np.repeat(t.numpy(), g, axis=2))
    for r in range(m):
        kv = spmd.rank_kv_heads(h, kvh, m, r)
        assert (kv.start, kv.stop - 1) == (r * hl // g,
                                           ((r + 1) * hl - 1) // g)
        got = C.expand_kv(t[:, :, kv.start:kv.stop], h, kvh, m, r)
        assert torch.equal(got, ref[:, :, r * hl:(r + 1) * hl])
        assert torch.equal(got, t.repeat_interleave(g, 2)
                           .narrow(2, r * hl, hl))

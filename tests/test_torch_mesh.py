"""The port's training mesh against the JAX package on the CPU: gloo
process groups of 4 and 2 ranks (``tests/torch_mesh_ranks.py``), the
counterparts of the reference's ``tests/test_multidevice.py``.

One (2, 2) group (data 2, model 2) runs every multi-rank check in one
spawn (module fixture ``runs``): the train step of a dense stack
(qwen3 smoke), of two dense stacks where ``model`` divides H but not
KVH, so each rank projects only the KV heads its query heads read
(``KV_SPLIT``: qwen3 smoke at H 6, KVH 3, rank 0 reading KV heads 0-1
and rank 1 heads 1-2, with ``k_norm``; qwen1.5-110b smoke at KVH 1,
both ranks reading the one head, with ``bk`` / ``bv``; whisper's cross
K/V at H 6, KVH 3 alone, ``CROSS_KV``), of five stacks where ``model``
does not divide H, so each rank computes its own run of whole heads
(``UNEVEN``: qwen3, whisper, recurrentgemma and rwkv6 at H 3, rank 0
computing heads 0-1 and rank 1 head 2; qwen3 at H 1, whose rank 1 holds
none and still makes every collective), of an MoE
(llama4-scout smoke, ``n_micro=2``) and of the
three families whose blocks are not plain attention (whisper's
encoder-decoder, recurrentgemma's RG-LRU and local attention, rwkv6's
time and channel mix), expert parallelism (deepseek-moe smoke: top 2
of 8 experts and 2 shared experts; the MoE block, and the whole model's
logits) and the decode over caches whose sequence is split over
``model`` (qwen3's; whisper's self and cross caches, recurrentgemma's
ring past its 16-slot window, rwkv6's states split by heads); a (1, 2)
group restores its checkpoint (the plan ``plan_elastic_mesh`` gives 2
ranks).  Without a spawn, every parameter and cache leaf of the three
families is placed as the reference's ``logical_spec`` places it on
(2, 2) and (1, 4).

The train steps are held in f32 against the reference's single-device
step with ``test_torch_train.py``'s tolerances (loss rel 1e-5; each
gradient rtol 1e-4 / atol 1e-6; parameters after three steps atol 2e-5,
its f32-noise elements at 2 lr a step, fewer than 1 % of a leaf beyond
2e-5); recurrentgemma's and rwkv6's gradients by the single-device
family test's rule for recurrent stacks (``RECURRENT``: each element
also within 1e-4 of the leaf's largest, the leaf's relative L2 within
1e-4), and at most ``RECURRENT_SLACK`` of a leaf's parameters beyond
2e-5 by that noise.  The mesh's step takes each
rank's rows in ``n_micro`` microbatches, so an MoE routes (and counts
its capacity and aux loss over) groups of B / (2 n_micro) rows: the
single-device step it equals is the reference's at ``2 n_micro``
microbatches.  Expert parallelism is held against the reference's
``_moe_compute(p, x, cfg, ep_size, ep_index)`` summed over the shards
(rtol 1e-5), and the model against the reference's unsharded model by
the reference test's criterion (more than 98 % of the logits within
3e-2); the sharded decode
against the reference's unsharded ``decode_step`` (f32 on both sides:
the contiguous path's 1e-4 of ``test_torch_model.py``, inside the
reference test's 2e-2).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data.pipeline import SyntheticPipeline as JPipeline
from repro.models import build_model as jbuild
from repro.models import components as JC
from repro.models.base import ParamSpec as JParamSpec
from repro.sharding import logical_spec as jlogical_spec
from repro.train import optimizer as jopt
from repro.train import step as jstep
from repro_torch import configs
from repro_torch.checkpoint import params_from_jax
from repro_torch.data import SyntheticPipeline
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import train as launch_train
from repro_torch.models import build_model
from repro_torch.models.base import ParamSpec
from repro_torch.runtime import plan_elastic_mesh
from repro_torch.sharding import tree_shardings
from repro_torch.train import optimizer as topt
from repro_torch.train import step as tstep
from repro_torch.tree import tree_items, tree_leaves
from test_torch_model import CONTIG_TOL, reference, to_port_config
from test_torch_train import (GRAD_ATOL, GRAD_RTOL, LOSS_RTOL, PARAM_ATOL,
                              _jcfg)
from test_sharding_rules import FakeMesh
from test_torch_sharding import _ref_cache_as_port
from test_torch_train_families import RECURRENT
import torch_mesh_ranks as ranks

MESH = (2, 2)
B, S, STEPS, LR = 8, 16, 3, 1e-3
TRAIN = {"dense": ("qwen3-0.6b", 1), "moe": ("llama4-scout-17b-a16e", 2),
         "whisper": ("whisper-tiny", 1),
         "recurrentgemma": ("recurrentgemma-2b", 1), "rwkv6": ("rwkv6-3b", 1),
         "kv_shared": ("qwen3-0.6b", 1), "kv_one": ("qwen1.5-110b", 1),
         "uneven": ("qwen3-0.6b", 1), "uneven_whisper": ("whisper-tiny", 1),
         "uneven_recurrentgemma": ("recurrentgemma-2b", 1),
         "uneven_rwkv6": ("rwkv6-3b", 1), "one_head": ("qwen3-0.6b", 1)}
#: the smoke configs' fields changed for the cases where model = 2
#: divides H but not KVH (both packages' configs built with them)
KV_SPLIT = {"kv_shared": {"n_heads": 6, "n_kv_heads": 3},
            "kv_one": {"n_kv_heads": 1}}
#: the smoke configs' fields changed for the cases where model = 2 does
#: not divide H: 48 columns of ``wq`` stored 24 a rank (1.5 heads), rank
#: 0 computing heads 0-1 and rank 1 head 2 (rwkv6's d_model 48 = H Dh,
#: as its decay needs); at H 1 rank 1 holds no heads
UNEVEN = {"uneven": {"n_heads": 3, "n_kv_heads": 1},
          "uneven_whisper": {"n_heads": 3, "n_kv_heads": 3},
          "uneven_recurrentgemma": {"n_heads": 3, "n_kv_heads": 1},
          "uneven_rwkv6": {"n_heads": 3, "n_kv_heads": 3, "d_model": 48},
          "one_head": {"n_heads": 1, "n_kv_heads": 1}}
#: the even cases whose grad step is also run with every split head's
#: leaves gathered and cut as an uneven split cuts them (``TP.cut``)
EVEN = ("dense", "moe", "whisper", "recurrentgemma", "rwkv6", "kv_shared",
        "kv_one")
#: the digests (``torch_mesh_ranks.digest``) of each even case's loss and
#: gradients as the grad step gave them on every rank before any split
#: of the heads was uneven (every rank the same): a fixed record that a
#: later change to the even path is held against.  rwkv6's recorded anew
#: once its decay LoRA's ``wd2`` and ``w0`` took only the rank's heads'
#: channels (``components.head_columns_linear``): the input gradient of
#: ``wd2`` became the ranks' partial products summed over model, and
#: ``w0``'s a sum of column sums (5e25f8ea15295ff5 before)
EVEN_DIGESTS = {"dense": "2d5db74e4f95c3ce", "moe": "152973d042549e90",
                "whisper": "ecfdb64d907ca2ef",
                "recurrentgemma": "bace84d149e1d478",
                "rwkv6": "b631a1b2fca3f96d", "kv_shared": "0e9cd90ec19a9fba",
                "kv_one": "d6b168911157a55c"}
#: whisper smoke's fields for ``encode_cross_kv`` with the heads split
#: over model = 2 but not the KV heads (rank 0 reads KV heads 0-1, rank
#: 1 heads 1-2), and the rows and frames of its encoder output
CROSS_KV, CROSS_B, CROSS_S = {"n_heads": 6, "n_kv_heads": 3}, 2, 5
#: the families whose decode on the mesh is held against the reference
FAMILIES = ("whisper", "recurrentgemma", "rwkv6")
DECODE_ROWS, DECODE_PROMPT, DECODE_LEN, DECODE_STEPS = 4, 32, 48, 3
MOE_TOL = 1e-5
CLOSE_TOL, CLOSE_FRAC = 3e-2, 0.98
#: the share of a recurrent stack's leaf whose parameters may move
#: beyond PARAM_ATOL by the f32 noise of their gradient (see the train
#: test)
RECURRENT_SLACK = 1e-3
#: sequence parallelism (SP_RULES) against the default layout on the
#: mesh, in f32: the loss (relative) and each leaf (relative L2)
SP_LOSS_RTOL, SP_GRAD_REL = 1e-6, 1e-5
#: qwen2-vl for SP: one layer, 12 positions, so its 8 patch embeddings
#: straddle the two sequence shards of 6
VL_LAYERS, VL_S = 1, 12
#: a sequence length model = 2 does not divide
ODD_S = 15
#: the leaves a rank consumes on its own sequence shard under SP
SHARD_LEAVES = ("ln1", "ln2", "ln_x", "final_norm", "enc_final_norm", "b2")


def _port_params(jcfg, tmp, name):
    """The reference's seeded parameters as the port's, saved for the
    ranks; (reference model, its params, port config)."""
    _, jparams, tree = reference(jcfg)
    cfg = to_port_config(jcfg)
    path = tmp / f"{name}.pt"
    torch.save(params_from_jax(tree, cfg, device="cpu"), path)
    return jbuild(jcfg), jparams, cfg, path


def _moe_inputs():
    """deepseek-moe smoke in f32: seeded MoE parameters (numpy) and
    tokens x (4, 8, D)."""
    jcfg = _jcfg("deepseek-moe-16b")
    rng = np.random.default_rng(7)
    specs = JC.moe_specs(jcfg)

    def draw(node):
        if isinstance(node, dict):
            return {k: draw(v) for k, v in node.items()}
        return (0.2 * rng.standard_normal(node.shape)).astype(np.float32)
    p = draw(specs)
    x = rng.standard_normal((4, 8, jcfg.d_model)).astype(np.float32)
    return jcfg, p, x


def _cross_kv_inputs():
    """whisper smoke at CROSS_KV in f32: seeded ``wk`` / ``wv``, an
    encoder output and the cotangents of the K/V repeated to every query
    head; (the ranks' job, the reference's config and inputs)."""
    jcfg = _jcfg("whisper-tiny", **CROSS_KV)
    rng = np.random.default_rng(11)
    d, hd = jcfg.d_model, jcfg.head_dim
    draw = {"wk": (d, jcfg.n_kv_heads * hd), "wv": (d, jcfg.n_kv_heads * hd),
            "enc": (CROSS_B, CROSS_S, d),
            "gk": (CROSS_B, CROSS_S, jcfg.n_heads, hd),
            "gv": (CROSS_B, CROSS_S, jcfg.n_heads, hd)}
    x = {k: (0.3 * rng.standard_normal(s)).astype(np.float32)
         for k, s in draw.items()}
    job = {"cfg": to_port_config(jcfg),
           **{k: torch.from_numpy(v) for k, v in x.items()}}
    return job, (jcfg, x)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The (2, 2) group's results beside the reference's inputs."""
    tmp = tmp_path_factory.mktemp("mesh")
    payload, refs = {"train": {}}, {}
    for name, (arch, n_micro) in TRAIN.items():
        jcfg = _jcfg(arch, **KV_SPLIT.get(name, {}), **UNEVEN.get(name, {}))
        jmodel, jparams, cfg, path = _port_params(jcfg, tmp, name)
        refs[name] = (jcfg, jmodel, jparams, n_micro)
        payload["train"][name] = {
            "cfg": cfg, "params": str(path), "B": B, "S": S,
            "n_micro": n_micro, "steps": STEPS,
            "ckpt": str(tmp / "ckpt") if name == "dense" else None}
    jcfg, p, x = _moe_inputs()
    payload["ep"] = {"cfg": to_port_config(jcfg), "x": torch.from_numpy(x),
                      "p": jax.tree.map(torch.from_numpy, p)}
    refs["moe_inputs"] = (jcfg, p, x)

    payload["cross_kv"], refs["cross_kv"] = _cross_kv_inputs()

    jcfg = _jcfg("deepseek-moe-16b")
    jmodel, jparams, cfg, path = _port_params(jcfg, tmp, "ep_model")
    batch = JPipeline(jcfg, B, 32).device_batch(0)
    refs["ep_model"] = (jcfg, jmodel, jparams, batch)
    payload["ep_model"] = {"cfg": cfg, "params": str(path), "B": B, "S": 32}

    payload["decode"], refs["decode"] = _decode_payload(
        refs["dense"], payload["train"]["dense"])
    payload["family_decode"], refs["family_decode"] = {}, {}
    for name in FAMILIES:
        payload["family_decode"][name], refs["family_decode"][name] = \
            _decode_payload(refs[name], payload["train"][name])

    jcfg = _jcfg("qwen2-vl-7b", n_layers=VL_LAYERS)
    jmodel, jparams, cfg, path = _port_params(jcfg, tmp, "sp_vl")
    refs["sp_vl"] = (jcfg, jmodel, jparams, 1)
    payload["sp_vl"] = {"cfg": cfg, "params": str(path), "B": B, "S": VL_S,
                        "n_micro": 1, "steps": 0}
    payload["sp_prefill"] = {"dense": payload["decode"],
                             **payload["family_decode"]}
    dense = payload["train"]["dense"]
    payload["sp_indivisible"] = {"cfg": dense["cfg"],
                                 "params": dense["params"], "B": B,
                                 "S": ODD_S}
    payload["tally"] = {"cfg": configs.get_smoke("qwen3-0.6b"), "B": B,
                        "S": S}
    payload["even_cut"] = {name: payload["train"][name] for name in EVEN}
    payload["call_log"] = payload["train"]["one_head"]
    return {"tmp": tmp, "payload": payload, "refs": refs,
            "out": ranks.spawn("mesh22", MESH, tmp, payload)}


def _decode_payload(ref, case):
    """The reference's prefill of DECODE_PROMPT tokens (whisper's with
    its frames) and DECODE_STEPS greedy decode steps: the ranks' job
    (batch, tokens fed) and the reference's logits of each step."""
    jcfg, jmodel, jparams, _ = ref
    batch = JPipeline(jcfg, DECODE_ROWS, DECODE_PROMPT).device_batch(0)
    batch = {k: batch[k] for k in ("tokens", "frames") if k in batch}
    _, cache = jax.jit(functools.partial(jmodel.prefill, max_len=DECODE_LEN))(
        jparams, batch)
    step = jax.jit(jmodel.decode_step)
    tok = batch["tokens"][:, :1]
    feed, logits = [], []
    for _ in range(DECODE_STEPS):
        feed.append(torch.from_numpy(np.array(tok[:, 0])).long())
        lg, cache = step(jparams, cache, tok)
        logits.append(np.asarray(lg, np.float32))
        tok = jnp.argmax(lg, -1)[:, None].astype(jnp.int32)
    tb = {k: torch.from_numpy(np.asarray(v, np.float32))
          for k, v in batch.items()}       # frames: bf16 values, exact
    tb["tokens"] = torch.from_numpy(np.array(batch["tokens"])).long()
    return ({"cfg": case["cfg"], "params": case["params"], "batch": tb,
             "max_len": DECODE_LEN, "feed": feed}, np.stack(logits))


#: the jitted ``value_and_grad`` of each reference model's loss, kept
#: with the model (one compile a model, not one a call)
_GRADS = {}


def _reference_grads(jmodel, jcfg, jparams, batch, n_ref):
    """The reference step's gradient: the mean over ``n_ref``
    microbatches of ``jax.grad`` of its loss, and its loss."""
    if id(jmodel) not in _GRADS:
        _GRADS[id(jmodel)] = (jmodel, jax.jit(jax.value_and_grad(
            jstep.make_loss_fn(jmodel, jcfg), has_aux=True)))
    grad = _GRADS[id(jmodel)][1]
    u = B // n_ref
    loss, gsum = 0.0, None
    for i in range(n_ref):
        mb = {k: v[i * u:(i + 1) * u] for k, v in batch.items()}
        (lv, _), g = grad(jparams, mb)
        loss += float(lv) / n_ref
        g = [np.asarray(t) for t in jax.tree.leaves(g)]
        gsum = g if gsum is None else [a + c for a, c in zip(gsum, g)]
    return loss, [g / n_ref for g in gsum]


def _expert_shard(p, ep: int, i: int):
    """Shard i of ``ep`` of the MoE parameters as the reference's
    ``moe_block`` hands them to ``_moe_compute``: its experts, and its
    slice of the shared expert's hidden dim."""
    def cut(t, dim):
        n = t.shape[dim] // ep
        return jax.lax.slice_in_dim(t, i * n, (i + 1) * n, axis=dim)
    return {"router": p["router"],
            **{k: cut(p[k], 0) for k in ("wg", "wu", "wd")},
            "shared": {"wg": cut(p["shared"]["wg"], 1),
                       "wu": cut(p["shared"]["wu"], 1),
                       "wd": cut(p["shared"]["wd"], 0)}}


def _first_grads(runs, name, S_=S):
    """The reference's first-step loss and gradient of a mesh case, at
    2 x n_micro microbatches (computed once a case)."""
    cache = runs.setdefault("first_grads", {})
    if name not in cache:
        jcfg, jmodel, jparams, n_micro = runs["refs"][name]
        cache[name] = _reference_grads(
            jmodel, jcfg, jparams, JPipeline(jcfg, B, S_).device_batch(0),
            MESH[0] * n_micro)
    return cache[name]


def _hold_grads(loss, grads, names, ref, recurrent):
    """A mesh step's loss and every leaf's gradient against the
    reference's (``_first_grads``) at the mesh test's tolerances."""
    want_loss, want = ref
    np.testing.assert_allclose(loss, want_loss, rtol=LOSS_RTOL)
    assert len(grads) == len(want) == len(names)
    for n, g, w in zip(names, grads, want):
        # the recurrent stacks' f32 noise, held as on one device
        # (test_torch_train_families.RECURRENT): each element also within
        # GRAD_RTOL of the leaf's largest gradient, the leaf's relative
        # L2 within GRAD_RTOL
        atol = GRAD_ATOL + (GRAD_RTOL * float(np.abs(w).max())
                            if recurrent else 0.0)
        np.testing.assert_allclose(g.numpy(), w, rtol=GRAD_RTOL,
                                   atol=atol, err_msg=n)
        if recurrent:
            assert (np.linalg.norm(g.numpy() - w)
                    <= GRAD_RTOL * np.linalg.norm(w)), n


def _names(out) -> list:
    return ["/".join(p) for p, _ in tree_items(out["params"])]


@pytest.mark.parametrize("name", list(TRAIN))
def test_train_step_on_mesh_matches_reference(runs, name):
    """The (2, 2) mesh's loss, every leaf's gradient and the parameters
    after three steps against the reference's single-device step at
    2 x n_micro microbatches."""
    jcfg, jmodel, jparams, n_micro = runs["refs"][name]
    out = runs["out"][0][name]
    m = MESH[1]
    if name in KV_SPLIT:
        assert jcfg.n_heads % m == 0 and jcfg.n_kv_heads % m
    if name in UNEVEN:
        assert jcfg.n_heads % m
    n_ref = MESH[0] * n_micro
    pipe = JPipeline(jcfg, B, S)
    want = _first_grads(runs, name)[1]
    names = _names(out)
    recurrent = TRAIN[name][0] in RECURRENT
    _hold_grads(out["grad_loss"], out["grads"], names,
                _first_grads(runs, name), recurrent)

    # the reference's step at n_ref microbatches: the first is its own
    # ``make_train_step`` (the scan accumulating in grad_accum_dtype);
    # the later ones the mean of the microbatches' gradients
    # (``_reference_grads``, summed in f32 in microbatch order as that
    # scan sums them, which holds while grad_accum_dtype is f32 and no
    # gradient is compressed), then its AdamW update
    opt = jopt.OptConfig(lr=LR, warmup_steps=1)
    assert jcfg.grad_accum_dtype == "float32" and not opt.compress_grads
    jtrain = jax.jit(jstep.make_train_step(jmodel, jcfg, opt=opt,
                                           n_micro=n_ref))
    jadamw = jax.jit(lambda p, g, s: jopt.adamw_update(p, g, s, opt))
    treedef = jax.tree.structure(jparams)
    state = jopt.init_opt_state(jparams, opt)
    noise = [np.zeros(np.shape(w), bool) for w in want]
    slack = [np.zeros(np.shape(w), bool) for w in want]
    params = jparams
    for step in range(STEPS):
        jb = pipe.device_batch(step)
        jloss, g = ((None, want) if step == 0 else
                    _reference_grads(jmodel, jcfg, params, jb, n_ref))
        noise = [m | ((np.abs(a) < GRAD_ATOL) & (a != 0))
                 for m, a in zip(noise, g)]
        # Adam moves an element by about lr g / |g|, so an error e in
        # its gradient moves it by about lr e / |g|: the recurrent
        # stacks' elements carry e up to GRAD_RTOL of the leaf's largest
        # gradient (above), so those whose gradient is below
        # LR / PARAM_ATOL times that may land beyond PARAM_ATOL
        if recurrent:
            slack = [m | (np.abs(a) < GRAD_RTOL * LR / PARAM_ATOL
                          * float(np.abs(a).max()))
                     for m, a in zip(slack, g)]
        if step == 0:
            params, state, jm = jtrain(params, state, jb)
            jloss = float(jm["loss"])
        else:
            params, state, _ = jadamw(
                params, jax.tree.unflatten(treedef, g), state)
        np.testing.assert_allclose(out["losses"][step], jloss,
                                   rtol=LOSS_RTOL)
    for n, p, jp, mask, loose in zip(names, tree_leaves(out["params"]),
                                     jax.tree.leaves(params), noise, slack):
        d = np.abs(p.numpy() - np.asarray(jp))
        # the f32-noise elements that needed their looser bound: fewer
        # than 1 % of the leaf (a leaf of 32 elements may hold one whose
        # reference gradient was noise and still land within PARAM_ATOL)
        over = d > PARAM_ATOL
        assert (mask & over).mean() < 1e-2, n
        # the recurrent stacks' elements beyond PARAM_ATOL by their
        # gradient's noise: at most RECURRENT_SLACK of the leaf (on the
        # CPU at most 3 of recurrentgemma's 16,384 embedding elements and
        # 1 of 8,192 in rwkv6's wk, wr and wv), held as the noise ones
        extra = over & ~mask & loose
        assert extra.mean() <= RECURRENT_SLACK, (n, int(extra.sum()))
        mask = mask | extra
        assert d[~mask].max(initial=0) <= PARAM_ATOL, n
        assert d[mask].max(initial=0) <= 2 * STEPS * LR, n


#: the SP cases: the TRAIN stacks and qwen2-vl at VL_LAYERS (its patch
#: embeddings and M-RoPE positions on sequence shards)
SP_CASES = (*TRAIN, "vl")


def _sp_out(runs, name):
    return runs["out"][0]["sp_vl" if name == "vl" else name]


@pytest.mark.parametrize("name", SP_CASES)
def test_sp_train_step_matches_reference(runs, name):
    """The grad step under ``SP_RULES`` (the residual stream on sequence
    shards over model) against the reference's single-device step, at
    the tolerances of ``test_train_step_on_mesh_matches_reference``."""
    out = _sp_out(runs, name)
    ref = (_first_grads(runs, "sp_vl", VL_S) if name == "vl"
           else _first_grads(runs, name))
    recurrent = name != "vl" and TRAIN[name][0] in RECURRENT
    _hold_grads(out["sp_loss"], out["sp_grads"], _names(out), ref,
                recurrent)


@pytest.mark.parametrize("name", SP_CASES)
def test_sp_train_step_matches_default_layout(runs, name):
    """The grad step under ``SP_RULES`` against the same mesh's step
    under the default rules, in f32: the loss within 1e-6 relative
    (bit-equal in every case here: on a model axis of 2 a sum of two
    partials does not depend on their order), every leaf within 1e-5
    relative L2 and none without a gradient."""
    out = _sp_out(runs, name)
    np.testing.assert_allclose(out["sp_loss"], out["grad_loss"],
                               rtol=SP_LOSS_RTOL)
    for n, g, w in zip(_names(out), out["sp_grads"], out["grads"]):
        assert torch.linalg.norm(g - w) <= SP_GRAD_REL * torch.linalg.norm(
            w), n
        assert bool(g.ne(0).any()) == bool(w.ne(0).any()), n


@pytest.mark.parametrize("name", list(TRAIN))
def test_sp_shard_leaves_get_their_whole_gradient(runs, name):
    """The replicated leaves a rank consumes on its own sequence shard
    under SP (the norms' scales and biases, a bias added after the
    row-parallel sum) get the sum over model of the ranks' shares: the
    default layout's gradient within 1e-5, where one rank's share alone
    would lie about 1 / 2 from it."""
    out = runs["out"][0][name]
    held = 0
    for n, g, w in zip(_names(out), out["sp_grads"], out["grads"]):
        if any(part in SHARD_LEAVES for part in n.split("/")):
            assert torch.linalg.norm(g - w) <= SP_GRAD_REL * \
                torch.linalg.norm(w), n
            held += 1
    assert held >= 3


@pytest.mark.parametrize("name", ("dense", *FAMILIES))
def test_sp_prefill_equals_default_layout(runs, name):
    """A prefill under ``SP_RULES`` (heads whole on every rank, as a
    prefill that builds a cache runs them, on the gathered sequence)
    gives every rank the logits and cache shards of the default
    layout's prefill, ``torch.equal``."""
    for out in runs["out"]:
        got = out["sp_prefill"][name]
        assert got["leaves"] > 0
        assert got["logits"] and got["cache"]


def test_sp_indivisible_length_is_default_layout(runs):
    """At a sequence length model does not divide (15 on model = 2) the
    stream stays whole, as the reference's soft ``logical_spec`` falls
    back: the grad step under ``SP_RULES`` gives the default rules'
    loss, gradients and collectives bit for bit on every rank."""
    assert ODD_S % MESH[1]
    for out in runs["out"]:
        assert out["sp_indivisible"] == {"loss": True, "tally": True,
                                         "grads": True}


@pytest.mark.parametrize("name", EVEN)
def test_even_split_equals_the_cut_path(runs, name):
    """Where model = 2 divides H, the grad step with every split head's
    leaves gathered over model and cut to the rank's heads (the uneven
    split's path, ``TP.cut`` forced) gives the stored-shard path's loss
    and every gradient ``torch.equal`` on every rank: the head ranges of
    an even split are the stored shards, so the uneven machinery leaves
    the even split's bits as they were."""
    for out in runs["out"]:
        got = out["even_cut"][name]
        assert got["leaves"] > 0
        assert got["loss"] and got["grads"]


@pytest.mark.parametrize("name", EVEN)
def test_even_split_keeps_its_recorded_bits(runs, name):
    """Where model = 2 divides H, the grad step's loss and every gradient
    on every rank have the bits recorded before the heads could split
    unevenly (``EVEN_DIGESTS``)."""
    assert [out["even_cut"][name]["digest"] for out in runs["out"]] == \
        [EVEN_DIGESTS[name]] * len(runs["out"])


def test_zero_head_rank_makes_every_collective(runs):
    """qwen3 smoke at H 1 on model = 2: rank 1 holds no heads, yet in the
    grad step the ranks of each group make the same collectives over it,
    in the same order, with the same input shapes (a rank that skipped
    one would leave its group waiting): over ``model`` ranks 2 r and
    2 r + 1, over ``data`` ranks r and r + 2."""
    logs = [out["call_log"] for out in runs["out"]]
    assert [g["heads"] for g in logs] == [1, 0] * MESH[0]
    groups = {("model",): [(0, 1), (2, 3)], ("data",): [(0, 2), (1, 3)]}
    for axes, members in groups.items():
        for ranks_ in members:
            calls = [logs[r]["calls"].get(axes) for r in ranks_]
            assert calls[0] and all(c == calls[0] for c in calls), axes
    assert set(logs[0]["calls"]) == set(groups)


@pytest.mark.parametrize("rules", ["default", "sp"])
def test_live_collectives_equal_dry_run_tally(runs, rules):
    """Rank 0's collectives in the grad step of qwen3 smoke (bf16, as
    the dry run's kernels take it) on (2, 2), calls and input bytes by
    kind, are the tally of the same step, config, batch, microbatches
    and rules traced on ``make_dry_mesh((2, 2))``: the dry run counts
    what runs."""
    from repro_torch.configs import ShapeSpec
    from repro_torch.launch.dryrun import collective_tally
    from repro_torch.sharding.rules import RULE_VARIANTS
    case = runs["payload"]["tally"]
    live = runs["out"][0]["tally"][rules]
    dry = collective_tally(case["cfg"], ShapeSpec("mesh22", S, B, "train"),
                           tmesh.make_dry_mesh(MESH, ("data", "model")),
                           RULE_VARIANTS[rules])

    def counts(tally):
        return {k: (v["calls"], v["bytes"]) for k, v in tally.items()}
    assert counts(live) and counts(live) == counts(dry)


@pytest.mark.parametrize("cards,backend", [(1, "gloo"), (2, "gloo"),
                                           (4, "nccl")])
def test_device_plan(monkeypatch, cards, backend):
    """Four ranks take a card each over NCCL where four cards are
    visible; with fewer, every rank shares ``cuda:0`` over gloo (never a
    mix)."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    devices, got = tmesh.device_plan(4)
    want = ([torch.device("cuda", r) for r in range(4)] if cards >= 4
            else [torch.device("cuda", 0)] * 4)
    assert devices == want and got == backend


def test_expert_parallel_moe_matches_reference_shards(runs):
    """Each rank's MoE output on its data rows equals the reference's
    ``_moe_compute`` at ``ep_size`` 2 summed over the two expert shards
    (rtol 1e-5), the aux loss its shard's."""
    jcfg, p, x = runs["refs"]["moe_inputs"]
    jp = jax.tree.map(jnp.asarray, p)
    jmoe = jax.jit(JC._moe_compute, static_argnums=(2, 3, 4))
    ep, dp = MESH[1], MESH[0]
    n = x.shape[0] // dp
    for rank, out in enumerate(runs["out"]):
        d = rank // MESH[1]
        assert out["ep"]["tp"] == (True, True)
        xs = jnp.asarray(x[d * n:(d + 1) * n])
        parts = [jmoe(_expert_shard(jp, ep, i), xs, jcfg, ep, i)
                 for i in range(ep)]
        want = sum(np.asarray(y) for y, _ in parts)
        np.testing.assert_allclose(out["ep"]["y"].numpy(), want,
                                   rtol=MOE_TOL, atol=MOE_TOL)
        np.testing.assert_allclose(out["ep"]["aux"], float(parts[0][1]),
                                   rtol=MOE_TOL)


def test_expert_parallel_model_close_to_unsharded_reference(runs):
    """The reference test's criterion (``test_moe_shardmap_matches_
    single_device``: deepseek-moe smoke, B 8 x S 32): the mesh's logits,
    each data shard routed with its own capacity, against the
    reference's unsharded ``apply``: more than 98 % within 3e-2."""
    jcfg, jmodel, jparams, batch = runs["refs"]["ep_model"]
    want = np.asarray(jax.jit(lambda p, b: jmodel.apply(
        p, b, train=False))(jparams, batch)[0], np.float32)
    got = np.concatenate([out["ep_model"].numpy() for rank, out in
                          enumerate(runs["out"]) if rank % MESH[1] == 0])
    close = np.mean(np.isclose(got, want, rtol=CLOSE_TOL, atol=CLOSE_TOL))
    assert close > CLOSE_FRAC, close


def test_cross_kv_projects_only_the_rank_kv_heads(runs):
    """whisper's cross K/V with H 6 split over model = 2 and KVH 3 not:
    each rank's K/V, from the KV heads its 3 query heads read, against
    the reference's ``encode_cross_kv`` repeated G-fold to every query
    head and cut to the rank's (rtol 1e-5); the gradients of a loss of
    them against ``jax.vjp`` of the same: the encoder output's on every
    rank, ``wk`` / ``wv``'s as the sum of the ranks' shares over model
    (each zero outside the columns its rank read), at the train test's
    tolerances."""
    jcfg, x = runs["refs"]["cross_kv"]
    g, m = jcfg.n_heads // jcfg.n_kv_heads, MESH[1]
    h = jcfg.n_heads // m
    assert jcfg.n_heads % m == 0 and jcfg.n_kv_heads % m

    def ref(wk, wv, enc):
        k, v = JC.encode_cross_kv({"wk": wk, "wv": wv}, enc, jcfg)
        return jnp.repeat(k, g, axis=2), jnp.repeat(v, g, axis=2)
    (k, v), vjp = jax.vjp(ref, *(jnp.asarray(x[n])
                                 for n in ("wk", "wv", "enc")))
    dwk, dwv, denc = (np.asarray(t) for t in vjp(
        (jnp.asarray(x["gk"]), jnp.asarray(x["gv"]))))
    outs = [out["cross_kv"] for out in runs["out"]]
    for rank, out in enumerate(outs):
        r = rank % m
        for name, want in (("k", k), ("v", v)):
            np.testing.assert_allclose(
                out[name].numpy(), np.asarray(want)[:, :, r * h:(r + 1) * h],
                rtol=MOE_TOL, atol=MOE_TOL, err_msg=name)
        np.testing.assert_allclose(out["enc"].numpy(), denc, rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL)
        kv = range(r * h // g, ((r + 1) * h - 1) // g + 1)
        cols = np.zeros(jcfg.n_kv_heads * jcfg.head_dim, bool)
        cols[kv.start * jcfg.head_dim:kv.stop * jcfg.head_dim] = True
        assert not out["wk"][:, ~cols].any() and not out["wv"][:, ~cols].any()
    for name, want in (("wk", dwk), ("wv", dwv)):
        for d in range(MESH[0]):
            got = sum(outs[d * m + r][name] for r in range(m))
            np.testing.assert_allclose(got.numpy(), want, rtol=GRAD_RTOL,
                                       atol=GRAD_ATOL, err_msg=name)


def _check_decode(runs, dec, want):
    """Every rank's decode (the cut cache and the mesh's own prefill)
    against the reference's logits of its data rows, and the mesh
    prefill's cache shards as ``cache_specs`` places them."""
    n = DECODE_ROWS // MESH[0]
    for rank, out in enumerate(runs["out"]):
        rows = want[:, (rank // MESH[1]) * n:][:, :n]
        for form in ("cut", "made"):
            np.testing.assert_allclose(dec[rank][form].numpy(), rows,
                                       rtol=CONTIG_TOL, atol=CONTIG_TOL,
                                       err_msg=form)
        for got, placed in dec[rank]["shapes"]:
            assert got == placed


def test_decode_on_sequence_sharded_cache_matches_reference(runs):
    """Decode steps over a cache whose sequence is split over ``model``
    (cut from the whole prefill, or made by a prefill on the mesh)
    against the reference's unsharded ``decode_step``: every rank holds
    its data rows' logits."""
    dec = [out["decode"] for out in runs["out"]]
    assert all(d["seq_shards"] == (MESH[1], MESH[1]) for d in dec)
    _check_decode(runs, dec, runs["refs"]["decode"])


@pytest.mark.parametrize("name", FAMILIES)
def test_family_decode_on_mesh_matches_reference(runs, name):
    """whisper (self and cross caches split along their sequence, heads
    gathered for the step), recurrentgemma (its 16-slot ring cut along
    its slots, after a 32-token prompt: wrapped before the first step)
    and rwkv6 (WKV states split by heads, no attention cache): decode
    steps on the mesh against the reference's unsharded ``decode_step``
    within CONTIG_TOL, the caches and states split as ``cache_specs``
    places them."""
    dec = [out["family_decode"][name] for out in runs["out"]]
    split = {"whisper": {"self": MESH[1], "cross": MESH[1]},
             "recurrentgemma": MESH[1], "rwkv6": 1}[name]
    assert all(d["seq_shards"] == (split, split) for d in dec)
    if name == "recurrentgemma":
        assert DECODE_PROMPT > runs["payload"]["train"][name][
            "cfg"].local_window
    _check_decode(runs, dec, runs["refs"]["family_decode"][name])


def test_checkpoint_restores_onto_elastic_mesh(runs):
    """The (2, 2) run's checkpoint (params and optimizer state, saved
    from the shards) restored onto the mesh ``plan_elastic_mesh`` gives
    2 ranks at model parallelism 2: every leaf gathered back equal to
    what was saved."""
    shape, axes = plan_elastic_mesh(2, model_parallel=MESH[1])
    assert (shape, axes) == ((1, 2), ("data", "model"))
    case = runs["payload"]["train"]["dense"]
    got = ranks.spawn("restore", shape, runs["tmp"],
                      {"cfg": case["cfg"], "params": case["params"],
                       "ckpt": case["ckpt"]})
    saved = runs["out"][0]["dense"]["saved"]
    for r in got:
        assert r["step"] == STEPS
        for (path, a), (_, b) in zip(tree_items(r["full"]),
                                     tree_items(saved)):
            assert torch.equal(a, b), "/".join(path)
    # the shards are halves over model where the rules split a leaf
    assert any(s != t.shape for s, t in zip(got[0]["shard_shapes"],
                                            tree_leaves(saved)))


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "deepseek-moe-16b"])
def test_one_rank_mesh_is_no_mesh(arch):
    """Two train steps (bf16 compute) under a (1, 1) mesh give every
    leaf, moment and metric ``torch.equal`` to the steps without one."""
    cfg = configs.get_smoke(arch)
    model = build_model(cfg, device="cpu")
    mesh = tmesh.make_mesh((1, 1), ("data", "model"), devices=["cpu"])
    step = tstep.make_train_step(model, cfg)
    pipe = SyntheticPipeline(cfg, 4, 16)
    runs_ = []
    for under in (False, True):
        params = model.init(seed=3)
        state = topt.init_opt_state(params)
        metrics = []
        for s in range(2):
            if under:
                with mesh:
                    params, state, m = step(params, state,
                                            pipe.device_batch(s, mesh=mesh))
            else:
                params, state, m = step(params, state,
                                        pipe.device_batch(s, "cpu"))
            metrics.append(m)
        runs_.append((params, state, metrics))
    (p0, s0, m0), (p1, s1, m1) = runs_
    for a, b in zip(tree_leaves({"p": p0, "s": s0}),
                    tree_leaves({"p": p1, "s": s1})):
        assert torch.equal(a, b)
    for a, b in zip(m0, m1):
        assert all(torch.equal(a[k], b[k]) for k in a)


def test_launcher_at_world_one_is_the_one_device_run(tmp_path):
    """Without torchrun the launcher builds no mesh and trains as the
    single-device step does."""
    drv = launch_train.main(["--arch", "qwen3-0.6b", "--smoke", "--device",
                             "cpu", "--steps", "2", "--batch", "2", "--seq",
                             "16", "--log-every", "1", "--ckpt-dir",
                             str(tmp_path)])
    cfg = configs.get_smoke("qwen3-0.6b")
    model = build_model(cfg, device="cpu")
    step = tstep.make_train_step(model, cfg)
    params = model.init(seed=0)
    state = topt.init_opt_state(params)
    pipe = SyntheticPipeline(cfg, 2, 16)
    for s in range(2):
        params, state, m = step(params, state, pipe.device_batch(s, "cpu"))
        assert drv.metrics_log[s]["loss"] == float(m["loss"])


def test_production_mesh_refuses_other_worlds(monkeypatch):
    """(16, 16) needs 256 ranks and (2, 16, 16) 512; a world of another
    size is refused, never shrunk to fit."""
    for world, multi in ((4, False), (1, False), (256, True)):
        monkeypatch.setenv("WORLD_SIZE", str(world))
        with pytest.raises(ValueError, match="needs (256|512) ranks"):
            tmesh.make_production_mesh(multi_pod=multi)
    with pytest.raises(ValueError, match="does not divide"):
        tmesh.make_local_mesh(model=3, devices=["cpu"] * 4)


class _Mesh:
    """Axis sizes without ranks (placement only)."""

    def __init__(self, **sizes):
        self.axis_names = tuple(sizes)
        self.shape = tuple(sizes.values())

    def axis_size(self, axes):
        axes = (axes,) if isinstance(axes, str) else axes
        return int(np.prod([self.shape[self.axis_names.index(a)]
                            for a in axes if a in self.axis_names]))


@pytest.mark.parametrize("arch", ["whisper-tiny", "recurrentgemma-2b",
                                  "rwkv6-3b"])
def test_family_leaves_placed_as_reference(arch):
    """On (2, 2) and (1, 4) every parameter leaf of the smoke config
    (``placement``) and every leaf of its decode cache
    (``tree_shardings(cache_specs)``, a prompt past recurrentgemma's
    window) gets the reference's ``logical_spec``; some leaf splits
    over ``model``."""
    cfg = configs.get_smoke(arch)
    model = build_model(cfg, device="cpu")
    jmodel = jbuild(_jcfg(arch))
    for data, mp in ((2, 2), (1, 4)):
        mesh = _Mesh(data=data, model=mp)
        fake = FakeMesh({"data": data, "model": mp})
        placed = [spec for _, (spec, _) in tree_items(model.placement(mesh))]
        want = [_ref_spec(ps, fake) for ps in
                jax.tree.leaves(jmodel.param_specs(), is_leaf=_is_jspec)]
        assert placed == want
        assert any("model" in tmesh.spec_axes(e) for s in placed
                   for e in s)
        cache = model.cache_specs(4, 48)
        jcache = _ref_cache_as_port(jmodel, model, jmodel.cache_specs(4, 48))
        got = _flat_specs(tree_shardings(cache, mesh), cache)
        ref = _flat_specs(jcache, jcache)
        assert set(got) == set(ref)
        for k, spec in got.items():
            assert spec == _ref_spec(ref[k], fake), k


def _is_jspec(x) -> bool:
    return isinstance(x, JParamSpec)


def _ref_spec(ps, fake):
    """The reference's ``logical_spec`` of one of its specs, as the
    port writes a spec (a tuple of entries)."""
    return tuple(jlogical_spec(ps.axes, ps.shape, fake))


def _flat_specs(tree, like) -> dict:
    """{path: leaf} of a spec or sharding tree, walked by the matching
    spec tree ``like`` (lists by index)."""
    if isinstance(like, (ParamSpec, JParamSpec)):
        return {"": tree}
    items = (like.items() if isinstance(like, dict)
             else enumerate(like))
    out = {}
    for k, v in items:
        for path, leaf in _flat_specs(tree[k], v).items():
            out[f"{k}/{path}".rstrip("/")] = leaf
    return out


def test_production_mesh_places_every_leaf():
    """On the (16, 16) production mesh every leaf of qwen3-0.6b and
    deepseek-moe-16b is split only by axes that divide it (the ranks'
    shards cover it exactly)."""
    for arch in ("qwen3-0.6b", "deepseek-moe-16b"):
        model = build_model(configs.get(arch), device="cpu")
        mesh = _Mesh(data=16, model=16)
        for (path, (spec, axes)), (_, ps) in zip(
                tree_items(model.placement(mesh)),
                tree_items(model.param_specs())):
            for dim, entry in enumerate(spec):
                n = mesh.axis_size(tmesh.spec_axes(entry))
                assert ps.shape[dim] % n == 0, path

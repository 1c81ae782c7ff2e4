"""The port's training step against its own arithmetic on the CPU: the
remat's recompute of a block skips the block's dead last product, and
RWKV6's LoRA weight gradients split over ``model``.

* ``components.remat`` (``cfg.remat == "full"``) recomputes a block in
  the backward until the last tensor its forward saved; the block's last
  product, marked ``last`` (the dense FFN's ``wd`` / ``w2``, whole or
  row-parallel, and the MoE's shared expert's ``wd``), saves its
  operands there and launches nothing.  For each of the ten
  architectures at smoke size, in f32 and in the default dtype, one
  grad step under remat gives the loss and every gradient leaf
  ``torch.equal`` to the same step without it: a skipped product whose
  output the backward read would break it.
* On the dry (16, 16) mesh at full widths (``launch/dryrun.py``), the
  dataflow GEMM's calls a weight and microbatch: 4 (forward, recompute,
  dX, dW) for each product, 3 for a dead one; the routed experts'
  ``bmm``s and RWKV6's channel mix (``wv``, whose output the gate's
  gradient reads; ``wr``) still 4; RWKV6's LoRA weights form only their
  1 / 16 of dW's columns, ``wd2`` only the columns of the rank's heads.
* rwkv6 on a (1, 2) gloo group, at H 3 (heads 2 / 1) and at an even H:
  the loss and every gradient (the LoRA's among them) within the mesh
  tests' f32 tolerances of the single device's, and ``wd2`` formed on
  the rank's columns only.
"""
import collections
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import configs
from repro_torch.cost import OpCounter
from repro_torch.data import SyntheticPipeline
from repro_torch.kernels.gemm_dataflow import ops as gemm
from repro_torch.launch import dryrun
from repro_torch.models import build_model
from repro_torch.models.rwkv6 import DECAY_LORA, TM_LORA
from repro_torch.sharding import spmd
from repro_torch.train import step as tstep
from repro_torch.tree import tree_items, tree_leaves, tree_map
from test_torch_dryrun import MESHES
from test_torch_train import GRAD_ATOL, GRAD_RTOL, LOSS_RTOL
import torch_mesh_ranks as ranks

#: the smoke batch of the equality checks
B, S = 2, 32
#: the (1, 2) group's rwkv6 cases: model 2 splits H 3 as 2 / 1 (d_model
#: 48 = H Dh, as the decay needs) and H 2 evenly; d_ff 96 and 80 rows, so
#: that no other product of the step has a shape of the decay LoRA's
LORA_CASES = {"uneven": {"n_heads": 3, "n_kv_heads": 3, "d_model": 48,
                         "d_ff": 96},
              "even": {"n_heads": 2, "n_kv_heads": 2, "d_model": 32,
                       "d_ff": 96}}
LORA_B, LORA_S = 5, 16


def _grad_step(cfg, params, batch):
    """(loss, every leaf's gradient) of one grad step of ``cfg``."""
    model = build_model(cfg, device="cpu")
    p = tree_map(lambda t: t.detach().clone().requires_grad_(), params)
    loss, _ = tstep.make_loss_fn(model, cfg)(p, batch)
    return loss.detach(), torch.autograd.grad(loss, tree_leaves(p))


@pytest.mark.parametrize("dtype", ["float32", "default"])
@pytest.mark.parametrize("arch", configs.ARCH_NAMES)
def test_remat_gives_the_bits_of_no_remat(arch, dtype):
    cfg = configs.get_smoke(arch)
    if dtype == "float32":
        cfg = dataclasses.replace(cfg, compute_dtype="float32")
    params = build_model(cfg, device="cpu").init(seed=0)
    batch = SyntheticPipeline(cfg, B, S).device_batch(0, "cpu")
    full = _grad_step(dataclasses.replace(cfg, remat="full"), params, batch)
    none = _grad_step(dataclasses.replace(cfg, remat="none"), params, batch)
    assert torch.equal(full[0], none[0])
    names = ["/".join(path) for path, _ in tree_items(params)]
    for name, a, b in zip(names, full[1], none[1]):
        assert torch.equal(a, b), name


# ------------------------------------------------ the dry run's launches
def _dry_launches(arch, n_layers, monkeypatch):
    """``arch`` at ``train_4k`` with ``n_layers`` layers on the dry
    (16, 16) mesh: (config, the cell's result, its microbatch's tokens,
    the dataflow GEMM's calls keyed by weight, the ``bmm``s' count).  A
    GEMM call (M, N, K) is keyed (K, N), or (M, N) for a dW, whose K is
    the tokens: a weight (K_w, N_w) is called at (K_w, N_w) for its
    forward, its recompute and its dW (at (K_w, N_w / m) where the dW
    is split), and at (N_w, K_w) for its dX."""
    cfg = dryrun.apply_overrides(configs.get(arch),
                                 {"n_layers": str(n_layers)})
    seen, bmm = [], []
    cost, dispatch = gemm.cost, OpCounter.__torch_dispatch__

    def spy(m, n, k, dtype):
        seen.append((m, n, k))
        return cost(m, n, k, dtype)

    def count(self, func, types, args=(), kwargs=None):
        if func is torch.ops.aten.bmm.default:
            bmm.append(func)
        return dispatch(self, func, types, args, kwargs)
    monkeypatch.setattr(gemm, "cost", spy)
    monkeypatch.setattr(OpCounter, "__torch_dispatch__", count)
    res = dryrun.run_cell(cfg.name, "train_4k", "single", cfg=cfg)
    s = configs.shape_by_name("train_4k")
    tokens = s.global_batch // MESHES["single"]["data"] // res["n_micro"] \
        * s.seq_len
    got = collections.Counter()
    for m, n, k in seen:
        assert tokens in (m, k), (m, n, k)
        got[(m, n) if k == tokens else (k, n)] += 1
    assert res["kernels"]["gemm_dataflow"]["launches"] == len(seen)
    return cfg, res, got, len(bmm)


def _want(products, n):
    """The calls ``_dry_launches`` keys for ``products``: (K_w, N_w,
    forward runs (2, or 1 for a dead product), dW's (K, N)) each, over
    ``n`` layers and microbatches."""
    want = collections.Counter()
    for kw, nw, runs, dw in products:
        want[kw, nw] += runs * n
        want[nw, kw] += n
        want[dw] += n
    return want


def _dense_block(cfg, m):
    """A split attention block's products on rank 0 (its query heads
    and the KV heads they read)."""
    D, dh = cfg.d_model, cfg.head_dim
    q = len(spmd.rank_heads(cfg.n_heads, m, 0)) * dh
    kv = len(spmd.rank_kv_heads(cfg.n_heads, cfg.n_kv_heads, m, 0)) * dh
    return [(D, q, 2, (D, q)), (D, kv, 2, (D, kv)), (D, kv, 2, (D, kv)),
            (q, D, 2, (q, D))]


def _ffn(D, f):
    """A SwiGLU FFN of hidden width f: its down projection dead."""
    return [(D, f, 2, (D, f)), (D, f, 2, (D, f)), (f, D, 1, (f, D))]


def test_dead_products_launch_three_times_qwen3(monkeypatch):
    """qwen3-0.6b, 2 layers: every projection 4 GEMMs a layer and
    microbatch, the FFN's row-parallel ``wd`` (F / m, D) 3."""
    m = MESHES["single"]["model"]
    cfg, res, got, n_bmm = _dry_launches("qwen3-0.6b", 2, monkeypatch)
    n = cfg.n_layers * res["n_micro"]
    products = _dense_block(cfg, m) + _ffn(cfg.d_model, cfg.d_ff // m)
    assert got == _want(products, n)
    assert sum(got.values()) == (4 * len(products) - 1) * n
    assert n_bmm == 0


def test_dead_products_launch_three_times_deepseek(monkeypatch):
    """deepseek-moe-16b, 2 layers (a leading dense layer, an MoE layer):
    the dense FFN's ``wd`` and the shared expert's ``wd`` 3 GEMMs a
    microbatch, every other projection (the f32 router's too) 4; the
    routed experts' three batched products 4 ``bmm``s each (the gate
    weight's gradient reads their ``wd``'s output)."""
    m = MESHES["single"]["model"]
    cfg, res, got, n_bmm = _dry_launches("deepseek-moe-16b", 2, monkeypatch)
    mc, D, n_micro = cfg.moe, cfg.d_model, res["n_micro"]
    assert mc.first_dense == 1 and cfg.n_layers == 2
    attn = _dense_block(cfg, m)
    fs = mc.d_expert_ff * mc.n_shared // m
    want = (_want(attn + _ffn(D, mc.dense_d_ff // m), n_micro)
            + _want(attn + [(D, mc.n_experts, 2, (D, mc.n_experts))]
                    + _ffn(D, fs), n_micro))
    assert got == want
    assert n_bmm == 4 * 3 * n_micro


def test_rwkv6_lora_splits_its_weight_gradients(monkeypatch):
    """rwkv6-3b, 1 layer (rank 0: heads 0-2 of 40): the token mix's
    ``tm_w1`` and ``tm_w2`` and the decay's ``wd1`` form 1 / 16 of their
    dW's columns (``components.replicated_linear``); ``wd2`` its 3 heads'
    192 columns in the forward, its recompute, dX and dW
    (``components.head_columns_linear``), never the whole D; no product
    is dead (the channel mix's ``wv`` and ``wr`` 4 GEMMs each)."""
    m = MESHES["single"]["model"]
    cfg, res, got, n_bmm = _dry_launches("rwkv6-3b", 1, monkeypatch)
    D, F = cfg.d_model, cfg.d_ff
    cols = len(spmd.rank_heads(cfg.n_heads, m, 0)) * cfg.head_dim
    lora = ([(D, 5 * TM_LORA, 2, (D, 5 * TM_LORA // m))]
            + [(TM_LORA, D, 2, (TM_LORA, D // m))] * 5
            + [(D, DECAY_LORA, 2, (D, DECAY_LORA // m)),
               (DECAY_LORA, cols, 2, (DECAY_LORA, cols))])
    heads = [(D, cols, 2, (D, cols))] * 4 + [(cols, D, 2, (cols, D))]
    channel = [(D, F // m, 2, (D, F // m)), (F // m, D, 2, (F // m, D)),
               (D, D, 2, (D, D // m))]
    products = lora + heads + channel
    assert got == _want(products, cfg.n_layers * res["n_micro"])
    assert sum(got.values()) == 4 * len(products) * res["n_micro"]


# --------------------------------------- rwkv6's LoRA on a (1, 2) group
@pytest.fixture(scope="module")
def lora_runs(tmp_path_factory):
    """Each LORA_CASES case in f32: its config, the single device's grad
    step and the (1, 2) group's, on the same seeded parameters."""
    tmp = tmp_path_factory.mktemp("lora")
    cases, single = {}, {}
    for name, kw in LORA_CASES.items():
        cfg = dataclasses.replace(configs.get_smoke("rwkv6-3b"),
                                  compute_dtype="float32", **kw)
        params = build_model(cfg, device="cpu").init(seed=3)
        batch = SyntheticPipeline(cfg, LORA_B, LORA_S).device_batch(0, "cpu")
        single[name] = _grad_step(cfg, params, batch)
        cases[name] = {"cfg": cfg, "params": params, "B": LORA_B,
                       "S": LORA_S}
    out = ranks.spawn("lora", (1, 2), tmp, cases)
    return cases, single, out


@pytest.mark.parametrize("name", list(LORA_CASES))
def test_rwkv6_lora_on_mesh_matches_single_device(lora_runs, name):
    """The loss and every gradient on both ranks against the single
    device's at the mesh tests' f32 tolerances for a recurrent stack
    (each element also within GRAD_RTOL of the leaf's largest, the
    leaf's relative L2 within GRAD_RTOL)."""
    cases, single, out = lora_runs
    loss, grads = single[name]
    names = ["/".join(path) for path, _ in tree_items(cases[name]["params"])]
    assert any("wd2" in n for n in names) and any("tm_w1" in n for n in names)
    for got in (o[name] for o in out):
        np.testing.assert_allclose(got["loss"], float(loss), rtol=LOSS_RTOL)
        assert len(got["grads"]) == len(grads)
        for n, g, w in zip(names, got["grads"], grads):
            w = w.numpy()
            atol = GRAD_ATOL + GRAD_RTOL * float(np.abs(w).max())
            np.testing.assert_allclose(g.numpy(), w, rtol=GRAD_RTOL,
                                       atol=atol, err_msg=n)
            assert (np.linalg.norm(g.numpy() - w)
                    <= GRAD_RTOL * np.linalg.norm(w)), n


@pytest.mark.parametrize("name", list(LORA_CASES))
def test_rwkv6_wd2_is_formed_on_the_rank_columns(lora_runs, name):
    """Each rank's products: ``wd2`` (64, D) enters at the columns of
    the rank's heads only (2 x 16 and 1 x 16 at H 3, 16 each at H 2),
    in the forward and its recompute, and its dW is formed on them; a
    (rows, 64) x (64, D) product is ``wd1``'s dX alone, once a layer."""
    cases, _, out = lora_runs
    cfg = cases[name]["cfg"]
    D, rows, L = cfg.d_model, LORA_B * LORA_S, cfg.n_layers
    for r, o in enumerate(out):
        cols = len(spmd.rank_heads(cfg.n_heads, 2, r)) * cfg.head_dim
        shapes = collections.Counter(o[name]["f32"])
        assert cols < D
        assert shapes[(rows, DECAY_LORA), (DECAY_LORA, cols)] == 2 * L, r
        assert shapes[(DECAY_LORA, rows), (rows, cols)] == L, r
        assert shapes[(rows, DECAY_LORA), (DECAY_LORA, D)] == L, r
        assert shapes[(DECAY_LORA, rows), (rows, D)] == 0, r

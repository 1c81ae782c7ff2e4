"""The port's dry run (``repro_torch.launch.dryrun``) against the JAX
package on the CPU, without compiling anything.

* The cell table (``SHAPES``, ``cells()``, ``OPT_SETTINGS``,
  ``OPT_SHAPE_SETTINGS``, ``opt_settings_for``), the input specs
  (``data/specs.py``) and ``auto_microbatches`` equal the reference's.
* Every cell's argument bytes on rank 0 of the production meshes
  (16, 16) and (2, 16, 16) equal what the reference's ``logical_spec``
  places on one device of a stand-in mesh: parameters, optimizer state
  and batch, cache and tokens (the port keeps a decode cache's ``pos``
  on the host, so the reference's 4-byte scalar is left out).
* Model FLOPs are the reference's formula on the reference's active
  parameter count, exactly.
* The cost counter's units: a projection, the attention forward and
  backward at causal, window and Sq != Skv masks, the dry collectives'
  ring factors, a softmax's transcendentals, the peak of a chain.
* The whole table at smoke configs on a (2, 2) dry mesh completes,
  under the default rules and under ``--rules sp`` (``SP_RULES``:
  the residual stream on sequence shards over ``model``);
  ``--variant opt`` traces its cells under either rules variant.
* Where ``model`` divides H but not KVH (qwen3-0.6b ``train_4k`` at 2
  layers on the dry (16, 16) mesh), every product of the step has the
  shape of one of the rank's own weights: its K/V products have the
  rank's KV heads' columns (one head, 128), not all KVH heads' (1,024),
  and the step launches the GEMM as often as before.  Where ``model``
  does not divide H (llama4-scout, H 40), rank 0's Q and output
  products have its 3 heads' columns and rows, its K/V products the one
  KV head they read; ``rank_heads`` tiles the heads, ceil(H / m) on
  rank 0.  Ranks with no heads (recurrentgemma, H 10 on 16) make rank
  0's collectives over ``model``.  RWKV6's channel gate, whole on every
  rank, forms only the rank's columns of its weight gradient.
* Under ``SP_RULES`` every cell's argument bytes on both production
  meshes equal the reference's placement under its ``SP_RULES``, and on
  a smoke train cell SP lowers the traced peak, leaves no all-reduce of
  the residual stream in the blocks (only the head's) and keeps the
  collective total within 10 % of the default rules'.

``repro.launch.dryrun`` is not imported: it sets ``XLA_FLAGS`` to 512
host devices at import, which would change JAX for later tests.
"""
import json
import math
import sys

import jax
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.data import specs as jspecs
from repro.models import build_model as jbuild
from repro.sharding import SP_RULES as JSP_RULES
from repro.sharding import logical_spec as jlogical_spec
from repro.train import optimizer as jopt
from repro.train.step import auto_microbatches as jauto_microbatches
from repro_torch import configs
from repro_torch.data import specs
from repro_torch.kernels.flash_attention import ops as fa
from repro_torch.kernels.gemm_dataflow import ops as gemm
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_dry_mesh
from repro_torch.cost import OpCounter
from repro_torch.models import components as C
from repro_torch.models.rwkv6 import TM_LORA
from repro_torch.sharding import collectives, spmd
from repro_torch.sharding.rules import DEFAULT_RULES, SP_RULES
from repro_torch.train.step import auto_microbatches
from test_sharding_rules import FakeMesh

MESHES = {"single": {"data": 16, "model": 16},
          "multi": {"pod": 2, "data": 16, "model": 16}}
CELLS = [(a, s.name) for a, s, skip in configs.cells() if skip is None]


def _dtype_name(dt) -> str:
    return str(dt).replace("torch.", "")


def test_cell_table_matches_reference():
    assert [(s.name, s.seq_len, s.global_batch, s.kind)
            for s in configs.SHAPES] == [
        (s.name, s.seq_len, s.global_batch, s.kind)
        for s in jconfigs.SHAPES]
    assert [(a, s.name, skip) for a, s, skip in configs.cells()] == [
        (a, s.name, skip) for a, s, skip in jconfigs.cells()]
    assert configs.OPT_SETTINGS == jconfigs.OPT_SETTINGS
    assert configs.OPT_SHAPE_SETTINGS == jconfigs.OPT_SHAPE_SETTINGS
    for arch in configs.ARCH_NAMES:
        for s in configs.SHAPES:
            assert configs.opt_settings_for(arch, s.name) == \
                jconfigs.opt_settings_for(arch, s.name)
    assert configs.shape_by_name("decode_32k") == configs.SHAPES[2]


@pytest.mark.parametrize("arch", configs.ARCH_NAMES)
def test_input_specs_match_reference(arch):
    cfg, jcfg = configs.get(arch), jconfigs.get(arch)
    for s in configs.SHAPES:
        B, S = s.global_batch, s.seq_len
        got = specs.train_specs(cfg, B, S)
        want = jspecs.train_specs(jcfg, B, S)
        assert list(got) == list(want)
        for k in got:
            assert got[k].shape == tuple(want[k].shape), k
            assert _dtype_name(got[k].dtype) == str(want[k].dtype), k
            assert got[k].meta().shape == got[k].shape
        assert specs.train_axes(cfg, B, S) == jspecs.train_axes(jcfg, B, S)
        tok, axes = specs.decode_token_specs(cfg, B)
        jtok, jaxes = jspecs.decode_token_specs(jcfg, B)
        assert (tok.shape, _dtype_name(tok.dtype), axes) == (
            tuple(jtok.shape), str(jtok.dtype), jaxes)
        for dp in ((16, 32) if s.kind == "train" else ()):
            assert auto_microbatches(cfg, B, S, dp) == \
                jauto_microbatches(jcfg, B, S, dp)


def _ref_bytes(spec_tree, mesh, rules=None) -> int:
    """Bytes of one device's shards of a reference spec tree (leaves
    with ``shape``, ``dtype`` and ``axes``, or ShapeDtypeStructs paired
    with axes) under the reference's ``logical_spec`` (its default
    rules, or ``rules``)."""
    sizes = dict(zip(mesh.axis_names, mesh.devices.shape))
    total = 0
    kw = {} if rules is None else {"rules": rules}
    for ps in jax.tree.leaves(spec_tree, is_leaf=lambda x: hasattr(x, "axes")):
        spec = jlogical_spec(ps.axes, ps.shape, mesh, **kw)
        n = math.prod(ps.shape)
        for entry in spec:
            for a in ((entry,) if isinstance(entry, str) else entry or ()):
                n //= sizes[a]
        total += n * np.dtype(ps.dtype).itemsize
    return total


class _Spec:
    def __init__(self, sds, axes):
        self.shape, self.dtype, self.axes = tuple(sds.shape), sds.dtype, axes


def _reference_argument_bytes(arch, shape, mesh, rules=None) -> int:
    jcfg = jconfigs.get(arch)
    s = jconfigs.shape_by_name(shape)
    model = jbuild(jcfg)
    pspecs = model.param_specs()
    total = _ref_bytes(pspecs, mesh, rules)
    B, S = s.global_batch, s.seq_len
    if s.kind == "train":
        opt = jopt.OptConfig(keep_master=(jcfg.param_dtype != "float32"))
        total += _ref_bytes(jopt.opt_state_specs(pspecs, opt), mesh, rules)
    if s.kind in ("train", "prefill"):
        sds, axes = jspecs.train_specs(jcfg, B, S), \
            jspecs.train_axes(jcfg, B, S)
        total += _ref_bytes([_Spec(sds[k], axes[k]) for k in sds], mesh,
                            rules)
    else:
        cache = model.cache_specs(B, S)
        pos = cache.pop("pos")
        assert pos.shape == () and np.dtype(pos.dtype).itemsize == 4
        tok, axes = jspecs.decode_token_specs(jcfg, B)
        total += (_ref_bytes(cache, mesh, rules)
                  + _ref_bytes([_Spec(tok, axes)], mesh, rules))
    return total


@pytest.mark.parametrize("mesh_kind", list(MESHES))
def test_argument_bytes_match_reference_placement(mesh_kind):
    """Rank 0's argument bytes of every non-skipped default-rules cell
    (what ``build_step`` hands the step, placed by the port's rules)
    against the reference's placement on a stand-in mesh."""
    fake = FakeMesh(MESHES[mesh_kind])
    mesh = dryrun.dry_mesh_for(mesh_kind)
    for arch, shape in CELLS:
        _, args, _ = dryrun.build_step(arch, shape, mesh)
        got = dryrun.memory_of(args, (), 0)["argument_bytes"]
        assert got == _reference_argument_bytes(arch, shape, fake), \
            (arch, shape)


@pytest.mark.parametrize("mesh_kind", list(MESHES))
def test_sp_argument_bytes_match_reference_placement(mesh_kind):
    """Under ``SP_RULES`` rank 0's argument bytes of every non-skipped
    cell against the reference's placement under its ``SP_RULES`` (no
    argument has a ``seq`` axis, so both equal the default rules')."""
    fake = FakeMesh(MESHES[mesh_kind])
    mesh = dryrun.dry_mesh_for(mesh_kind)
    for arch, shape in CELLS:
        _, args, _ = dryrun.build_step(arch, shape, mesh, SP_RULES)
        got = dryrun.memory_of(args, (), 0)["argument_bytes"]
        assert got == _reference_argument_bytes(arch, shape, fake,
                                                 JSP_RULES), (arch, shape)


def test_model_flops_match_reference():
    for arch, shape in CELLS:
        jcfg = jconfigs.get(arch)
        s = jconfigs.shape_by_name(shape)
        tokens = s.global_batch * (s.seq_len if s.kind != "decode" else 1)
        want = (6 if s.kind == "train" else 2) * jcfg.n_active_params() \
            * tokens
        got = dryrun.model_flops(configs.get(arch), shape, 256)
        assert got["global"] == want, (arch, shape)
        assert got["per_device"] == want / 256, (arch, shape)


def _count(fn, *tensors):
    counter = OpCounter()
    with counter:
        counter.track(tensors)
        out = fn()
    return counter, out


def _meta(*shape, dtype=torch.bfloat16, grad=False):
    return torch.empty(shape, dtype=dtype, device="meta",
                       requires_grad=grad)


def test_counter_counts_a_projection():
    M, K, N = 24, 64, 48
    x, w = _meta(M, K), _meta(K, N)
    c, y = _count(lambda: C.linear(x, w), x, w)
    assert y.shape == (M, N) and y.dtype == torch.bfloat16
    k = c.cost.kernels["gemm_dataflow"]
    assert (k["launches"], k["flops"]) == (1, 2 * M * N * K)
    assert k["bytes"] == (M * K + K * N) * 2 + M * N * 4
    # the f32 output rounded to bf16 is one more op: a copy, no flops
    assert c.cost.flops == 2 * M * N * K
    assert c.cost.bytes == k["bytes"] + M * N * (4 + 2)
    c, _ = _count(lambda: x.float() @ w.float(), x, w)   # a library GEMM
    assert c.cost.flops == 2 * M * N * K and "gemm_dataflow" not in \
        c.cost.kernels


@pytest.mark.parametrize("case", [
    ("causal", 2, 256, 256, 4, 2, 64, True, None,
     256 * 257 // 2),
    ("window", 1, 256, 256, 4, 4, 64, True, 64,
     sum(min(p + 1, 64) for p in range(256))),
    ("cross", 2, 16, 300, 6, 6, 64, False, None, 16 * 300)],
    ids=lambda c: c[0])
def test_counter_counts_attention(case):
    _, B, Sq, Skv, H, KVH, Dh, causal, window, pairs = case
    q = _meta(B, Sq, H, Dh, grad=True)
    k, v = (_meta(B, Skv, KVH, Dh, grad=True) for _ in range(2))
    fwd = 4 * Dh * pairs * B * H

    def step():
        out = fa.flash_attention_train(q, k, v, causal=causal,
                                       window=window)
        out.backward(torch.empty_like(out))
        return out
    c, out = _count(step, q, k, v)
    kern = c.cost.kernels
    assert out.shape == q.shape
    assert (kern["flash_attention"]["launches"],
            kern["flash_attention"]["flops"]) == (1, fwd)
    assert (kern["flash_attention_bwd"]["launches"],
            kern["flash_attention_bwd"]["flops"]) == (1, 2.5 * fwd)
    assert fa.visible_pairs(Sq, Skv, causal, window) == pairs


def test_split_heads_project_only_the_rank_kv_heads(monkeypatch):
    """qwen3-0.6b (H 16, KVH 8) at ``train_4k`` with 2 layers on the dry
    (16, 16) mesh: rank 0 holds query head 0 and reads KV head 0 only.
    Each GEMM of the step is the forward (twice: remat), dX or dW
    product of one of the rank's weights (K_w, N_w); keyed by the
    product's (K, N), or (M, N) for dW, whose K is the microbatch's
    tokens, the launches are 3 a layer and microbatch at (K_w, N_w) and
    1 at (N_w, K_w): ``wk`` / ``wv`` enter at (D, 128), never at the
    whole (D, 1,024), and the launch count is 4 a product, but 3 for
    the FFN's row-parallel down projection (F / m, D), whose output the
    recompute does not form (``components.remat``): 2 at (F / m, D)."""
    cfg = dryrun.apply_overrides(configs.get("qwen3-0.6b"),
                                 {"n_layers": "2"})
    seen = []
    cost = gemm.cost

    def spy(m, n, k, dtype):
        seen.append((m, n, k))
        return cost(m, n, k, dtype)
    monkeypatch.setattr(gemm, "cost", spy)
    res = dryrun.run_cell("qwen3-0.6b", "train_4k", "single", cfg=cfg)
    m, dh, D = MESHES["single"]["model"], cfg.head_dim, cfg.d_model
    kv = spmd.rank_kv_heads(cfg.n_heads, cfg.n_kv_heads, m, 0)
    assert cfg.n_heads % m == 0 and cfg.n_kv_heads % m and len(kv) == 1
    s = configs.shape_by_name("train_4k")
    n_micro = res["n_micro"]
    tokens = s.global_batch // MESHES["single"]["data"] // n_micro \
        * s.seq_len
    weights = [(D, cfg.n_heads // m * dh), (D, len(kv) * dh),
               (D, len(kv) * dh), (cfg.n_heads // m * dh, D),
               (D, cfg.d_ff // m), (D, cfg.d_ff // m), (cfg.d_ff // m, D)]
    # forward, recompute and dW at (K_w, N_w); the dead product no recompute
    runs = [3] * (len(weights) - 1) + [2]
    want = {}
    for (kw, nw), r in zip(weights, runs):
        want[kw, nw] = want.get((kw, nw), 0) + r * cfg.n_layers * n_micro
        want[nw, kw] = want.get((nw, kw), 0) + cfg.n_layers * n_micro
    got = {}
    for mm, n, k in seen:
        key = (mm, n) if k == tokens else (k, n)
        assert tokens in (mm, k), (mm, n, k)
        got[key] = got.get(key, 0) + 1
    assert got == want
    assert (D, cfg.n_kv_heads * dh) not in got
    launches = res["kernels"]["gemm_dataflow"]["launches"]
    assert launches == len(seen) == (4 * len(weights) - 1) \
        * cfg.n_layers * n_micro
    assert res["kernels"]["gemm_dataflow"]["flops"] == sum(
        2 * a * b * c for a, b, c in seen)


def test_uneven_heads_project_only_the_rank_heads(monkeypatch):
    """llama4-scout (H 40, KVH 8, G 5) at ``train_4k`` with 2 layers on
    the dry (16, 16) mesh, where model = 16 does not divide H: rank 0
    computes query heads 0-2 (ceil(40 / 16)) and reads KV head 0 only.
    Keyed as in ``test_split_heads_project_only_the_rank_kv_heads``, its
    ``wq`` enters at (D, 3 x 128) and ``wo`` at (3 x 128, D), 4 GEMMs a
    layer and microbatch each way, and ``wk`` / ``wv`` at (D, 128), 3 each
    and 1 the other way: never the whole (D, 5,120) or (D, 1,024)."""
    cfg = dryrun.apply_overrides(configs.get("llama4-scout-17b-a16e"),
                                 {"n_layers": "2"})
    seen = []
    cost = gemm.cost

    def spy(m, n, k, dtype):
        seen.append((m, n, k))
        return cost(m, n, k, dtype)
    monkeypatch.setattr(gemm, "cost", spy)
    res = dryrun.run_cell(cfg.name, "train_4k", "single", cfg=cfg)
    m, dh, D = MESHES["single"]["model"], cfg.head_dim, cfg.d_model
    heads = spmd.rank_heads(cfg.n_heads, m, 0)
    kv = spmd.rank_kv_heads(cfg.n_heads, cfg.n_kv_heads, m, 0)
    assert cfg.n_heads % m and (heads, kv) == (range(0, 3), range(0, 1))
    s = configs.shape_by_name("train_4k")
    n = cfg.n_layers * res["n_micro"]
    tokens = s.global_batch // MESHES["single"]["data"] // res["n_micro"] \
        * s.seq_len
    got = {}
    for mm, nn, k in seen:
        key = (mm, nn) if k == tokens else (k, nn)
        got[key] = got.get(key, 0) + 1
    q, kvc = len(heads) * dh, len(kv) * dh
    assert (got[D, q], got[q, D]) == (4 * n, 4 * n)
    assert (got[D, kvc], got[kvc, D]) == (6 * n, 2 * n)
    assert not {(D, cfg.n_heads * dh), (cfg.n_heads * dh, D),
                (D, cfg.n_kv_heads * dh), (cfg.n_kv_heads * dh, D)} & set(got)


def test_replicated_gate_splits_its_weight_gradient(monkeypatch):
    """rwkv6-3b at ``train_4k`` with 1 layer on the dry (16, 16) mesh:
    the channel mix's gate weight ``wr`` (D, D) is whole on every rank
    of model, and so is its gradient's input, so each rank forms only
    its D / 16 columns of dW (one product of (D, D / 16) over the
    rank's tokens, all-gathered over model), never the whole (D, D):
    the forward, its recompute and dX keep the whole width.  The token
    mix's ``tm_w1`` (D, 5 x 32), whose whole dW had this shape at m 16,
    splits its dW too (``tests/test_torch_remat.py``)."""
    cfg = dryrun.apply_overrides(configs.get("rwkv6-3b"), {"n_layers": "1"})
    seen = []
    cost = gemm.cost

    def spy(m, n, k, dtype):
        seen.append((m, n, k))
        return cost(m, n, k, dtype)
    monkeypatch.setattr(gemm, "cost", spy)
    res = dryrun.run_cell(cfg.name, "train_4k", "single", cfg=cfg)
    s, D, m = configs.shape_by_name("train_4k"), cfg.d_model, \
        MESHES["single"]["model"]
    tokens = s.global_batch // MESHES["single"]["data"] // res["n_micro"] \
        * s.seq_len
    assert seen.count((D, D // m, tokens)) == res["n_micro"]
    assert seen.count((D, 5 * TM_LORA // m, tokens)) == res["n_micro"]
    assert (D, D, tokens) not in seen
    assert seen.count((tokens, D, D)) == 3 * res["n_micro"]


@pytest.mark.parametrize("rules", [DEFAULT_RULES, SP_RULES],
                         ids=["default", "sp"])
def test_zero_head_ranks_make_rank_0s_collectives(monkeypatch, rules):
    """recurrentgemma-2b (H 10, KVH 1, G 10) at full widths, one whole
    (RG-LRU, RG-LRU, local attention) pattern, a grad step on the dry
    (16, 16) mesh: ranks 2 and 15 of ``model`` hold no heads (their
    empty ranges start at heads 2 and 10) and trace to the end, making
    over ``model`` the collectives of rank 0, which holds one, in kind,
    order and input shape, as every rank of a group must or the group
    hangs.  Over ``data`` each rank's group shares its heads, so only
    the kinds and their order must agree there."""
    cfg = dryrun.apply_overrides(configs.get("recurrentgemma-2b"),
                                 {"n_layers": "3"})
    shape = configs.ShapeSpec("zero_head", cfg.local_window, 16, "train")
    run, log = collectives._run, []

    def logged(kind, t, *args):
        axes = tuple(sys._getframe(1).f_locals["axes"])
        log.append((axes, kind, tuple(t.shape)))
        return run(kind, t, *args)
    monkeypatch.setattr(collectives, "_run", logged)

    def calls(rank):
        log.clear()
        dryrun.collective_tally(cfg, shape, make_dry_mesh(
            (16, 16), ("data", "model"), rank=rank), rules)
        return ([c for c in log if c[0] == ("model",)],
                [c[:2] for c in log if c[0] != ("model",)])
    assert [len(spmd.rank_heads(cfg.n_heads, 16, r)) for r in (0, 2, 15)] \
        == [1, 0, 0]
    want = calls(0)
    assert all(want) and calls(2) == want and calls(15) == want


@pytest.mark.parametrize("h,m,kvh", [(40, 16, 8), (6, 16, 6), (3, 2, 1),
                                     (1, 2, 1), (16, 4, 8), (10, 16, 1),
                                     (4, 8, 2)])
def test_rank_heads_tile_the_heads(h, m, kvh):
    """``spmd.rank_heads``: the ranks' ranges tile [0, H) in rank order,
    rank 0 holds ceil(H / m) and every rank ceil or floor of H / m, and
    where m divides H rank r holds [r H / m, (r + 1) H / m).
    ``rank_kv_heads`` is the range of the KV heads (j // G) of the
    rank's query heads j, empty where it has none, and ``expand_kv``
    repeats those to its query heads as the reference's G-fold repeat of
    every KV head cut to them."""
    g = h // kvh
    ranges = [spmd.rank_heads(h, m, r) for r in range(m)]
    assert ranges[0].start == 0 and ranges[-1].stop == h
    assert all(a.stop == b.start for a, b in zip(ranges, ranges[1:]))
    assert len(ranges[0]) == -(-h // m)
    assert {len(r) for r in ranges} <= {h // m, -(-h // m)}
    if h % m == 0:
        assert ranges == [range(r * h // m, (r + 1) * h // m)
                          for r in range(m)]
    t = torch.arange(2 * 3 * kvh * 4, dtype=torch.float32).reshape(
        2, 3, kvh, 4)
    ref = t.repeat_interleave(g, 2)
    for r, heads in enumerate(ranges):
        kv = spmd.rank_kv_heads(h, kvh, m, r)
        assert set(kv) == {j // g for j in heads}
        got = C.expand_kv(t[:, :, kv.start:kv.stop], h, kvh, m, r)
        assert torch.equal(got, ref[:, :, heads.start:heads.stop])


def test_dry_collectives_count_ring_bytes():
    mesh = make_dry_mesh((1, 4), ("data", "model"))
    t = _meta(2, 8)                                       # bf16, 32 bytes
    c, outs = _count(lambda: (
        collectives.all_gather(t, mesh, ("model",), 0),
        collectives.all_reduce(t, mesh, ("model",)),
        collectives.reduce_scatter(_meta(8, 8), mesh, ("model",), 0)), t)
    gathered, summed, scattered = outs
    assert (gathered.shape, gathered.dtype) == ((8, 8), torch.bfloat16)
    assert (summed.shape, summed.dtype) == ((2, 8), torch.bfloat16)
    assert (scattered.shape, scattered.dtype) == ((2, 8), torch.bfloat16)
    # all-gather: result (128 bytes) x 3/4; all-reduce in f32: 2 x 64
    # x 3/4; reduce-scatter in f32: result (64 bytes) x 3
    assert c.cost.coll_bytes["all-gather"] == 96
    assert c.cost.coll_bytes["all-reduce"] == 96
    assert c.cost.coll_bytes["reduce-scatter"] == 192
    assert c.cost.coll_ops["all-gather"] == 1
    assert c.cost.coll_total == 384


def test_counter_counts_softmax_transcendentals():
    x = _meta(4, 8, dtype=torch.float32)
    c, _ = _count(lambda: torch.softmax(x, -1), x)
    assert c.cost.transcendentals == 32
    assert c.cost.bytes == 2 * 32 * 4


def test_counter_tracks_the_peak_of_a_chain():
    x = _meta(1000, dtype=torch.float32)                  # 4,000 bytes

    def chain():
        v = x.view(10, 100)                               # no new storage
        y = v.repeat(4, 1)                                # 16,000: peak
        del y
        z = x * 2                                         # 4,000
        return z + 1                                      # 4,000
    c, _ = _count(chain, x)
    assert c.peak == 4000 + 16000
    assert c.live == 4000 + 4000                          # x and the result


def test_whole_table_at_smoke_size_completes(tmp_path):
    with pytest.raises(SystemExit) as done:
        dryrun.main(["--all", "--smoke", "--mesh", "single", "--out",
                     str(tmp_path)])
    assert done.value.code == 0
    skips = json.loads((tmp_path / "skips.json").read_text())
    assert [(r["arch"], r["shape"], r["reason"]) for r in skips] == [
        (a, s.name, skip) for a, s, skip in jconfigs.cells() if skip]
    for arch, shape in CELLS:
        res = json.loads((tmp_path / f"{arch}__{shape}__single.json")
                         .read_text())
        assert res["xla_cost_analysis"] is None
        assert res["loop_aware"]["flops"] > 0 and res["memory"]["fits"]
        assert res["roofline"]["step_time_s"] > 0


def test_sp_rules_complete_the_smoke_table(tmp_path):
    """``--rules sp`` traces every non-skipped cell of the table at
    smoke configs on a dry (2, 2) mesh."""
    with pytest.raises(SystemExit) as done:
        dryrun.main(["--all", "--smoke", "--mesh", "single", "--rules",
                     "sp", "--out", str(tmp_path)])
    assert done.value.code == 0
    for arch, shape in CELLS:
        res = json.loads((tmp_path / f"{arch}__{shape}__single.json")
                         .read_text())
        assert res["loop_aware"]["flops"] > 0 and res["memory"]["fits"]
        assert res["roofline"]["step_time_s"] > 0


@pytest.mark.parametrize("arch, shape, rules", [
    ("qwen3-0.6b", "decode_32k", "default"),
    ("rwkv6-3b", "decode_32k", "sp"), ("qwen2-vl-7b", "decode_32k", "sp")])
def test_opt_variant_traces_its_cells(tmp_path, arch, shape, rules):
    """``--variant opt`` applies each cell's ``OPT_SETTINGS`` (overrides
    and rules variant) and exits 0, "sp" cells included."""
    assert configs.opt_settings_for(arch, shape)[1] == rules
    with pytest.raises(SystemExit) as done:
        dryrun.main(["--arch", arch, "--shape", shape, "--smoke",
                     "--variant", "opt", "--out", str(tmp_path)])
    assert done.value.code == 0
    res = json.loads((tmp_path / f"{arch}__{shape}__single.json")
                     .read_text())
    assert res["memory"]["argument_bytes"] > 0


def test_sp_cuts_the_stream_on_a_smoke_train_cell(monkeypatch):
    """qwen3-0.6b's smoke config at ``train_4k`` on a dry (2, 2) mesh,
    traced under the default rules and under ``SP_RULES``: SP's traced
    peak is lower (each layer's saved input is a sequence shard); its
    only all-reduce of a residual-stream-sized tensor is the head's (the
    unembedding's input gradient, one a microbatch, as under the default
    rules), so the blocks' all-reduce bytes are 0 where the default
    rules' are not; the collective total stays within 10 %."""
    arch, shape = "qwen3-0.6b", "train_4k"
    cfg = configs.get_smoke(arch)
    mesh = make_dry_mesh((2, 2), ("data", "model"))
    calls = []
    run = collectives._run

    def spy(kind, t, fn, mesh_, moved):
        calls.append((kind, t.numel(), moved))
        return run(kind, t, fn, mesh_, moved)
    monkeypatch.setattr(collectives, "_run", spy)
    res = {}
    for name, rules in (("default", DEFAULT_RULES), ("sp", SP_RULES)):
        calls.clear()
        cell = dryrun.run_cell(arch, shape, "single", rules=rules, cfg=cfg,
                               mesh=mesh)
        res[name] = (cell, list(calls))
    s = configs.shape_by_name(shape)
    rows = s.global_batch // 2 // res["sp"][0]["n_micro"]
    stream = rows * s.seq_len * cfg.d_model

    def stream_all_reduce(name):
        return sum(moved for kind, n, moved in res[name][1]
                   if kind == "all_reduce" and n >= stream)
    head = res["sp"][0]["n_micro"] * stream * 4 * 2 * (2 - 1) / 2
    assert stream_all_reduce("sp") == head
    assert stream_all_reduce("default") > head
    (d, _), (p, _) = res["default"], res["sp"]
    assert p["memory"]["per_device_bytes"] < d["memory"]["per_device_bytes"]
    assert p["memory"]["argument_bytes"] == d["memory"]["argument_bytes"]
    total = d["loop_aware"]["collective_total_bytes"]
    assert abs(p["loop_aware"]["collective_total_bytes"] - total) <= \
        0.1 * total
    assert p["kernels"] == d["kernels"]

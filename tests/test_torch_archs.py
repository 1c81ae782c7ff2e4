"""The architectures the port serves beside qwen3-0.6b — qwen2-0.5b (QKV
bias), stablelm-1.6b (LayerNorm with a bias, partial rotary, untied
head, MHA), qwen1.5-110b (QKV bias, untied head) and llama4-scout's MoE
— against the JAX package on their smoke configs, through the checks of
``tests/test_torch_model.py``, and through the port's engine and
launcher.

* The port's config copies equal the reference's, FULL and SMOKE.
* The bridge keeps every bit of every leaf (biases, LayerNorm, head,
  router, stacked experts, shared expert).
* In f32: the contiguous path within 1e-4 and the paged programs within
  1e-2 of the reference, with the same greedy tokens
  (``test_torch_model.py`` gives the tolerances and their reasons).
  llama4-scout runs at its default capacity factor 1.25 here, so tokens
  are dropped on both sides alike.
* In bf16, inside the port: chunked == whole prefill and fused ==
  unfused bit for bit, and the engine token-exact against the port's
  own ``greedy_generate``.  For chunked == whole and the engine,
  llama4-scout runs at capacity factor 4.0 = n_experts / top_k (C = T:
  nothing dropped); with drops a row's result depends on which rows
  share its call, in the reference as well.
The families that run on the contiguous-cache path only are held in
``tests/test_torch_families.py``.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.configs.base import ModelConfig as JModelConfig
from repro_torch import configs
from repro_torch.checkpoint import params_from_jax
from repro_torch.launch import serve as launch
from repro_torch.models.lm import DecoderLM
from repro_torch.serve import ServePrograms
from test_torch_engine import _assert_parity, _oracle, _prompts, _run
from test_torch_model import (check_bridge, check_chunked_prefill_equals_whole,
                              check_contiguous_path,
                              check_fused_equals_unfused,
                              check_paged_programs, reference,
                              to_port_config, with_capacity)

ARCHS = ("qwen2-0.5b", "stablelm-1.6b", "qwen1.5-110b",
         "llama4-scout-17b-a16e")
#: llama4-scout smoke: n_experts / top_k, so C = T and nothing is dropped
NO_DROP = 4.0
#: the reference's own bias / GELU / LayerNorm / untied-head model
#: (tests/test_serve_parallel.py), served at tp = 1
GELU_CFG = JModelConfig(name="tp-bias-test", family="dense", n_layers=2,
                        d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
                        d_ff=128, vocab_size=256, qkv_bias=True,
                        mlp_kind="gelu", norm_kind="layernorm",
                        tie_embeddings=False, attn_kv_chunk=16)


def _smoke(arch, no_drop=False):
    jcfg = jconfigs.get_smoke(arch)
    if no_drop and jcfg.moe is not None:
        jcfg = with_capacity(jcfg, NO_DROP)
    return jcfg


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_equal_reference(arch):
    assert configs.get(arch) == to_port_config(jconfigs.get(arch))
    assert configs.get_smoke(arch) == to_port_config(jconfigs.get_smoke(arch))
    assert configs.get(arch).n_params() == jconfigs.get(arch).n_params()


@pytest.mark.parametrize("arch", ARCHS)
def test_bridge_is_bit_identical(arch):
    check_bridge(_smoke(arch))


@pytest.mark.parametrize("arch", ARCHS)
def test_apply_prefill_decode_match_reference(arch):
    check_contiguous_path(_smoke(arch))


@pytest.mark.parametrize("arch", ARCHS)
def test_paged_programs_match_reference(arch):
    check_paged_programs(_smoke(arch))


@pytest.mark.parametrize("arch", ARCHS)
def test_chunked_prefill_equals_whole_prefill_bitwise(arch):
    check_chunked_prefill_equals_whole(_smoke(arch, no_drop=True))


@pytest.mark.parametrize("arch", ARCHS)
def test_fused_step_equals_unfused_bitwise(arch):
    # each group routes on its own, as when dispatched alone: this holds
    # with drops too, so scout keeps its default capacity factor
    check_fused_equals_unfused(_smoke(arch))


def _port_bundle(jcfg):
    cfg = dataclasses.replace(to_port_config(jcfg), compute_dtype="bfloat16")
    return (cfg, DecoderLM(cfg, device="cpu"),
            params_from_jax(reference(jcfg)[2], cfg, device="cpu"))


@pytest.fixture(scope="module")
def served():
    """Each architecture's bf16 bundle, prompts and greedy oracle, made
    once for both speculation settings of the engine test."""
    return {}


def _served(served, arch):
    if arch not in served:
        cfg, model, params = _port_bundle(_smoke(arch, no_drop=True))
        prompts, gen = _prompts(cfg, 7, [9, 17, 24, 12, 31, 8]), 10
        served[arch] = (model, params, prompts, gen,
                        _oracle(model, params, prompts, gen))
    return served[arch]


@pytest.mark.parametrize("spec_k", [0, 4])
@pytest.mark.parametrize("arch", ARCHS)
def test_engine_token_exact_vs_greedy_generate(served, arch, spec_k):
    model, params, prompts, gen, oracle = _served(served, arch)
    eng, done = _run(model, params, prompts, gen, max_batch=3, n_pages=24,
                     page_size=8, max_pages_per_seq=8, spec_k=spec_k)
    _assert_parity(done, oracle)
    eng.cache.check_invariants()


def test_gelu_bias_layernorm_untied_model():
    """The reference's bias / GELU / LayerNorm / untied-head model: f32
    parity with the reference, and the engine token-exact in bf16."""
    check_contiguous_path(GELU_CFG)
    check_paged_programs(GELU_CFG)
    check_fused_equals_unfused(GELU_CFG)
    cfg, model, params = _port_bundle(GELU_CFG)
    assert set(params["layers"]["ffn"]) == {"w1", "b1", "w2", "b2"}
    prompts, gen = _prompts(cfg, 2, [9, 21, 14]), 6
    _, done = _run(model, params, prompts, gen, max_batch=2, n_pages=24,
                   page_size=8, max_pages_per_seq=8, spec_k=3)
    _assert_parity(done, _oracle(model, params, prompts, gen))


@pytest.mark.parametrize("arch", ARCHS)
def test_launcher_serves_smoke_on_cpu(arch, capsys):
    stats = launch.main(["--arch", arch, "--smoke", "--device", "cpu",
                         "--requests", "4", "--batch", "2",
                         "--prompt-len", "12", "--gen", "5",
                         "--rate", "1000"])
    assert stats["requests"] == 4 and stats["tokens"] == 20
    assert "[cpu] 4 requests" in capsys.readouterr().out


@pytest.mark.parametrize("arch", ARCHS)
def test_prepare_params_casts_every_projection(arch):
    """Every weight that enters ``x @ W`` is bf16 once prepared (the
    stacked experts and the nested shared expert too); norms, biases,
    the MoE router and the embedding and head stay f32."""
    cfg = configs.get_smoke(arch)
    model = DecoderLM(cfg, device="cpu")
    params = model.init(seed=0)
    prepared = ServePrograms(model).prepare_params(params)

    def leaves(tree, path=()):
        for k, v in tree.items():
            if isinstance(v, dict):
                yield from leaves(v, path + (k,))
            else:
                yield path + (k,), v
    matmul = {"wq", "wk", "wv", "wo", "wg", "wu", "wd", "w1", "w2"}
    for path, t in leaves(prepared):
        want = (torch.bfloat16 if path[0] == "layers" and path[-1] in matmul
                else torch.float32)
        assert t.dtype == want, path
    if cfg.moe is not None:
        assert prepared["layers"]["ffn"]["shared"]["wd"].dtype \
            == torch.bfloat16
        assert prepared["layers"]["ffn"]["router"].dtype == torch.float32
    # a second preparation casts nothing again
    again = ServePrograms(model).prepare_params(prepared)
    assert all(a is b for (_, a), (_, b) in zip(leaves(again),
                                                leaves(prepared)))


def test_init_distributions_of_the_new_leaves():
    """LayerNorm scales start at 1 and biases at 0; an untied head is
    fan-in normal over the model width and the layer-stacked experts'
    fan-in counts the layer and expert axes, as in the reference."""
    cfg = configs.get_smoke("stablelm-1.6b")
    p = DecoderLM(cfg, device="cpu").init(seed=0)
    for k in ("ln1", "ln2"):
        assert torch.equal(p["layers"][k]["scale"],
                           torch.ones(cfg.n_layers, cfg.d_model))
        assert not p["layers"][k]["bias"].any()
    assert torch.equal(p["final_norm"]["scale"], torch.ones(cfg.d_model))
    head = p["embed"]["head"]
    assert head.shape == (cfg.d_model, cfg.vocab_size)
    assert abs(float(head.std()) * np.sqrt(cfg.d_model) - 1) < 0.05
    assert not DecoderLM(configs.get_smoke("qwen2-0.5b"), device="cpu") \
        .init(seed=0)["layers"]["mix"]["bq"].any()
    cfg = configs.get_smoke("llama4-scout-17b-a16e")
    ffn = DecoderLM(cfg, device="cpu").init(seed=0)["layers"]["ffn"]
    L, E, d = cfg.n_layers, cfg.moe.n_experts, cfg.d_model
    assert ffn["wg"].shape == (L, E, d, cfg.moe.d_expert_ff)
    assert abs(float(ffn["wg"].std()) * np.sqrt(L * E * d) - 1) < 0.05
    assert abs(float(ffn["router"].std()) / 0.02 - 1) < 0.05

"""The port's single-device mixture of experts
(``repro_torch.models.components.moe_block``) against the reference's
``moe_block`` (no mesh: ``_moe_compute`` at ``ep_size = 1``) on
llama4-scout's smoke weights, in f32.

* At the default capacity factor 1.25, on a batch that overflows an
  expert: the same routed expert ids, the same dropped tokens, outputs
  within 1e-5 and the same aux loss.  (Both sides compute the same f32
  router product and the same f32 expert products in other summation
  orders: outputs of magnitude ~1 agree to a few f32 ulps.)
* Ties in the router go to the lower expert id, as ``lax.top_k``'s do.
* The parameter counts of the FULL configs, from the port's own specs
  (no JAX), are the reference's and inside its bounds
  (``tests/test_smoke_archs.py``).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from repro import configs as jconfigs
from repro.models import components as jC
from repro_torch import configs
from repro_torch.models import components as C
from test_torch_model import reference, to_port_config

ARCH = "llama4-scout-17b-a16e"
# f32 outputs of the same f32 products summed in other orders
MOE_TOL = 1e-5


def _layer0(tree):
    return {k: (_layer0(v) if isinstance(v, dict) else v[0])
            for k, v in tree.items()}


def _inputs(jcfg, B, S, seed):
    """Activations that crowd one expert: a shared direction along the
    router's column for expert 0 on top of unit noise."""
    p = _layer0(reference(jcfg)[2]["layers"]["ffn"])
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, jcfg.d_model)).astype(np.float32)
    col = p["router"][:, 0] / np.linalg.norm(p["router"][:, 0])
    return p, x + 2.0 * col.astype(np.float32)


def _both(jcfg, p, x):
    """(reference (y, aux), port (y, aux), port's routed ids) on the
    same f32 weights and input."""
    jcfg = dataclasses.replace(jcfg, compute_dtype="float32")
    want = jC.moe_block(jax.tree.map(jnp.asarray, p), jnp.asarray(x), jcfg)
    cfg = to_port_config(jcfg)
    tp = jax.tree.map(lambda a: torch.from_numpy(np.array(a)), p)
    tx = torch.from_numpy(x)
    got = C.moe_block(tp, tx, cfg)
    ids = C.moe_route(tp, tx.reshape(-1, x.shape[-1]), cfg)[2]
    return want, got, ids


def _reference_ids(jcfg, p, x):
    """The reference's routing lines (``_moe_compute``): f32 router,
    softmax, ``lax.top_k``."""
    xf = jnp.asarray(x).reshape(-1, x.shape[-1])
    probs = jax.nn.softmax(xf @ jnp.asarray(p["router"]), axis=-1)
    return np.asarray(lax.top_k(probs, jcfg.moe.top_k)[1])


def test_moe_block_matches_reference_with_drops():
    jcfg = jconfigs.get_smoke(ARCH)
    assert jcfg.moe.capacity_factor == 1.25
    B, S = 2, 12
    p, x = _inputs(jcfg, B, S, seed=0)
    (jy, jaux), (y, aux), ids = _both(jcfg, p, x)
    np.testing.assert_array_equal(ids.numpy(), _reference_ids(jcfg, p, x))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=MOE_TOL,
                               atol=MOE_TOL)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=MOE_TOL)

    # the dropped set: without the shared expert a dropped token's
    # output row is exactly 0 (top-1), on both sides
    bare = dataclasses.replace(jcfg, moe=dataclasses.replace(
        jcfg.moe, n_shared=0))
    pb = {k: v for k, v in p.items() if k != "shared"}
    (jy, _), (y, _), _ = _both(bare, pb, x)
    jdropped = np.flatnonzero(~np.asarray(jy).reshape(B * S, -1).any(-1))
    dropped = np.flatnonzero(~y.reshape(B * S, -1).numpy().any(-1))
    cap = C.moe_capacity(B * S, bare.moe)
    counts = np.bincount(ids[:, 0].numpy(), minlength=jcfg.moe.n_experts)
    assert cap == 7 and counts.max() > cap          # the batch overflows
    assert len(dropped) == (counts - np.minimum(counts, cap)).sum()
    np.testing.assert_array_equal(dropped, jdropped)
    # the tokens past an expert's capacity, in token order, are dropped
    first = {e: np.flatnonzero(ids[:, 0].numpy() == e)[cap:]
             for e in range(jcfg.moe.n_experts)}
    np.testing.assert_array_equal(dropped,
                                  np.sort(np.concatenate(list(first.values()))))


@pytest.mark.parametrize("top_k", [1, 2])
def test_moe_router_ties_go_to_the_lower_expert(top_k):
    """A zero router gives every expert the same probability: both sides
    pick experts 0..k-1 for every token, and agree on the outputs (two
    gate-weighted experts summed per token at top_k = 2)."""
    jcfg = jconfigs.get_smoke(ARCH)
    jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(
        jcfg.moe, top_k=top_k, capacity_factor=4.0))
    p, x = _inputs(jcfg, 2, 5, seed=1)
    p["router"] = np.zeros_like(p["router"])
    (jy, _), (y, _), ids = _both(jcfg, p, x)
    np.testing.assert_array_equal(ids.numpy(), _reference_ids(jcfg, p, x))
    assert (ids.numpy() == np.arange(top_k)).all()
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=MOE_TOL,
                               atol=MOE_TOL)


def test_moe_capacity_matches_the_reference_formula():
    """C = max(1, min(int(T * K / E * cf), T)), T counting every row of
    the call (padding rows included)."""
    for cf in (1.0, 1.25, 4.0, 16.0):
        m = configs.MoEConfig(n_experts=16, top_k=1, d_expert_ff=8,
                              capacity_factor=cf)
        for T in (1, 5, 8, 40, 256, 4608):
            assert C.moe_capacity(T, m) == max(1, min(int(T * 1 / 16 * cf),
                                                      T))
    m = configs.get(ARCH).moe
    assert C.moe_capacity(8, m) == 1                  # decode at cf 1.25
    assert C.moe_capacity(8, dataclasses.replace(
        m, capacity_factor=16.0)) == 8                # C = T at 16.0


def test_moe_param_accounting():
    cfg = configs.get(ARCH)
    total, active = cfg.n_params(), cfg.n_active_params()
    assert 1.0e11 < total < 1.2e11          # ~109B total
    assert 1.5e10 < active < 2.0e10         # ~17B active
    assert (total, active) == (jconfigs.get(ARCH).n_params(),
                               jconfigs.get(ARCH).n_active_params())
    dense = configs.get("qwen1.5-110b")
    assert 1.0e11 < dense.n_params() < 1.25e11
    assert dense.n_params() == dense.n_active_params()

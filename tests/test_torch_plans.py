"""The work plans of the port's two redesigned kernels, held on the CPU:
``gemm_dataflow.ops.plan_f32`` (the f32 output-stationary GEMM's tiles
and its split over whole k tiles) and ``flash_attention.ops.plan_dkdv``
(the attention backward's dK/dV walks cut into runs).  The kernels run
on the card only; ``chip_smoke.py`` holds them there against the plain
versions.  Here the plans are checked for what the kernels' bits rest
on (every k tile or walk step covered exactly once, whole k tiles,
runs added in ascending order), and the plain versions, which follow
the plans, against the JAX package: ``matmul_plain`` in f32 at the
shapes of the served f32 products against ``matmul_ref`` and the Pallas
kernel in interpret mode; ``flash_attention_bwd_plain`` on split walks
against ``jax.grad`` of the reference's attention, at the tolerance of
``tests/test_torch_train.py``."""
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import gemm_dataflow as jgd
from repro.models import components as JC
from repro_torch.kernels import gemm_dataflow as gd
from repro_torch.kernels.flash_attention import ops as fa
from repro_torch.kernels.gemm_dataflow import ops as gd_ops
from test_torch_model import warm_torch_threads  # noqa: F401 (warms)

N_SM = 132     # the H100's SMs

# (M, N, K): the served f32 products (routers, RG-LRU's gate, RWKV6's
# decay LoRA) at the row counts of the card's paths, the ragged f32
# case, the bf16 projections' shapes, and edges
F32_PLAN_SHAPES = [
    (8, 16, 5120), (256, 16, 5120), (2048, 16, 5120),
    (8, 64, 2048), (2048, 64, 2048),
    (8, 2560, 2560), (16384, 2560, 2560),
    (8, 64, 2560), (2048, 64, 2560), (8, 2560, 64), (2048, 2560, 64),
    (1000, 1000, 5120), (2048, 2048, 1024), (1, 1, 1), (129, 65, 129),
    (100, 100, 100000)]


@pytest.mark.parametrize("m,n,k", F32_PLAN_SHAPES)
def test_plan_f32_covers_every_k_tile_once(m, n, k):
    plan = gd_ops.plan_f32(m, n, k, N_SM)
    nk = -(-k // gd_ops.TILE)
    # grid z of the kernel: run z covers k tiles [z T, min(nk, z T + T))
    per = plan.tiles_per_chunk
    runs = [(z * per, min(nk, z * per + per)) for z in range(plan.chunks)]
    # whole k tiles, ascending, each exactly once
    covered = [t for t0, t1 in runs for t in range(t0, t1)]
    assert covered == list(range(nk))
    assert all(0 < t1 - t0 <= per for t0, t1 in runs)
    assert plan.bm in gd_ops.F32_TILES_M and plan.bn in gd_ops.F32_TILES_N
    # the row tile holds M, or M needs several tiles of 64 or 128 rows
    assert plan.bm >= m or plan.bm in (64, 128)
    bytes_ws = plan.workspace_floats * 4
    assert bytes_ws <= gd_ops.F32_WORKSPACE_CAP
    assert plan.workspace_floats == (nk * m * n if plan.chunks > 1 else 0)


@pytest.mark.parametrize("m,n,k", F32_PLAN_SHAPES)
def test_plan_f32_splits_only_when_tiles_leave_sms_idle(m, n, k):
    plan = gd_ops.plan_f32(m, n, k, N_SM)
    nk = -(-k // gd_ops.TILE)
    tiles = -(-m // plan.bm) * -(-n // plan.bn)
    if tiles >= N_SM:
        assert plan.chunks == 1
    elif nk > 1 and nk * m * n * 4 <= gd_ops.F32_WORKSPACE_CAP:
        # a split that brings the blocks to about one an SM or more
        assert plan.chunks > 1
        assert tiles * plan.chunks >= min(N_SM, tiles * nk) // 2


def _visible_tile_pairs(Sq, Skv, causal, window):
    """{(key tile, query tile)} holding at least one (query, key) pair
    the forward's mask lets through (q_offset 0)."""
    i = np.arange(Sq)[:, None]
    j = np.arange(Skv)[None]
    vis = np.ones((Sq, Skv), bool)
    if causal:
        vis &= j <= i
    if window is not None:
        vis &= j > i - window
    T = fa.KV_TILE
    nq, nk = -(-Sq // T), -(-Skv // T)
    pad = np.zeros((nq * T, nk * T), bool)
    pad[:Sq, :Skv] = vis
    tiles = pad.reshape(nq, T, nk, T).any(axis=(1, 3))
    return {(t, qt) for qt, t in zip(*np.nonzero(tiles))}


@pytest.mark.parametrize("Sq,Skv,G,causal,window", [
    (2048, 2048, 2, True, None), (2048, 2048, 2, False, None),
    (256, 256, 2, True, None), (200, 200, 2, True, None),
    (256, 256, 2, False, None), (320, 320, 2, True, None),
    (192, 192, 4, True, None), (70, 70, 2, True, None),
    (1000, 1000, 7, True, None), (64, 64, 1, True, None),
    (1, 1, 1, False, None),
    (4096, 4096, 10, True, 2048), (256, 256, 10, True, 64),
    (320, 320, 3, True, 100), (200, 200, 2, False, 70),
    (64, 1500, 1, False, None), (30, 140, 3, False, None),
    (100, 300, 2, True, None), (300, 100, 2, True, None)])
def test_plan_dkdv_covers_every_walk_step_once(Sq, Skv, G, causal, window):
    """Every (key tile, query head, query tile) whose tiles hold a pair
    the mask lets through is one walk step of exactly one block, and no
    other step is walked (windows, Sq != Skv, key tiles no query sees)."""
    plan = fa.plan_dkdv(Sq, Skv, G, causal, window)
    nq, nk = -(-Sq // fa.KV_TILE), -(-Skv // fa.KV_TILE)
    want = {(t, g, qt) for t, qt in _visible_tile_pairs(Sq, Skv, causal,
                                                        window)
            for g in range(G)}
    seen = []
    assert sorted({it[0] for it in plan.items}) == list(range(nk))
    for t, i0, i1, _ in plan.items:
        first, last = fa.walk_bounds(t, nq, causal, window)
        per_head = last - first + 1
        assert 0 <= i1 - i0 <= plan.chunk
        assert i1 > i0 or per_head <= 0
        seen += [(t, i // per_head, first + i % per_head)
                 for i in range(i0, i1)]
    assert len(seen) == len(set(seen)) and set(seen) == want
    # longest first
    lengths = [i1 - i0 for _, i0, i1, _ in plan.items]
    assert lengths == sorted(lengths, reverse=True)
    # a split walk's runs sit in consecutive slots in the order of their
    # steps, which is the order the combine adds them; a whole walk is
    # one item with no slot
    split_tiles = {t for t, _, _ in plan.splits}
    for t, first_slot, n in plan.splits:
        runs = sorted((i0, slot) for tt, i0, _, slot in plan.items
                      if tt == t)
        assert [slot for _, slot in runs] == list(range(first_slot,
                                                        first_slot + n))
    assert plan.n_slots == sum(n for _, _, n in plan.splits)
    for t, i0, i1, slot in plan.items:
        if t not in split_tiles:
            assert slot == -1 and i0 == 0


def test_plan_dkdv_depends_on_S_and_G_only():
    """The plan takes no batch size, only the shapes (Sq, Skv, G) and
    the mask: every batch row (and kv head) sums its dK/dV in the same
    order, so a row's gradients do not depend on the rows beside it."""
    assert list(inspect.signature(fa.plan_dkdv).parameters) == \
        ["Sq", "Skv", "G", "causal", "window"]
    assert fa.plan_dkdv(2048, 2048, 2).chunk == 32
    assert fa.plan_dkdv(256, 256, 2).splits == ()
    # recurrentgemma's local attention: 33 query tiles a key tile, G 10
    assert fa.plan_dkdv(4096, 4096, 10, True, 2048).chunk == 165


@pytest.mark.parametrize("B_,S_,H,KVH,Dh,causal,window", [
    (1, 192, 8, 2, 16, True, None), (2, 320, 4, 2, 16, True, None),
    (1, 320, 4, 2, 16, False, None), (1, 256, 10, 1, 16, True, 64)],
    ids=["gqa4_split", "causal_split", "not_causal_split", "window_split"])
def test_attention_backward_split_runs_match_reference(B_, S_, H, KVH, Dh,
                                                       causal, window):
    """``flash_attention_bwd_plain`` on shapes whose dK/dV walks the plan
    splits (run by run, then the runs in order) against ``jax.grad`` of
    the reference's attention, in f32."""
    assert fa.plan_dkdv(S_, S_, H // KVH, causal, window).splits
    rng = np.random.default_rng(Dh + S_)
    q, do = (rng.standard_normal((B_, S_, H, Dh)).astype(np.float32)
             for _ in range(2))
    k, v = (rng.standard_normal((B_, S_, KVH, Dh)).astype(np.float32)
            for _ in range(2))
    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, do))
    _, lse = fa.flash_attention_plain(tq, tk, tv, causal=causal,
                                      window=window, return_lse=True)
    got = fa.flash_attention_bwd_plain(tq, tk, tv, lse, tdo, causal, window)

    def f(q, k, v):
        return jnp.sum(JC.flash_attention(q, k, v, causal=causal,
                                          window=window, kv_chunk=16) * do)
    want = jax.jit(jax.grad(f, argnums=(0, 1, 2)))(q, k, v)
    for name, g, w in zip("qkv", got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-5, err_msg=name)


# (M, N, K): the served f32 products at decode rows, cut in K or N where
# the Pallas kernel in interpret mode would take long
@pytest.mark.parametrize("m,n,k", [(8, 16, 5120), (8, 64, 2048),
                                   (8, 64, 640), (8, 256, 64),
                                   (40, 16, 300)])
def test_gemm_f32_served_shapes_match_reference(m, n, k):
    """``matmul_plain`` in f32 against the reference's oracle and its
    Pallas kernel in interpret mode (the tolerance of
    ``tests/test_torch_kernels.py``)."""
    rng = np.random.default_rng(m * n + k)
    a = rng.standard_normal((m, k)).astype(np.float32)
    b = rng.standard_normal((k, n)).astype(np.float32)
    got = gd.matmul(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    for want in (jgd.matmul_ref(jnp.asarray(a), jnp.asarray(b)),
                 jgd.matmul(jnp.asarray(a), jnp.asarray(b),
                            jgd.Dataflow.OUTPUT_STATIONARY, bm=128, bn=128,
                            bk=128, interpret=True)):
        np.testing.assert_allclose(got, np.asarray(want, np.float32),
                                   rtol=1e-5, atol=8e-5)

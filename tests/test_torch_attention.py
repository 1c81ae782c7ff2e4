"""The port's attention kernels (their plain PyTorch versions, which the
CUDA kernels are held against on the GPU by chip_smoke.py) against the
JAX reference: the model path's functions (``components.flash_attention``,
``paged_attention_ref`` / ``paged_verify_attention_ref``) and the Pallas
kernels in interpret mode.  Plus the bitwise properties inside the port
that the serve engine's token-exactness rests on.

Inputs are made with numpy from a seed and handed to both packages."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import flash_attention as pallas_flash
from repro.kernels.paged_attention import (paged_attention as
                                           pallas_paged)
from repro.kernels.paged_attention.ref import (paged_attention_ref,
                                               paged_verify_attention_ref)
from repro.models.components import flash_attention as jax_flash
from repro_torch.kernels.flash_attention import (flash_attention,
                                                 flash_attention_plain)
from repro_torch.kernels.paged_attention import (SPLIT, paged_attention,
                                                 paged_attention_plain)
from repro_torch.models.components import decode_attention
from test_torch_kernels import elsewhere

# f32: both sides accumulate in f32 but split the keys into different
# online-softmax tiles (16 vs 64 keys), so results differ by a few f32
# ulps of values of magnitude ~1.
F32_TOL = 2e-5
# bf16 operands: p is rounded to bf16 before P.V on both sides, at
# tile-dependent running maxima, so outputs differ by up to a few bf16
# ulps (2^-8 relative) — the tolerance of tests/test_kernels.py.
BF16_TOL = 3e-2

DTYPES = {"float32": (torch.float32, jnp.float32, F32_TOL),
          "bfloat16": (torch.bfloat16, jnp.bfloat16, BF16_TOL)}


def _rand(rng, shape):
    return rng.standard_normal(shape).astype(np.float32)


def _pair(x, tdt, jdt):
    return torch.from_numpy(x).to(tdt), jnp.asarray(x, jdt)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _close(got, want, tol):
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)


# ------------------------------------------------------------- flash
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("causal,skv,offsets", [
    (True, 37, [0, 5, 20]),        # per-row offsets, ragged Skv, GQA
    (True, 130, [66, 3, 97]),      # keys span three 64-key tiles
    (False, 45, [0, 0, 0]),
])
def test_flash_plain_vs_model_flash(dtype, causal, skv, offsets):
    tdt, jdt, tol = DTYPES[dtype]
    rng = np.random.default_rng(0)
    B, Sq, H, KVH, Dh = 3, 17, 4, 2, 16
    q, jq = _pair(_rand(rng, (B, Sq, H, Dh)), tdt, jdt)
    k, jk = _pair(_rand(rng, (B, skv, KVH, Dh)), tdt, jdt)
    v, jv = _pair(_rand(rng, (B, skv, KVH, Dh)), tdt, jdt)
    off = np.asarray(offsets, np.int32)
    got = flash_attention(q, k, v, q_offset=torch.from_numpy(off),
                          causal=causal)
    want = jax_flash(jq, jk, jv, causal=causal, kv_chunk=16,
                     q_offset=jnp.asarray(off))
    assert got.dtype == tdt and got.shape == (B, Sq, H, Dh)
    _close(got, want, tol)


@pytest.mark.parametrize("causal", [True, False])
def test_flash_plain_vs_pallas_interpret(causal):
    """At the Pallas kernel's own shapes (block-aligned Sq/Skv, one
    static offset: queries at the end of the keys when causal)."""
    rng = np.random.default_rng(1)
    B, Sq, Skv, H, KVH, Dh = 1, 128, 256, 4, 2, 32
    q, jq = _pair(_rand(rng, (B, Sq, H, Dh)), torch.float32, jnp.float32)
    k, jk = _pair(_rand(rng, (B, Skv, KVH, Dh)), torch.float32, jnp.float32)
    v, jv = _pair(_rand(rng, (B, Skv, KVH, Dh)), torch.float32, jnp.float32)
    off = Skv - Sq if causal else 0
    want = pallas_flash.attention(jq, jk, jv, causal=causal, bq=64,
                                  bkv=64, q_offset=off, interpret=True)
    got = flash_attention(q, k, v, q_offset=off, causal=causal)
    _close(got, want, F32_TOL)


def test_flash_longer_padded_buffer_is_bitwise_identical():
    """Keys walked in fixed tiles anchored at position 0: extra trailing
    keys that the causal mask hides change no bit of any row (what makes
    chunked prefill over a gathered page buffer equal whole prefill)."""
    rng = np.random.default_rng(2)
    B, Sq, H, KVH, Dh = 2, 24, 4, 2, 16
    q = torch.from_numpy(_rand(rng, (B, Sq, H, Dh))).bfloat16()
    k = torch.from_numpy(_rand(rng, (B, 200, KVH, Dh))).bfloat16()
    v = torch.from_numpy(_rand(rng, (B, 200, KVH, Dh))).bfloat16()
    off = torch.tensor([40, 7], dtype=torch.int32)
    short = flash_attention(q, k[:, :64], v[:, :64], q_offset=off)
    long = flash_attention(q, k, v, q_offset=off)
    assert torch.equal(short, long)
    # and a row's bits do not depend on which rows share the call
    alone = flash_attention(q[1:], k[1:, :64], v[1:, :64], q_offset=off[1:])
    assert torch.equal(alone, short[1:])


def test_flash_wrapper_rejects_bad_input():
    q = torch.zeros(1, 4, 3, 16)
    k = torch.zeros(1, 4, 2, 16)
    with pytest.raises(ValueError, match="multiple"):
        flash_attention(q, k, k)
    q = torch.zeros(1, 4, 4, 16)
    with pytest.raises(ValueError, match="device"):
        flash_attention(elsewhere(q), elsewhere(k), elsewhere(k))
    q = torch.zeros(1, 4, 4, 16)
    with pytest.raises(ValueError, match="q must be"):
        flash_attention(q, k, k[:, :3])
    with pytest.raises(ValueError, match="do not match"):
        flash_attention(q, torch.zeros(1, 4, 2, 8), torch.zeros(1, 4, 2, 8))
    with pytest.raises(ValueError, match="do not match"):
        flash_attention(q, torch.zeros(2, 4, 2, 16),
                        torch.zeros(2, 4, 2, 16))
    with pytest.raises(ValueError, match="q_offset"):
        flash_attention(q, k, k, q_offset=torch.zeros(3, dtype=torch.int32))


# ------------------------------------------------------------- paged
def _paged_inputs(rng, B, T, H, KVH, Dh, ps, P, n, lengths):
    q = _rand(rng, (B, T, H, Dh))
    kp = _rand(rng, (P, ps, KVH, Dh))
    vp = _rand(rng, (P, ps, KVH, Dh))
    ids = rng.permutation(np.arange(1, P))[:B * n].reshape(B, n)
    return q, kp, vp, ids.astype(np.int32), np.asarray(lengths, np.int32)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("T", [1, 5])
def test_paged_plain_vs_verify_ref(dtype, T):
    """``paged_verify_attention_ref``'s function (per-row positions,
    causal over the speculated tokens); at T = 1 also the decode oracle
    ``paged_attention_ref`` with lengths + 1."""
    tdt, jdt, tol = DTYPES[dtype]
    rng = np.random.default_rng(3)
    B, H, KVH, Dh, ps, P, n = 3, 4, 2, 16, 8, 32, 6
    q, kp, vp, ids, lens = _paged_inputs(rng, B, T, H, KVH, Dh, ps, P, n,
                                         [0, 19, 41])
    tq, jq = _pair(q, tdt, jdt)
    tk, jk = _pair(kp, tdt, jdt)
    tv, jv = _pair(vp, tdt, jdt)
    got = paged_attention(tq, tk, tv, torch.from_numpy(ids),
                          torch.from_numpy(lens))
    want = paged_verify_attention_ref(jq, jk, jv, jnp.asarray(ids),
                                      jnp.asarray(lens))
    _close(got, want, tol)
    if T == 1:
        want1 = paged_attention_ref(jq[:, 0], jk, jv, jnp.asarray(ids),
                                    jnp.asarray(lens + 1))
        _close(got[:, 0], want1, tol)


def test_paged_plain_vs_pallas_interpret():
    rng = np.random.default_rng(4)
    B, H, KVH, Dh, ps, P, n = 3, 8, 2, 32, 8, 16, 5
    q, kp, vp, ids, lens = _paged_inputs(rng, B, 1, H, KVH, Dh, ps, P, n,
                                         [n * ps - 1, 8, 16])
    tq, jq = _pair(q, torch.float32, jnp.float32)
    tk, jk = _pair(kp, torch.float32, jnp.float32)
    tv, jv = _pair(vp, torch.float32, jnp.float32)
    want = pallas_paged(jq[:, 0], jk, jv, jnp.asarray(ids),
                        jnp.asarray(lens + 1), interpret=True)
    got = paged_attention(tq, tk, tv, torch.from_numpy(ids),
                          torch.from_numpy(lens))
    _close(got[:, 0], want, F32_TOL)


def test_paged_verify_rows_equal_single_token_decode_bitwise():
    """Query t of a T-token verify call is bit-identical to the T = 1
    decode call at position lengths + t, and does not depend on the
    table's width (the loop bound is the row's own length)."""
    rng = np.random.default_rng(5)
    B, T, H, KVH, Dh, ps, P, n = 3, 5, 4, 2, 16, 8, 40, 9
    q, kp, vp, ids, lens = _paged_inputs(rng, B, T, H, KVH, Dh, ps, P, n,
                                         [3, 30, 60])
    q, kp, vp = (torch.from_numpy(a).bfloat16() for a in (q, kp, vp))
    ids, lens = torch.from_numpy(ids), torch.from_numpy(lens)
    full = paged_attention(q, kp, vp, ids, lens)
    for t in range(T):
        one = paged_attention(q[:, t:t + 1], kp, vp, ids, lens + t)
        assert torch.equal(one[:, 0], full[:, t]), t
    wider = torch.cat([ids, torch.zeros(B, 4, dtype=ids.dtype)], 1)
    assert torch.equal(paged_attention(q, kp, vp, wider, lens), full)


def test_contiguous_decode_equals_paged_decode_bitwise():
    """The contiguous decode cache (one page of S_max per row under the
    identity table) and the same keys laid out as pages of 4 give the
    same bits: the oracle and the engine share one summation order."""
    rng = np.random.default_rng(6)
    B, H, KVH, Dh, ps, S = 2, 4, 2, 16, 4, 12
    k = torch.from_numpy(_rand(rng, (B, S, KVH, Dh))).bfloat16()
    v = torch.from_numpy(_rand(rng, (B, S, KVH, Dh))).bfloat16()
    q = torch.from_numpy(_rand(rng, (B, 1, H, Dh))).bfloat16()
    pos = 10
    kp = torch.cat([torch.zeros(1, ps, KVH, Dh, dtype=k.dtype),
                    k.reshape(B * 3, ps, KVH, Dh)])
    vp = torch.cat([torch.zeros(1, ps, KVH, Dh, dtype=v.dtype),
                    v.reshape(B * 3, ps, KVH, Dh)])
    tables = (torch.arange(B * 3, dtype=torch.int32).reshape(B, 3) + 1)
    want = decode_attention(q, k, v, pos)
    got = paged_attention(q, kp, vp, tables,
                          torch.full((B,), pos - 1, dtype=torch.int32))
    assert torch.equal(got, want)


def test_paged_verify_rows_across_a_split_boundary():
    """Rows of a T = 5 call that straddle a key split (lengths SPLIT - 3
    and 2 SPLIT - 1): the early rows of the first batch row hold no key
    of split 1, which must not reach them (its max there is -1e30, so
    exp(s - m) = 1).  Each row equals the one-token call at lengths + t
    bit for bit, and the call is close to the JAX verify reference."""
    rng = np.random.default_rng(9)
    B, T, H, KVH, Dh, ps = 2, 5, 4, 2, 16, 16
    lengths = [SPLIT - 3, 2 * SPLIT - 1]
    n = -(-(max(lengths) + T) // ps)
    q, kp, vp, ids, lens = _paged_inputs(rng, B, T, H, KVH, Dh, ps,
                                         B * n + 1, n, lengths)
    tq, jq = _pair(q, torch.bfloat16, jnp.bfloat16)
    tk, jk = _pair(kp, torch.bfloat16, jnp.bfloat16)
    tv, jv = _pair(vp, torch.bfloat16, jnp.bfloat16)
    tids, tlens = torch.from_numpy(ids), torch.from_numpy(lens)
    full = paged_attention(tq, tk, tv, tids, tlens)
    for t in range(T):
        one = paged_attention(tq[:, t:t + 1], tk, tv, tids, tlens + t)
        assert torch.equal(one[:, 0], full[:, t]), t
    want = paged_verify_attention_ref(jq, jk, jv, jnp.asarray(ids),
                                      jnp.asarray(lens))
    _close(full, want, BF16_TOL)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_paged_single_key_row(dtype):
    """A row of length 0 at T = 1 attends key 0 alone: its output is
    that key's value (exactly, in f32), as the reference has it."""
    tdt, jdt, tol = DTYPES[dtype]
    rng = np.random.default_rng(10)
    B, H, KVH, Dh, ps, P, n = 2, 4, 2, 16, 8, 8, 3
    q, kp, vp, ids, lens = _paged_inputs(rng, B, 1, H, KVH, Dh, ps, P, n,
                                         [0, 17])
    tq, jq = _pair(q, tdt, jdt)
    tk, jk = _pair(kp, tdt, jdt)
    tv, jv = _pair(vp, tdt, jdt)
    got = paged_attention(tq, tk, tv, torch.from_numpy(ids),
                          torch.from_numpy(lens))
    want = paged_verify_attention_ref(jq, jk, jv, jnp.asarray(ids),
                                      jnp.asarray(lens))
    _close(got, want, tol)
    v0 = tv[int(ids[0, 0]), 0]                           # (KVH, Dh)
    if dtype == "float32":
        assert torch.equal(got[0, 0], v0.repeat_interleave(H // KVH, 0))


def test_contiguous_decode_equals_paged_decode_across_splits():
    """As the test above, at a cache length that is no multiple of the
    key split (S_max SPLIT + 24, SPLIT + 12 keys attended: two splits,
    the second partial), with pages of 4 on the paged side."""
    rng = np.random.default_rng(11)
    B, H, KVH, Dh, ps = 2, 4, 2, 16, 4
    S, pos = SPLIT + 24, SPLIT + 12
    k = torch.from_numpy(_rand(rng, (B, S, KVH, Dh))).bfloat16()
    v = torch.from_numpy(_rand(rng, (B, S, KVH, Dh))).bfloat16()
    q = torch.from_numpy(_rand(rng, (B, 1, H, Dh))).bfloat16()
    per = S // ps
    kp = torch.cat([torch.zeros(1, ps, KVH, Dh, dtype=k.dtype),
                    k.reshape(B * per, ps, KVH, Dh)])
    vp = torch.cat([torch.zeros(1, ps, KVH, Dh, dtype=v.dtype),
                    v.reshape(B * per, ps, KVH, Dh)])
    tables = torch.arange(B * per, dtype=torch.int32).reshape(B, per) + 1
    want = decode_attention(q, k, v, pos)
    got = paged_attention(q, kp, vp, tables,
                          torch.full((B,), pos - 1, dtype=torch.int32))
    assert torch.equal(got, want)


def test_paged_wrapper_rejects_bad_input():
    q = torch.zeros(2, 1, 4, 16)
    pages = torch.zeros(8, 4, 2, 16, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="page_tables"):
        paged_attention(q, pages, pages, torch.zeros(3, 2, dtype=torch.int32),
                        torch.zeros(2, dtype=torch.int32))
    with pytest.raises(ValueError, match="device"):
        paged_attention(*map(elsewhere, (
            q, pages, pages, torch.zeros(2, 2, dtype=torch.int32),
            torch.zeros(2, dtype=torch.int32))))


def test_plain_versions_are_the_cpu_path():
    """On a CPU tensor the wrapper is its plain version, launches no
    kernel and counts nothing."""
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.paged_attention import ops as pops
    rng = np.random.default_rng(7)
    q = torch.from_numpy(_rand(rng, (1, 8, 2, 16)))
    k = torch.from_numpy(_rand(rng, (1, 8, 1, 16)))
    before = (fops.launches, pops.launches)
    assert torch.equal(flash_attention(q, k, k),
                       flash_attention_plain(q, k, k))
    pages = k.reshape(2, 4, 1, 16).bfloat16()
    tbl = torch.tensor([[0, 1]], dtype=torch.int32)
    ln = torch.tensor([3], dtype=torch.int32)
    assert torch.equal(paged_attention(q[:, :1], pages, pages, tbl, ln),
                       paged_attention_plain(q[:, :1], pages, pages, tbl,
                                             ln))
    assert (fops.launches, pops.launches) == before


@pytest.mark.parametrize("start", [0, 8, 24, 56])
def test_flash_chunk_rows_equal_whole_prefill_rows(start):
    """Each row of an 8-row call at q_offset ``start`` over the first
    start + 8 keys equals the same row of the whole prefill, bit for
    bit: chunked == whole prefill at the function's level (chip_smoke.py
    holds the CUDA kernel to the same at 32-row chunks of 512)."""
    rng = np.random.default_rng(8)
    B, S, H, KVH, Dh, C = 2, 64, 4, 2, 16, 8
    q = torch.from_numpy(_rand(rng, (B, S, H, Dh))).bfloat16()
    k = torch.from_numpy(_rand(rng, (B, S, KVH, Dh))).bfloat16()
    v = torch.from_numpy(_rand(rng, (B, S, KVH, Dh))).bfloat16()
    whole = flash_attention(q, k, v, q_offset=0)
    off = torch.full((B,), start, dtype=torch.int32)
    part = flash_attention(q[:, start:start + C], k[:, :start + C],
                           v[:, :start + C], q_offset=off)
    assert torch.equal(part, whole[:, start:start + C])

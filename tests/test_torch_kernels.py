"""The port's paper-side kernels (dataflow GEMM, block-sparse GEMM, LUT
activation) against the JAX reference: their plain PyTorch versions,
which the CUDA kernels are held against on the GPU by chip_smoke.py,
compared with the reference's oracles (``ref.py``) and with the Pallas
kernels in interpret mode; the host-side helpers (traffic model, mask
compiler, tables) compared exactly.

Inputs are made with numpy from a seed and handed to both packages."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import block_sparse as jbs
from repro.kernels import gemm_dataflow as jgd
from repro.kernels import lut_activation as jlut
from repro_torch.kernels import block_sparse as bs
from repro_torch.kernels import gemm_dataflow as gd
from repro_torch.kernels import lut_activation as lut
from repro_torch.kernels.block_sparse import ops as bs_ops
from repro_torch.kernels.gemm_dataflow import ops as gd_ops
from repro_torch.kernels.lut_activation import ops as lut_ops

# the tolerances of tests/test_kernels.py: f32 products summed in other
# orders differ by a few f32 ulps; bf16 operands are exact in f32 on
# both sides, so bf16 cases differ by summation order alone and sit far
# inside the reference's bf16 bound
TOL = {"float32": 1e-5, "bfloat16": 2e-2}


def _operand(rng, shape, dtype):
    """The same values as a torch tensor and a jax array (bf16 values
    are rounded once, by jax, and carried over exactly)."""
    x = jnp.asarray(rng.standard_normal(shape).astype(np.float32),
                    getattr(jnp, dtype))
    return torch.from_numpy(np.array(x, np.float32)).to(
        getattr(torch, dtype)), x


def _close(got, want, dtype):
    tol = TOL[dtype]
    np.testing.assert_allclose(got.numpy(), np.asarray(want, np.float32),
                               rtol=tol, atol=tol * 8)


# ---------------------------------------------------------------- gemm
@pytest.mark.parametrize("dataflow", list(gd.Dataflow))
@pytest.mark.parametrize("m,n,k", [(128, 128, 128), (256, 128, 384),
                                   (200, 130, 100)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gemm_matches_reference(dataflow, m, n, k, dtype):
    rng = np.random.default_rng(m + n + k)
    a, ja = _operand(rng, (m, k), dtype)
    b, jb = _operand(rng, (k, n), dtype)
    got = gd.matmul(a, b, dataflow)
    assert got.dtype == torch.float32 and got.shape == (m, n)
    _close(got, jgd.matmul_ref(ja, jb), dtype)
    _close(gd.matmul_ref(a, b), jgd.matmul_ref(ja, jb), dtype)


@pytest.mark.parametrize("dataflow", list(gd.Dataflow))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gemm_matches_pallas_interpret(dataflow, dtype):
    """The ragged shape: the Pallas wrapper pads, the port masks."""
    rng = np.random.default_rng(5)
    a, ja = _operand(rng, (200, 100), dtype)
    b, jb = _operand(rng, (100, 130), dtype)
    want = jgd.matmul(ja, jb, jgd.Dataflow[dataflow.name], bm=128, bn=128,
                      bk=128, interpret=True)
    _close(gd.matmul(a, b, dataflow), want, dtype)


def test_gemm_dataflows_mirror_the_reference_enum():
    assert [(d.name, d.value) for d in gd.Dataflow] == \
        [(d.name, d.value) for d in jgd.Dataflow]


def test_gemm_plain_sums_tile_products_in_ascending_k():
    """psum += (tile product formed from zero), k tile by k tile."""
    rng = np.random.default_rng(6)
    a = torch.from_numpy(rng.standard_normal((64, 300)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal((300, 32)).astype(np.float32))
    want = torch.zeros(64, 32)
    for k0 in (0, 128, 256):
        want = want + a[:, k0:k0 + 128] @ b[k0:k0 + 128]
    assert torch.equal(gd.matmul_plain(a, b), want)


@pytest.mark.parametrize("dataflow", list(gd.Dataflow))
@pytest.mark.parametrize("m,n,k,tile", [(2048, 2048, 2048, 128),
                                        (8192, 8192, 5120, 128),
                                        (200, 130, 100, 64)])
def test_modeled_traffic_equals_reference(dataflow, m, n, k, tile):
    got = gd.modeled_traffic(m, n, k, dataflow, bm=tile, bn=tile, bk=tile)
    want = jgd.modeled_traffic(m, n, k, jgd.Dataflow[dataflow.name],
                               bm=tile, bn=tile, bk=tile)
    assert got == want


def test_modeled_traffic_keeps_the_table6_order():
    """All-Reuse < Ifmap/Filter < No-Reuse (paper Table 6 / Fig 13)."""
    t = {df: gd.modeled_traffic(2048, 2048, 2048, df)["total_bytes"]
         for df in gd.Dataflow}
    D = gd.Dataflow
    assert t[D.OUTPUT_STATIONARY] < t[D.INPUT_STATIONARY] < t[D.NO_REUSE]
    assert t[D.OUTPUT_STATIONARY] < t[D.WEIGHT_STATIONARY] < t[D.NO_REUSE]


# ---------------------------------------------------------- block sparse
@pytest.mark.parametrize("density", [0.0, 0.25, 0.6, 1.0])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_block_sparse_matches_reference(density, dtype):
    m, k, n = 128, 512, 384
    rng = np.random.default_rng(int(density * 100))
    a, ja = _operand(rng, (m, k), dtype)
    b, jb = _operand(rng, (k, n), dtype)
    mask = rng.random((k // 128, n // 128)) < density
    if 0 < density < 1:
        mask[:, 1] = False                  # one dead column for sure
    got = bs.matmul(a, b, mask)
    assert got.dtype == torch.float32 and got.shape == (m, n)
    _close(got, jbs.matmul(ja, jb, mask, interpret=True), dtype)
    _close(got, jbs.matmul_block_sparse_ref(ja, jb, jnp.asarray(mask),
                                            128, 128), dtype)
    dead = np.repeat(~mask.any(axis=0), 128)
    assert (got[:, torch.from_numpy(dead)] == 0).all()
    assert dead.any() == (density < 1)


@pytest.mark.parametrize("density", [0.0, 0.3, 0.6, 1.0])
def test_block_sparse_mask_compiler_equals_reference(density):
    rng = np.random.default_rng(7)
    w = rng.standard_normal((6 * 16, 5 * 8)).astype(np.float32)
    keep = rng.random((6, 5)) < density
    w *= np.repeat(np.repeat(keep, 16, 0), 8, 1)
    mask = bs.mask_from_weights(w, 16, 8)
    np.testing.assert_array_equal(mask, jbs.mask_from_weights(w, 16, 8))
    np.testing.assert_array_equal(mask, keep)
    for got, want in zip(bs.compile_mask(mask), jbs.compile_mask(mask)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    assert bs.sparse_savings(mask) == jbs.sparse_savings(mask)
    np.testing.assert_array_equal(
        bs.expand_mask(mask, 16, 8),
        np.asarray(jbs.ref.expand_mask(jnp.asarray(mask), 16, 8)))
    # the kernel's table: the same live tiles, no sentinel step
    col_start, live_k = bs.column_table(mask)
    assert col_start[0] == 0 and col_start[-1] == mask.sum()
    for j in range(mask.shape[1]):
        np.testing.assert_array_equal(
            live_k[col_start[j]:col_start[j + 1]], np.nonzero(mask[:, j])[0])


# ------------------------------------------------------------------ lut
def _lut_input(rng, dtype):
    """(512, 256) values: exact half steps LUT_LO + (i + 0.5) STEP, grid
    points, +-inf, |x| > 8, and normal activations."""
    n = 512 * 256
    idx = rng.integers(0, lut.LUT_ENTRIES, n)
    half = (lut.LUT_LO + (idx + 0.5) * lut.STEP).astype(np.float32)
    x = rng.standard_normal(n).astype(np.float32) * 3
    x[::4] = half[::4]
    x[1::4] = (lut.LUT_LO + idx[1::4] * lut.STEP).astype(np.float32)
    x[:8] = [np.inf, -np.inf, 8.5, -8.5, 1e30, -1e30, 7.99990, -8.0]
    # the first eight half steps: half to even gives 0, 2, 2, 4, 4, ...
    x[8:16] = lut.LUT_LO + (np.arange(8) + 0.5) * lut.STEP
    jx = jnp.asarray(x.reshape(512, 256), getattr(jnp, dtype))
    return torch.from_numpy(np.array(jx, np.float32)).to(
        getattr(torch, dtype)), jx


@pytest.mark.parametrize("name", ["sigmoid", "tanh", "gelu", "exp"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_lut_is_bit_identical_to_reference(name, dtype):
    x, jx = _lut_input(np.random.default_rng(8), dtype)
    jtable = jlut.table_for(name)
    table = torch.from_numpy(np.array(jtable))
    want = np.asarray(jlut.lut_ref(jx, jtable))
    for got in (lut.lut_activation(x, table), lut.lut_plain(x, table)):
        assert got.dtype == torch.float32 and got.shape == x.shape
        np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        np.asarray(jlut.apply_lut(jx, name, interpret=True)), want)
    # apply_lut is the wrapper on the port's own table
    assert torch.equal(lut.apply_lut(x, name),
                       lut.lut_activation(x, lut.table_for(name)))


def test_lut_quantization_equals_reference():
    x, jx = _lut_input(np.random.default_rng(9), "float32")
    x = torch.cat([x.flatten(), torch.tensor([float("nan")])])
    jx = jnp.concatenate([jx.ravel(), jnp.array([jnp.nan])])
    q = lut.quantize_u16(x)
    assert q.dtype == torch.int32
    np.testing.assert_array_equal(q.numpy(),
                                  np.asarray(jlut.quantize_u16(jx)))
    assert q[8:16].tolist() == [0, 2, 2, 4, 4, 6, 6, 8]


@pytest.mark.parametrize("name", sorted(lut.TABLES))
def test_lut_tables_match_reference(name):
    """torch's and XLA's functions differ by a few f32 ulps (exact for
    relu and recip); gelu's far tail is -0.0 in XLA and -5.8e-7 here."""
    got = lut.table_for(name).numpy()
    want = np.asarray(jlut.table_for(name))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    if name in ("relu", "recip"):
        np.testing.assert_array_equal(got, want)


def test_lut_exact_on_grid():
    """Exact for 16-bit-quantized inputs — the paper's accuracy claim."""
    idx = torch.arange(0, 1 << 16, 257)
    x = (idx.float() * (16.0 / (1 << 16)) - 8.0).reshape(1, -1)
    got = lut.apply_lut(x, "tanh")
    torch.testing.assert_close(got, torch.tanh(x), rtol=0, atol=3e-4)


# ------------------------------------------------------- the wrappers
class _Elsewhere(torch.Tensor):
    """A CPU tensor that reports a device no wrapper takes."""

    @property
    def device(self):
        return torch.device("xpu")


def elsewhere(t: torch.Tensor) -> torch.Tensor:
    """``t`` as seen on a device other than the CPU, CUDA and meta."""
    return torch.Tensor._make_subclass(_Elsewhere, t)


def test_wrappers_use_the_plain_version_only_on_the_cpu():
    """CPU tensors take the plain version without building or counting
    anything; any other device than the CPU or CUDA is refused (the
    dataflow GEMM's also takes meta: the dry run's shape-only
    branch)."""
    from repro_torch.kernels import build
    before = (gd_ops.launches, bs_ops.launches, lut_ops.launches)
    a = torch.ones(8, 8)
    gd.matmul(a, a)
    bs.matmul(a, a, np.ones((1, 1), bool))
    lut.apply_lut(a, "tanh")
    assert (gd_ops.launches, bs_ops.launches, lut_ops.launches) == before
    assert not {"gemm_dataflow", "block_sparse", "lut_activation"} \
        & set(build._libs)
    m = torch.ones(8, 8, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        gd.matmul(elsewhere(a), elsewhere(a))
    with pytest.raises(ValueError, match="unsupported device"):
        bs.matmul(m, m, np.ones((1, 1), bool))
    with pytest.raises(ValueError, match="unsupported device"):
        lut.lut_activation(m, torch.zeros(lut.LUT_ENTRIES, device="meta"))


def test_wrappers_refuse_what_the_kernels_do_not_take():
    a = torch.ones(8, 8)
    with pytest.raises(ValueError, match="do not chain"):
        gd.matmul(a, torch.ones(7, 8))
    with pytest.raises(TypeError):
        gd.matmul(a, a.bfloat16())
    with pytest.raises(ValueError, match="on"):
        gd.matmul(a, torch.ones(8, 8, device="meta"))
    with pytest.raises(ValueError, match="mask shape"):
        bs.matmul(a, a, np.ones((2, 1), bool))
    with pytest.raises(ValueError, match="do not chain"):
        bs.matmul(a, torch.ones(7, 8), np.ones((1, 1), bool))
    with pytest.raises(TypeError):
        bs.matmul(a, a.bfloat16(), np.ones((1, 1), bool))
    with pytest.raises(ValueError, match="table must be"):
        lut.lut_activation(a, torch.zeros(10))


# ------------------------------------------------ the bf16 pipeline
@pytest.mark.parametrize("shapes,want", [
    (((8192, 5120), (5120, 8192)), "TMA"),          # scout expert GEMM
    (((16384, 5120), (5120, 8192)), "TMA"),         # scout at 2M
    (((8192, 5120), (5120, 16384)), "TMA"),         # scout at 2N
    (((1000, 5100), (5100, 999)), "CP_ASYNC"),      # ragged bf16
    (((1000, 5120), (5120, 999)), "CP_ASYNC"),      # B rows 1,998 bytes
    (((1000, 5100), (5100, 1000)), "CP_ASYNC"),     # A rows 10,200 bytes
])
def test_producer_follows_the_operands_strides(shapes, want):
    """TMA needs 16-byte row strides; the shapes alone decide here
    (meta tensors have address 0)."""
    a, b = (torch.empty(s, dtype=torch.bfloat16, device="meta")
            for s in shapes)
    assert gd_ops.producer_for(a, b) == getattr(gd_ops, want)


def test_producer_follows_the_operands_alignment():
    """An operand that starts off a 16-byte boundary takes cp.async
    even when its row stride would allow TMA."""
    base = torch.zeros(64 * 64 + 8, dtype=torch.bfloat16)
    aligned = base[:64 * 64].view(64, 64)
    assert aligned.data_ptr() % 16 == 0
    assert gd_ops.producer_for(aligned, aligned) == gd_ops.TMA
    for off in (1, 4):                              # 2 and 8 bytes off
        shifted = base[off:off + 64 * 64].view(64, 64)
        assert gd_ops.producer_for(shifted, aligned) == gd_ops.CP_ASYNC
        assert gd_ops.producer_for(aligned, shifted) == gd_ops.CP_ASYNC
    # f32 operands: 16-byte rows at four elements
    f = torch.zeros(8, 4)
    assert gd_ops.producer_for(f, f) == gd_ops.TMA


def test_build_hash_covers_every_shared_header(tmp_path, monkeypatch):
    """Both GEMMs include the pipeline header; editing it (or any
    csrc/*.cuh) renames every library, so nothing stale is loaded."""
    from repro_torch.kernels import build
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    for f in build._CSRC.iterdir():
        (csrc / f.name).write_bytes(f.read_bytes())
    for name in ("gemm_dataflow.cu", "block_sparse.cu"):
        assert '#include "wgmma_pipe.cuh"' in (csrc / name).read_text()
    monkeypatch.setattr(build, "_CSRC", csrc)
    before = {n: build._lib_path(n) for n in build.SOURCES}
    hdr = csrc / "wgmma_pipe.cuh"
    hdr.write_text(hdr.read_text() + "\n// edited\n")
    after = {n: build._lib_path(n) for n in build.SOURCES}
    assert all(before[n] != after[n] for n in build.SOURCES)

"""Port parity: the stitch kernels' plain PyTorch versions against the JAX
package's Pallas kernels (interpret mode) and its jnp oracles, on every case
of tests/test_kernels.py. Inputs come from one numpy seed and go through
both packages; bf16 inputs are rounded from the same float32 draws.

On the CPU each wrapper must take its plain version and launch nothing;
the CUDA kernels themselves are held against the same plain versions on the
card by chip_smoke.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels.ref import stitched_decode_attention_ref as jattn_ref
from repro_torch.alloc import Extent
from repro_torch.kernels import ops, ref

DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16),
          "int32": (jnp.int32, torch.int32)}


def draw(rng, shape, name):
    """The same values as a (jax, torch) pair."""
    if name == "int32":
        x = rng.integers(-8, 8, size=shape).astype(np.int32)
    else:
        x = rng.standard_normal(shape).astype(np.float32)
    jd, td = DTYPES[name]
    return jnp.asarray(x).astype(jd), torch.from_numpy(x).to(td)


def as_np(x):
    """float64 numpy view of a jax array or torch tensor (exact for bf16/f32/int32)."""
    if isinstance(x, torch.Tensor):
        return x.double().numpy()
    return np.asarray(x.astype(jnp.float32), np.float64)


def ints(x):
    x = np.asarray(x, np.int32)
    return jnp.asarray(x), torch.from_numpy(x)


@pytest.fixture(autouse=True)
def zero_counts():
    ops.reset_launch_counts()
    yield
    # a CPU tensor never reaches a kernel
    assert ops.launch_counts() == {
        "stitch_gather": 0, "stitch_scatter": 0, "stitched_decode_attention": 0}


# ---------------------------------------------------------------------------
# stitch gather / scatter
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int32"])
@pytest.mark.parametrize(
    "n_phys,chunk_elems,n_logical", [(8, 256, 3), (32, 512, 32), (4, 128, 1), (64, 1024, 17)]
)
def test_gather_matches_jax(dtype, n_phys, chunk_elems, n_logical):
    rng = np.random.default_rng(n_phys * 7 + n_logical)
    ja, ta = draw(rng, (n_phys, chunk_elems), dtype)
    jm, tm = ints(rng.permutation(n_phys)[:n_logical])
    got = as_np(ops.gather(ta, tm))
    np.testing.assert_array_equal(got, as_np(jops.gather(ja, jm, interpret=True)))
    np.testing.assert_array_equal(got, as_np(jops.gather_ref(ja, jm)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n_phys,chunk_elems,n_logical", [(8, 256, 3), (16, 512, 16)])
def test_scatter_matches_jax(dtype, n_phys, chunk_elems, n_logical):
    rng = np.random.default_rng(n_phys + n_logical)
    ja, ta = draw(rng, (n_phys, chunk_elems), dtype)
    jm, tm = ints(rng.permutation(n_phys)[:n_logical])
    jv, tv = draw(rng, (n_logical, chunk_elems), dtype)
    out = ops.scatter(ta, tm, tv)
    assert out is ta  # in place
    got = as_np(out)
    np.testing.assert_array_equal(got, as_np(jops.scatter(ja, jm, jv, interpret=True)))
    np.testing.assert_array_equal(got, as_np(jops.scatter_ref(ja, jm, jv)))


def test_scatter_preserves_unmapped_chunks():
    x = np.arange(8 * 128, dtype=np.float32).reshape(8, 128)
    arena = torch.from_numpy(x.copy())
    ops.scatter(arena, torch.tensor([2, 5], dtype=torch.int32), torch.zeros(2, 128))
    jout = jops.scatter(jnp.asarray(x), jnp.array([2, 5], jnp.int32),
                        jnp.zeros((2, 128), jnp.float32), interpret=True)
    np.testing.assert_array_equal(arena.numpy(), np.asarray(jout))
    untouched = [i for i in range(8) if i not in (2, 5)]
    np.testing.assert_array_equal(arena.numpy()[untouched], x[untouched])
    assert float(arena[[2, 5]].abs().max()) == 0.0


def test_gather_scatter_roundtrip():
    """scatter(gather(x)) through a permutation is the identity."""
    rng = np.random.default_rng(1)
    _, arena = draw(rng, (16, 256), "float32")
    _, perm = ints(rng.permutation(16))
    back = ops.scatter(torch.zeros_like(arena), perm, ops.gather(arena, perm))
    assert torch.equal(back, arena)


# ---------------------------------------------------------------------------
# stitched decode attention
# ---------------------------------------------------------------------------

ATTN_CASES = [
    # (B, H, KVH, D, chunk_tokens, n_chunks, n_phys), as tests/test_kernels.py
    (1, 8, 8, 64, 16, 2, 4),  # MHA
    (4, 16, 4, 64, 32, 3, 12),  # GQA 4:1
    (2, 12, 1, 128, 16, 4, 8),  # MQA
    (3, 9, 3, 64, 8, 5, 16),  # smollm-like heads
]
TOL = {"float32": 2e-5, "bfloat16": 2e-2}


def _attn_pair(case, dtype, seq_lens=None, separate_v=False, seed=0):
    """Run the port and both JAX versions on one drawn input; return
    (port, jax interpret kernel, jax oracle) as float64 numpy."""
    B, H, KVH, D, Tc, C, NP = case
    rng = np.random.default_rng(seed)
    jq, tq = draw(rng, (B, H, D), dtype)
    jk, tk = draw(rng, (NP, Tc, KVH, D), dtype)
    jv, tv = draw(rng, (NP, Tc, KVH, D), dtype)
    jpt, tpt = ints(rng.integers(0, NP, size=(B, C)))
    jptv, tptv = ints(rng.integers(0, NP, size=(B, C)))
    if seq_lens is None:
        seq_lens = rng.integers(1, C * Tc + 1, size=B)
    jsl, tsl = ints(seq_lens)
    if separate_v:
        got = ops.decode_attention(tq, tk, tk, tpt, tsl, page_table_v=tptv)
        jout = jops.decode_attention(jq, jk, jk, jpt, jsl, jptv, interpret=True)
        jref = jattn_ref(jq, jk, jk, jpt, jsl, jptv)
    else:
        got = ops.decode_attention(tq, tk, tv, tpt, tsl)
        jout = jops.decode_attention(jq, jk, jv, jpt, jsl, interpret=True)
        jref = jattn_ref(jq, jk, jv, jpt, jsl)
    assert got.dtype == tq.dtype and got.shape == tq.shape
    return as_np(got), as_np(jout), as_np(jref)


@pytest.mark.parametrize("case", ATTN_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_attention_matches_jax(case, dtype):
    got, jout, jref = _attn_pair(case, dtype, seed=sum(case))
    tol = TOL[dtype]
    np.testing.assert_allclose(got, jout, rtol=tol, atol=tol)
    np.testing.assert_allclose(got, jref, rtol=tol, atol=tol)


def test_decode_attention_separate_kv_tables():
    got, jout, jref = _attn_pair((2, 8, 4, 64, 16, 3, 12), "float32", seq_lens=[20, 48],
                                 separate_v=True)
    np.testing.assert_allclose(got, jout, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(got, jref, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("seq_lens", [[1, 7], [0, 5]])
def test_decode_attention_short_sequences(seq_lens):
    """seq_len smaller than one chunk: padding chunks must add nothing, and
    a sequence of length 0 gives zeros (the l = 0 guard)."""
    got, jout, jref = _attn_pair((2, 4, 2, 64, 32, 4, 8), "float32", seq_lens=seq_lens)
    np.testing.assert_allclose(got, jout, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(got, jref, rtol=2e-5, atol=2e-5)
    if seq_lens[0] == 0:
        assert not got[0].any()


def test_decode_attention_reads_strided_chunks():
    """The KV cache hands the kernels the token-structured prefix of every
    chunk (chunk stride > T_c * KVH * D); the result must equal the same
    data packed contiguously."""
    rng = np.random.default_rng(3)
    B, H, KVH, D, Tc, C, NP, spare = 2, 6, 2, 32, 5, 3, 6, 17
    buf = torch.from_numpy(rng.standard_normal((NP, Tc * KVH * D + spare)).astype(np.float32))
    view = buf[:, : Tc * KVH * D].unflatten(1, (Tc, KVH, D))
    packed = view.contiguous()
    q = torch.from_numpy(rng.standard_normal((B, H, D)).astype(np.float32))
    pt = torch.from_numpy(rng.integers(0, NP, size=(B, C)).astype(np.int32))
    sl = torch.tensor([4, 13], dtype=torch.int32)
    torch.testing.assert_close(ops.decode_attention(q, view, view, pt, sl),
                               ref.stitched_decode_attention_ref(q, packed, packed, pt, sl))


# ---------------------------------------------------------------------------
# dispatch and host-side map checks
# ---------------------------------------------------------------------------


def test_chunk_map_from_extents():
    cmap = ops.chunk_map_from_extents([Extent(4, 2), Extent(0, 1)], n_phys=8, device="cpu")
    assert cmap.dtype == torch.int32 and cmap.tolist() == [4, 5, 0]
    with pytest.raises(ValueError, match="outside"):
        ops.chunk_map_from_extents([Extent(7, 2)], n_phys=8, device="cpu")
    with pytest.raises(ValueError, match="repeat"):
        ops.chunk_map_from_extents([Extent(1, 2), Extent(2, 1)], n_phys=8, device="cpu")


def test_wrappers_refuse_other_devices():
    """Only CPU (plain version) and CUDA (kernel) tensors are taken."""
    arena = torch.zeros((4, 64), device="meta")
    cmap = torch.zeros(2, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):
        ops.gather(arena, cmap)
    with pytest.raises(ValueError):
        ops.scatter(arena, cmap, torch.zeros((2, 64), device="meta"))
    q = torch.zeros((1, 2, 8), device="meta")
    kv = torch.zeros((2, 4, 1, 8), device="meta")
    with pytest.raises(ValueError):
        ops.decode_attention(q, kv, kv, cmap[None], cmap[:1])

"""Port parity: Arena and StitchedKVCache against the JAX package.

Both packages drive their own (identical) allocator copies through the same
operation sequence, so page tables, allocation extents and even the arena
buffers must come out identical. At smollm-135m's KV geometry (n_kv=3,
head_dim=64, bf16: a 384-byte token row that does not divide 2 MiB) the
reference's token view raises; the port is held to a numpy oracle there."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.arena import Arena as JArena, ArenaConfig as JArenaConfig
from repro.core.kvcache import KVCacheConfig as JKVConfig, StitchedKVCache as JKV
from repro_torch.alloc import CHUNK_SIZE
from repro_torch.core.arena import Arena, ArenaConfig
from repro_torch.core.kvcache import KVCacheConfig, StitchedKVCache


def extents(alloc):
    return [(e.start, e.n) for e in alloc.block.extents]


def test_arena_store_load_roundtrip_matches_jax():
    x = np.random.default_rng(0).standard_normal((123, 457)).astype(np.float32)
    ja = JArena(JArenaConfig(n_chunks=32, dtype=jnp.float32, interpret=True))
    ta = Arena(ArenaConfig(n_chunks=32, dtype=torch.float32, device="cpu"))
    jalloc, talloc = ja.alloc_elems(x.size), ta.alloc_elems(x.size)
    assert extents(talloc) == extents(jalloc)
    ja.store(jalloc, jnp.asarray(x))
    ta.store(talloc, torch.from_numpy(x))
    np.testing.assert_array_equal(ta.buf.numpy(), np.asarray(ja.buf))
    np.testing.assert_array_equal(ta.load(talloc, x.shape).numpy(), x)
    # a second tensor reuses freed chunks
    ja.free(jalloc)
    ta.free(talloc)
    ja.alloc_elems(x.size)
    ta.alloc_elems(x.size)
    assert ta.allocator.state_counts["S1"] >= 1
    assert ta.allocator.state_counts == ja.allocator.state_counts


def test_fragmented_arena_stitches_and_roundtrips():
    """After alloc/free churn a tensor lands on several extents; store/load
    still round-trips bit-exact, and matches the reference's buffer."""
    n = 3 * CHUNK_SIZE // 2  # three bf16 chunks
    x = np.random.default_rng(1).standard_normal(n).astype(np.float32)
    arenas = []
    for arena, to in ((JArena(JArenaConfig(n_chunks=8, dtype=jnp.bfloat16, interpret=True)),
                       lambda a: jnp.asarray(a).astype(jnp.bfloat16)),
                      (Arena(ArenaConfig(n_chunks=8, dtype=torch.bfloat16, device="cpu")),
                       lambda a: torch.from_numpy(a).to(torch.bfloat16))):
        churn = [arena.alloc_elems(CHUNK_SIZE // 2) for _ in range(8)]
        for a in churn[::2]:
            arena.free(a)
        alloc = arena.alloc_elems(n)
        arena.store(alloc, to(x))
        arenas.append((arena, alloc))
    (ja, jalloc), (ta, talloc) = arenas
    assert len(talloc.block.extents) > 1
    assert extents(talloc) == extents(jalloc)
    back = ta.load(talloc, (n,))
    assert torch.equal(back, torch.from_numpy(x).to(torch.bfloat16))
    np.testing.assert_array_equal(ta.buf.float().numpy(),
                                  np.asarray(ja.buf.astype(jnp.float32)))


def test_data_paths_need_a_stitching_backend():
    ta = Arena(ArenaConfig(n_chunks=16, dtype=torch.float32, device="cpu"), allocator="caching")
    alloc = ta.alloc_elems(10)
    with pytest.raises(TypeError, match="stitching"):
        ta.store(alloc, torch.zeros(10))


def _grow_and_write(kv, toks, more, to):
    kv.add_sequence(0, 100)
    kv.write_tokens(0, 0, "k", 0, to(toks))
    kv.write_tokens(0, 0, "v", 0, to(toks))
    kv.append_tokens(0, kv.config.chunk_tokens * 2)  # force growth across chunks
    kv.write_tokens(0, 0, "k", 100, to(more))
    kv.write_tokens(0, 0, "v", 100, to(more))


def test_kvcache_grow_and_decode_matches_jax():
    rng = np.random.default_rng(2)
    jkv = JKV(JKVConfig(n_layers=1, n_kv=2, head_dim=64, dtype=jnp.float32, n_chunks=64,
                        interpret=True))
    tkv = StitchedKVCache(KVCacheConfig(n_layers=1, n_kv=2, head_dim=64, dtype=torch.float32,
                                        n_chunks=64, device="cpu"))
    ct = tkv.config.chunk_tokens
    toks = rng.standard_normal((100, 2, 64)).astype(np.float32)
    more = rng.standard_normal((ct * 2, 2, 64)).astype(np.float32)
    q = rng.standard_normal((1, 4, 64)).astype(np.float32)
    _grow_and_write(jkv, toks, more, jnp.asarray)
    _grow_and_write(tkv, toks, more, torch.from_numpy)
    for kv in ("k", "v"):
        jpt, jlen = jkv.page_table([0], 0, kv)
        tpt, tlen = tkv.page_table([0], 0, kv)
        assert tpt.dtype == torch.int32
        np.testing.assert_array_equal(tpt.numpy(), np.asarray(jpt))
        np.testing.assert_array_equal(tlen.numpy(), np.asarray(jlen))
    np.testing.assert_array_equal(tkv.arena.buf.numpy(), np.asarray(jkv.arena.buf))
    out = tkv.decode_attention([0], 0, torch.from_numpy(q))
    jout = jkv.decode_attention([0], 0, jnp.asarray(q))
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=1e-4, atol=1e-4)
    # oracle over the dense concatenation
    k = np.concatenate([toks, more])
    qg = (q[0] * 64**-0.5).reshape(2, 2, 64)
    s = np.einsum("kgd,tkd->kgt", qg, k)
    p = np.exp(s - s.max(-1, keepdims=True))
    p /= p.sum(-1, keepdims=True)
    exp = np.einsum("kgt,tkd->kgd", p, k).reshape(4, 64)
    np.testing.assert_allclose(out[0].numpy(), exp, rtol=1e-4, atol=1e-4)


def test_kvcache_page_tables_match_jax_under_churn():
    """Same add/append/free sequence -> identical page tables, on the
    engine's own geometry (two layers, growth across chunks, retirements)."""
    caches = [JKV(JKVConfig(n_layers=2, n_kv=4, head_dim=64, dtype=jnp.bfloat16,
                            n_chunks=96)),
              StitchedKVCache(KVCacheConfig(n_layers=2, n_kv=4, head_dim=64,
                                            dtype=torch.bfloat16, n_chunks=96, device="cpu"))]
    ct = caches[1].config.chunk_tokens
    for kv in caches:
        for sid in range(6):
            kv.add_sequence(sid, 50 + 900 * sid)
        kv.free_sequence(1)
        kv.append_tokens(0, 2 * ct)
        kv.free_sequence(3)
        kv.add_sequence(6, 3 * ct + 5)
        kv.append_tokens(5, ct)
    live = [0, 2, 4, 5, 6]
    for layer in range(2):
        for side in ("k", "v"):
            jpt, jlen = caches[0].page_table(live, layer, side)
            tpt, tlen = caches[1].page_table(live, layer, side)
            np.testing.assert_array_equal(tpt.numpy(), np.asarray(jpt))
            np.testing.assert_array_equal(tlen.numpy(), np.asarray(jlen))


def test_smollm_full_kv_geometry_against_numpy_oracle():
    """n_kv=3, head_dim=64, bf16: 5461 tokens per chunk with 256 bytes left
    over. The reference's arena_view raises here; the port uses the first
    5461 * 3 * 64 elements of each chunk. Writes cross a chunk boundary."""
    jkv = JKV(JKVConfig(n_layers=1, n_kv=3, head_dim=64, dtype=jnp.bfloat16, n_chunks=8))
    jkv.add_sequence(0, 10)
    with pytest.raises(TypeError):
        jkv.arena_view()

    kv = StitchedKVCache(KVCacheConfig(n_layers=1, n_kv=3, head_dim=64,
                                       dtype=torch.bfloat16, n_chunks=8, device="cpu"))
    ct = kv.config.chunk_tokens
    assert ct == 5461
    view = kv.arena_view()
    assert view.shape == (8, ct, 3, 64)
    assert view.data_ptr() == kv.arena.buf.data_ptr()  # a view of the same storage
    rng = np.random.default_rng(3)
    lens = [ct + 300, 40]
    seqs = {}
    for sid, n in enumerate(lens):
        kv.add_sequence(sid, n)
        k = torch.from_numpy(rng.standard_normal((n, 3, 64)).astype(np.float32))
        v = torch.from_numpy(rng.standard_normal((n, 3, 64)).astype(np.float32))
        kv.write_tokens(sid, 0, "k", 0, k[: ct - 7])  # two writes, the second crossing
        kv.write_tokens(sid, 0, "k", ct - 7, k[ct - 7:])
        kv.write_tokens(sid, 0, "v", 0, v)
        seqs[sid] = (k.to(torch.bfloat16).float().numpy(), v.to(torch.bfloat16).float().numpy())
    # the spare tail of every chunk stays untouched
    assert not kv.arena.buf[:, ct * 3 * 64:].any()
    q = torch.from_numpy(rng.standard_normal((2, 9, 64)).astype(np.float32)).to(torch.bfloat16)
    out = kv.decode_attention([0, 1], 0, q).float().numpy()
    qs = (q * 64**-0.5).float().numpy()  # scaled in q's dtype, as the kernels do
    for sid, (k, v) in seqs.items():
        qg = qs[sid].reshape(3, 3, 64)
        s = np.einsum("kgd,tkd->kgt", qg, k)
        p = np.exp(s - s.max(-1, keepdims=True))
        p /= p.sum(-1, keepdims=True)
        exp = np.einsum("kgt,tkd->kgd", p, v).reshape(9, 64)
        np.testing.assert_allclose(out[sid], exp, rtol=2e-2, atol=2e-2)

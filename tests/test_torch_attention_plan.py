"""Host-side planning of the port's stitched decode attention kernel.

The CUDA kernel runs only on the card; what decides which bytes it reads
is planned on the host (``attention_plan``) and spelled out by
``tile_ranges``, which mirrors the kernel's tile walk. These tests hold
the plan to the kernel's contract: every valid position is read exactly
once, no tile crosses a chunk, splits take whole tiles and the live ones
are a prefix, and shared memory fits H100. The kernel's arithmetic is
held against the plain version on the card, by ``chip_smoke.py``."""

import dataclasses

import numpy as np
import pytest

from repro_torch.kernels.stitched_attention import (
    MAX_THREADS, MAX_TILE_TOKENS, SMEM_LIMIT, attention_plan, smem_bytes, tile_ranges)

ATTN_CASES = [
    # (B, H, KVH, D, chunk_tokens, n_chunks), as tests/test_torch_kernels.py
    (1, 8, 8, 64, 16, 2),
    (4, 16, 4, 64, 32, 3),
    (2, 12, 1, 128, 16, 4),
    (3, 9, 3, 64, 8, 5),
]
GEOMETRIES = ATTN_CASES + [
    (8, 9, 3, 64, 5461, 1),  # smollm-135m, the lake phase: one chunk per sequence
    (8, 9, 3, 64, 5461, 3),  # smollm-135m, 16383-token sequences
    (64, 9, 3, 64, 5461, 3),  # smollm-135m, ragged batch of 64
    (4, 3, 1, 32, 32768, 2),  # the engine's smoke geometry
]
ITEMSIZE = {"float32": 4, "bfloat16": 2}


def _lengths(tile, chunk_tokens, n_chunks):
    cap = chunk_tokens * n_chunks
    picks = {0, 1, tile - 1, tile, tile + 1, chunk_tokens - 1, chunk_tokens, chunk_tokens + 1,
             cap - 1, cap}
    return sorted(n for n in picks if 0 <= n <= cap)


@pytest.mark.parametrize("chunk_tokens", [8, 16, 32, 5461, 32768])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_tiles_cover_each_valid_position_once(chunk_tokens, dtype):
    n_chunks = 3
    plan = attention_plan(8, 9, 3, 64, chunk_tokens, n_chunks, ITEMSIZE[dtype])
    assert 1 <= plan.tile_tokens <= min(MAX_TILE_TOKENS, chunk_tokens)
    for seq_len in _lengths(plan.tile_tokens, chunk_tokens, n_chunks):
        seen = np.zeros(chunk_tokens * n_chunks, np.int64)
        per_split = {}
        for split, c, t0, n in tile_ranges(plan, chunk_tokens, seq_len):
            assert 1 <= n <= plan.tile_tokens
            assert t0 + n <= chunk_tokens, "a tile crosses a chunk boundary"
            assert 0 <= split < plan.splits
            seen[c * chunk_tokens + t0: c * chunk_tokens + t0 + n] += 1
            per_split[split] = per_split.get(split, 0) + 1
        assert (seen[:seq_len] == 1).all(), seq_len
        assert not seen[seq_len:].any(), seq_len
        assert all(n <= plan.tiles_per_split for n in per_split.values())
        assert sorted(per_split) == list(range(len(per_split))), "live splits are a prefix"


@pytest.mark.parametrize("geometry", GEOMETRIES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plan_fits_the_card(geometry, dtype):
    B, H, KVH, D, Tc, C = geometry
    plan = attention_plan(B, H, KVH, D, Tc, C, ITEMSIZE[dtype])
    group = H // KVH
    assert KVH % plan.kv_per_block == 0
    assert plan.smem_bytes == smem_bytes(plan.kv_per_block, group, D, ITEMSIZE[dtype],
                                         plan.tile_tokens, plan.splits, plan.phases)
    assert plan.smem_bytes <= SMEM_LIMIT
    assert plan.threads % 32 == 0 and plan.threads <= MAX_THREADS
    # every (kv head, head chunk, four dims) unit has a thread in every phase
    units = plan.kv_per_block * -(-group // plan.head_chunk) * D // 4
    assert units * plan.phases <= plan.threads
    # and a thread for every 16-byte column of a tile row in the copy loop
    assert plan.kv_per_block * D * ITEMSIZE[dtype] <= 16 * plan.threads
    assert plan.splits * plan.tiles_per_split >= C * plan.tiles_per_chunk
    assert (plan.splits - 1) * plan.tiles_per_split < C * plan.tiles_per_chunk


def test_smollm_plan():
    """smollm-135m in bf16: all three kv heads per block (a tile is one
    contiguous run), two blocks' worth of shared memory per SM, the lake's
    short sequences in one split (output written directly, no merge) and
    the long shape spread over one wave of two blocks on each of 132 SMs."""
    lake = attention_plan(8, 9, 3, 64, 5461, 1, 2)
    assert lake.kv_per_block == 3 and 2 * lake.smem_bytes <= 228 * 1024
    assert {s for s, *_ in tile_ranges(lake, 5461, 44)} == {0}
    long = attention_plan(8, 9, 3, 64, 5461, 3, 2)
    assert 132 <= 8 * long.splits <= 2 * 132
    assert {s for s, *_ in tile_ranges(long, 5461, 16383)} == set(range(long.splits))


def test_plan_refuses_what_the_kernel_cannot_take():
    with pytest.raises(ValueError):
        attention_plan(1, 8, 3, 64, 16, 1, 4)  # H % KVH
    with pytest.raises(ValueError):
        attention_plan(1, 8, 8, 36, 16, 1, 4)  # D not a multiple of 8
    with pytest.raises(ValueError):
        attention_plan(1, 8, 8, 264, 16, 1, 4)  # D over 256


@pytest.mark.parametrize("case", ATTN_CASES + [(3, 9, 3, 64, 37, 4)])
def test_small_splits_cover_each_valid_position_once(case):
    """The tile walk with a split size given explicitly (one to three tiles),
    so that most sequences run several splits: each split takes whole
    consecutive tiles, the live splits are the first ceil(tiles / split
    size), as the kernel counts them, and every valid position is read once."""
    B, H, KVH, D, Tc, C = case
    base = attention_plan(B, H, KVH, D, Tc, C, 4)
    capacity = C * base.tiles_per_chunk
    for per_split in (1, 2, 3):
        plan = dataclasses.replace(base, tiles_per_split=per_split,
                                   splits=-(-capacity // per_split))
        for seq_len in _lengths(plan.tile_tokens, Tc, C):
            seen = np.zeros(Tc * C, np.int64)
            walk = list(tile_ranges(plan, Tc, seq_len))
            for j, (split, c, t0, n) in enumerate(walk):
                assert split == j // per_split < plan.splits
                chunk, r = divmod(j, plan.tiles_per_chunk)
                assert (c, t0) == (chunk, r * plan.tile_tokens)
                assert 1 <= n and t0 + n <= Tc
                seen[c * Tc + t0: c * Tc + t0 + n] += 1
            assert (seen[:seq_len] == 1).all() and not seen[seq_len:].any(), seq_len
            assert len({w[0] for w in walk}) == -(-len(walk) // per_split)


@pytest.mark.parametrize("case", ATTN_CASES + [(3, 9, 3, 64, 37, 4), (64, 48, 4, 128, 1536, 1)])
@pytest.mark.parametrize("window", [1, 5, 32, 100, 4096])
def test_window_skips_the_tiles_before_it(case, window):
    """With a window the walk starts at the tile holding position ``len -
    window``: every tile wholly before it is skipped, the tiles from it on
    are read once each, the split indices count from it as a prefix of at
    most ``splits`` (one to three tiles a split, and the plan's own), and
    only the first tile reads positions before the window, fewer than a
    tile's worth (the kernel masks them)."""
    B, H, KVH, D, Tc, C = case
    base = attention_plan(B, H, KVH, D, Tc, C, 2)
    capacity = C * base.tiles_per_chunk
    plans = [base] + [dataclasses.replace(base, tiles_per_split=n, splits=-(-capacity // n))
                      for n in (1, 2, 3)]
    for plan in plans:
        for seq_len in _lengths(plan.tile_tokens, Tc, C) + [window, window + 1]:
            if not 0 <= seq_len <= Tc * C:
                continue
            lo = max(0, seq_len - window)
            full = list(tile_ranges(plan, Tc, seq_len))
            walk = list(tile_ranges(plan, Tc, seq_len, window))
            # the windowed walk is the tail of the whole walk from the tile
            # holding lo, with split indices counted from there
            kept = [t for t in full if t[1] * Tc + t[2] + t[3] > lo]
            assert [t[1:] for t in walk] == [t[1:] for t in kept], (seq_len, window)
            assert [s for s, *_ in walk] == [j // plan.tiles_per_split
                                             for j in range(len(walk))]
            assert all(s < plan.splits for s, *_ in walk)
            seen = np.zeros(Tc * C, np.int64)
            for _, c, t0, n in walk:
                seen[c * Tc + t0: c * Tc + t0 + n] += 1
            assert (seen[lo:seq_len] == 1).all() and not seen[seq_len:].any()
            if walk:
                first = walk[0][1] * Tc + walk[0][2]
                assert first <= lo < first + walk[0][3]
                assert not seen[:first].any() and lo - first < plan.tile_tokens
            else:
                assert seq_len == 0

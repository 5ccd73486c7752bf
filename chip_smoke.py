#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one CUDA card and check it.

    python3 chip_smoke.py

Needs one CUDA card, ``nvcc`` and the repository checkout (it imports
``src/repro_torch``); imports nothing of JAX or of the JAX package. Phases:

1. print the card's name and power limit; build every kernel from
   ``src/repro_torch/csrc`` (one ``nvcc`` per source, all at once);
2. hold each CUDA kernel against its plain PyTorch version on the card:
   gather/scatter bit-exact, decode attention within 2e-5 (f32) / 2e-2
   (bf16) of each output row's largest value (see ``attn_close``), at the
   shapes of ``tests/test_kernels.py`` and at real 2 MiB chunks, including
   smollm-135m's KV geometry (T_c = 5461), lengths at the edges of the
   kernel's tiles and chunks, an arena that is not 16-byte aligned, 50
   CUDA-graph replays of one call whose splits merge in the kernel, with
   new lengths before each replay, and replays of a graph captured before
   a larger call grew the kernel's workspace;
3. serve smollm-135m at full width through ``repro_torch.launch.serve``;
4. the lake: write a mid-run engine's dense K/V into its own stitched KV
   cache, compare stitched decode attention (the kernel) with the dense
   path for every layer, and round-trip the embedding table bit-exact
   through an arena fragmented by alloc/free churn; launch counts are
   zeroed before phase 3 and must all be > 0 after phase 4;
5. at the shapes phase 4 used, hold each kernel against its plain version
   once more (same tolerances) and time the kernel, its plain version and
   the one-call PyTorch yardstick as device time (calls captured in a CUDA
   graph, replayed between CUDA events), the kernel's wrapper also per call
   with host work included (``call_ms``), and compute its bound; time
   decode attention also at long (16383-token) and ragged (64 sequences of
   1..16383 tokens) smollm-135m shapes, and an empty kernel in the same
   graph harness as the practical floor of one launch;
6. the training path, with launch counts zeroed before it and read after:
   (a) the smoke config trained 10 steps on the card and on the CPU from
   the same seed and batches, in float32 (each loss within
   ``TRAIN_LOSS_RTOL``) and in bf16 with remat on, the full config's
   working types (within ``TRAIN_LOSS_RTOL_BF16``);
   (b) smollm-135m at full width (bf16, remat on, batch 8, seq 256) for 20
   steps through ``repro_torch.launch.train`` and its ``Supervisor``,
   checkpointing every 10 steps into a temporary directory, with one
   ``RuntimeError`` injected at step 15: exactly that one restart (and no
   other event but logged stragglers), the restored step-10 state equal
   bit for bit to the state saved, all 20 steps in the history, every loss
   finite and the last below the first; then 2 more steps to warm up, 5
   timed and 5 profiled by ``measure`` of ``scripts/profile_train.py`` (ms/step,
   tokens/s, peak memory allocated and reserved, device idle share,
   kernels per step); (c) the trained f32 first moments through
   ``OffloadManager`` on an f32 arena on the card (put, spill, fetch, get),
   bit-exact, every gather and scatter of it equal bit for bit to its plain
   version at the path's own chunk maps, and the arena empty after
   ``drop``.

Prints an ``{"attention_shapes": [...]}`` line, a ``{"training": {...}}``
line and a ``{"kernels": [...]}`` line (``launches`` is each kernel's count
on the serving path, phases 3-4, whose shapes phase 5 times;
``launches_by_path`` has it beside the training path's, phase 6), then the
``nvidia-smi`` line, and as the last line ``{"ok": true, "device":
{...}}``. Any failed check raises, so the script exits non-zero and
prints no result.
"""

from __future__ import annotations

import json
import math
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

DEVICE = "cuda"
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
BF16_FLOPS_PER_S = 989e12  # H100 SXM dense bf16 tensor-core peak
F32_TOL, BF16_TOL = 2e-5, 2e-2  # attention tolerances, as tests/test_kernels.py
ATTN_CASES = [
    # (B, H, KVH, D, chunk_tokens, n_chunks, n_phys), as tests/test_kernels.py
    (1, 8, 8, 64, 16, 2, 4),
    (4, 16, 4, 64, 32, 3, 12),
    (2, 12, 1, 128, 16, 4, 8),
    (3, 9, 3, 64, 8, 5, 16),
]
GATHER_SHAPES = [(8, 256, 3), (32, 512, 32), (4, 128, 1), (64, 1024, 17)]
SCATTER_SHAPES = [(8, 256, 3), (16, 512, 16)]
REAL_CHUNK = (256, 1 << 20, 64)  # 2 MiB bf16 chunks: n_phys, chunk_elems, n_logical
SERVE_ARGS = ["--arch", "smollm-135m", "--requests", "16", "--max-new", "16",
              "--max-batch", "8", "--seed", "0", "--device", "cuda"]
LAKE_STEPS = 4
GRAPH_REPLAYS = 50
TRAIN_ARGS = ["--arch", "smollm-135m", "--steps", "20", "--batch", "8", "--seq", "256",
              "--ckpt-every", "10", "--seed", "0", "--device", "cuda"]
TRAIN_FAIL_STEP = 15
TRAIN_LOSS_RTOL = 1e-4  # card vs CPU, f32 smoke config (no TF32)
TRAIN_LOSS_RTOL_BF16 = 2.0**-8  # card vs CPU, bf16 smoke config: one bf16 rounding
PARITY_STEPS = 10


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip()


def rand(rng: np.random.Generator, shape, dtype: torch.dtype) -> torch.Tensor:
    """Random data made on the card by a generator seeded from ``rng``."""
    g = torch.Generator(device=DEVICE).manual_seed(int(rng.integers(2**31)))
    if dtype == torch.int32:
        return torch.randint(-8, 8, shape, generator=g, device=DEVICE, dtype=dtype)
    return torch.randn(shape, generator=g, device=DEVICE).to(dtype)


def ints(x) -> torch.Tensor:
    """Host integers as an int32 tensor on the card."""
    return torch.as_tensor(np.asarray(x, np.int32), device=DEVICE)


def max_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.double() - b.double()).abs().max()) if a.numel() else 0.0


#: the largest share of its limit that any attention check has used
attn_share = 0.0


def attn_close(got: torch.Tensor, want: torch.Tensor, what) -> float:
    """Hold decode attention's (B, H, D) output to its plain version.

    Each element must be within ``tol`` of its (sequence, head) row's
    largest |value| (so a row of zeros must be zeros), and within
    ``tol * (1 + |value|)`` as ``torch.testing.assert_close`` counts it.
    Outputs shrink as 1/sqrt(tokens), so an absolute 2e-2 alone would pass
    a kernel that drops a tile of a 5461-token chunk. Returns the max abs
    error and records the worst share of the limit in ``attn_share``."""
    global attn_share
    tol = F32_TOL if got.dtype == torch.float32 else BF16_TOL
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol, msg=str(what))
    err = (got.double() - want.double()).abs()
    limit = tol * want.double().abs().amax(-1, keepdim=True)
    assert not bool((err > limit).any()), (what, float((err - limit).max()))
    if err.numel():
        attn_share = max(attn_share, float((err / limit).nan_to_num(0.0).max()))
    return max_err(got, want)


def call_ms(fn, iters: int = 20, reps: int = 7) -> float:
    """Time per call as a caller sees it, host work included: median over
    ``reps`` of ``iters`` back-to-back calls between CUDA events."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    samples = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        samples.append(start.elapsed_time(end) / iters)
    return statistics.median(samples)


def time_ms(fn, iters: int = 20, reps: int = 7) -> float:
    """Device time per call: ``iters`` calls captured in one CUDA graph, so
    no host work sits between the kernels, and the median over ``reps``
    replays between CUDA events."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm up off the default stream, as capture needs
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    samples = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        samples.append(start.elapsed_time(end) / iters)
    return statistics.median(samples)


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------


def check_copy_kernels(rng) -> None:
    from repro_torch.kernels import ref
    from repro_torch.kernels.stitch_copy import stitch_gather, stitch_scatter

    cases = [(s, d) for s in GATHER_SHAPES for d in (torch.float32, torch.bfloat16, torch.int32)]
    cases.append((REAL_CHUNK, torch.bfloat16))
    for (n_phys, elems, n_logical), dtype in cases:
        arena = rand(rng, (n_phys, elems), dtype)
        cmap = ints(rng.permutation(n_phys)[:n_logical])
        got = stitch_gather(arena, cmap)
        assert torch.equal(got, ref.stitch_gather_ref(arena, cmap)), ("gather", n_phys, dtype)
    cases = [(s, d) for s in SCATTER_SHAPES for d in (torch.float32, torch.bfloat16)]
    cases.append((REAL_CHUNK, torch.bfloat16))
    for (n_phys, elems, n_logical), dtype in cases:
        arena = rand(rng, (n_phys, elems), dtype)
        cmap = ints(rng.permutation(n_phys)[:n_logical])
        vals = rand(rng, (n_logical, elems), dtype)
        got = stitch_scatter(arena.clone(), cmap, vals)
        want = ref.stitch_scatter_ref(arena.clone(), cmap, vals)
        assert torch.equal(got, want), ("scatter", n_phys, dtype)
    # scatter(gather(x)) through a permutation is the identity
    arena = rand(rng, (16, 256), torch.float32)
    perm = ints(rng.permutation(16))
    back = stitch_scatter(torch.zeros_like(arena), perm, stitch_gather(arena, perm))
    assert torch.equal(back, arena)
    torch.cuda.synchronize()
    log(f"phase 2: gather/scatter bit-exact on {len(GATHER_SHAPES) * 3 + 1} gather and "
        f"{len(SCATTER_SHAPES) * 2 + 1} scatter cases, incl. 2 MiB chunks")


def _attn_check(rng, B, H, KVH, D, Tc, C, NP, dtype, seq_lens=None, separate_v=False,
                chunk_elems=None):
    """One kernel-vs-plain comparison; returns the max abs error."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.stitched_attention import stitched_decode_attention

    used = Tc * KVH * D
    buf = rand(rng, (NP, chunk_elems or used), dtype)
    buf_v = rand(rng, (NP, chunk_elems or used), dtype)
    ka = buf[:, :used].unflatten(1, (Tc, KVH, D))
    va = buf_v[:, :used].unflatten(1, (Tc, KVH, D))
    q = rand(rng, (B, H, D), dtype)
    pt = ints(rng.integers(0, NP, size=(B, C)))
    ptv = ints(rng.integers(0, NP, size=(B, C)))
    if seq_lens is None:
        seq_lens = rng.integers(1, C * Tc + 1, size=B)
    sl = ints(seq_lens)
    if separate_v:
        got = stitched_decode_attention(q, ka, ka, pt, sl, page_table_v=ptv)
        want = ref.stitched_decode_attention_ref(q, ka, ka, pt, sl, ptv)
    else:
        got = stitched_decode_attention(q, ka, va, pt, sl)
        want = ref.stitched_decode_attention_ref(q, ka, va, pt, sl)
    return attn_close(got, want, (B, H, KVH, D, Tc, C, dtype, seq_lens))


def check_attention_kernel(rng) -> None:
    from repro_torch.kernels.stitched_attention import attention_plan

    f32, bf16 = torch.float32, torch.bfloat16
    n = 0
    for case in ATTN_CASES:
        for dtype in (f32, bf16):
            _attn_check(rng, *case, dtype)
            n += 1
    _attn_check(rng, 2, 8, 4, 64, 16, 3, 12, f32, seq_lens=[20, 48], separate_v=True)
    _attn_check(rng, 2, 4, 2, 64, 32, 4, 8, f32, seq_lens=[1, 7])  # padding chunks add nothing
    _attn_check(rng, 3, 9, 3, 64, 8, 5, 16, f32, seq_lens=[0, 5, 40])  # seq_len 0 -> zeros
    # smollm-135m full KV geometry: strided view of 2 MiB bf16 chunks, T_c = 5461,
    # sequence lengths crossing chunk boundaries, K and V under separate tables
    lens = [1, 100, 5461, 5462, 8000, 10922, 12000, 16383]
    err_full = _attn_check(rng, 8, 9, 3, 64, 5461, 3, 32, bf16, seq_lens=lens,
                           separate_v=True, chunk_elems=1 << 20)
    # the engine's smoke geometry: KVH=1, D=32, T_c = 32768 tokens per chunk
    err_smoke = _attn_check(rng, 4, 3, 1, 32, 32768, 2, 8, bf16,
                            seq_lens=[1, 32767, 32769, 65536], chunk_elems=1 << 20)
    # lengths at the edges of the kernel's tiles and of the chunks, in both geometries
    err_edges = 0.0
    for B, H, KVH, D, Tc, C, NP in ((6, 9, 3, 64, 5461, 3, 32), (6, 3, 1, 32, 32768, 2, 8)):
        tt = attention_plan(B, H, KVH, D, Tc, C, 2).tile_tokens
        err_edges = max(err_edges, _attn_check(
            rng, B, H, KVH, D, Tc, C, NP, bf16, seq_lens=[tt - 1, tt, tt + 1, Tc - 1, Tc, Tc + 1],
            separate_v=True, chunk_elems=1 << 20))
    # chunk strides that are not a multiple of 16 bytes: plain loads fill the ring
    _attn_check(rng, 3, 9, 3, 64, 40, 3, 8, f32, seq_lens=[0, 39, 120],
                chunk_elems=40 * 3 * 64 + 17)
    _attn_check(rng, 3, 9, 3, 64, 40, 3, 8, bf16, chunk_elems=40 * 3 * 64 + 3)
    err_graph = check_graph_replays(rng)
    err_grown = check_graph_after_growth(rng)
    torch.cuda.synchronize()
    log(f"phase 2: decode attention within tolerance on {n} ATTN_CASES runs + separate-KV, "
        f"short, empty, smollm-full (max err {err_full:.3g}), engine-smoke "
        f"(max err {err_smoke:.3g}), tile/chunk-edge lengths (max err {err_edges:.3g}), "
        f"unaligned arenas, {GRAPH_REPLAYS} graph replays (max err {err_graph:.3g}) and "
        f"replays after the workspace grew (max err {err_grown:.3g}); worst share of the "
        f"row-scaled limit {attn_share:.4g}")


def check_graph_replays(rng) -> float:
    """One call captured in a CUDA graph, at smollm-135m's full KV geometry
    where the splits merge through the kernel's tickets; new lengths (0
    included) go into the captured ``seq_lens`` before each replay, and
    every replay must equal the plain version. Returns the max abs error."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.stitched_attention import stitched_decode_attention

    B, H, KVH, D, Tc, C, NP = 8, 9, 3, 64, 5461, 3, 32
    buf = rand(rng, (NP, 1 << 20), torch.bfloat16)
    view = buf[:, :Tc * KVH * D].unflatten(1, (Tc, KVH, D))
    q = rand(rng, (B, H, D), torch.bfloat16)
    pt = ints(rng.integers(0, NP, size=(B, C)))
    ptv = ints(rng.integers(0, NP, size=(B, C)))
    sl = ints(rng.integers(1, C * Tc + 1, size=B))

    def call():
        return stitched_decode_attention(q, view, view, pt, sl, page_table_v=ptv)

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        call()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = call()
    err = 0.0
    for i in range(GRAPH_REPLAYS):
        sl.copy_(ints(rng.integers(0, C * Tc + 1, size=B)))
        graph.replay()
        want = ref.stitched_decode_attention_ref(q, view, view, pt, sl, ptv)
        err = max(err, attn_close(out, want, ("graph replay", i)))
    return err


def check_graph_after_growth(rng) -> float:
    """A call captured in a CUDA graph keeps the workspace it was captured
    with: capture a small merging call, make an eager call large enough to
    grow the workspace, take memory of the old workspace's sizes (a freed
    old workspace would be handed out here) and fill it, then replay. The
    replays must equal the plain version and leave that memory alone.
    Returns the max abs error."""
    from repro_torch.kernels import ref
    from repro_torch.kernels import stitched_attention as sa

    H, KVH, D, Tc, C, NP = 9, 3, 64, 5461, 3, 32
    buf = rand(rng, (NP, 1 << 20), torch.bfloat16)
    view = buf[:, :Tc * KVH * D].unflatten(1, (Tc, KVH, D))

    def inputs(B):
        q = rand(rng, (B, H, D), torch.bfloat16)
        return q, ints(rng.integers(0, NP, size=(B, C))), ints([C * Tc] * B)

    q, pt, sl = inputs(2)
    sa.stitched_decode_attention(q, view, view, pt, sl)  # eager: workspace for this geometry
    torch.cuda.synchronize()
    held = sa._workspace[q.device]
    n_held = len(held)
    old_tickets, old_partials = held[-1]
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = sa.stitched_decode_attention(q, view, view, pt, sl)
    # one more call than the workspace holds: each full sequence takes
    # splits x H x (D + 2) floats of partials
    plan = sa.attention_plan(2, H, KVH, D, Tc, C, 2)
    big_b = old_partials.numel() // (plan.splits * H * (D + 2)) + 1
    q_big, pt_big, sl_big = inputs(big_b)
    sa.stitched_decode_attention(q_big, view, view, pt_big, sl_big)
    assert len(held) == n_held + 1, "the large call did not grow the workspace"
    fill_t = torch.full_like(old_tickets, 7)
    fill_p = torch.full_like(old_partials, 7.0)
    err = 0.0
    for i in range(5):
        sl.copy_(ints(rng.integers(C * Tc // 2, C * Tc + 1, size=2)))
        graph.replay()
        want = ref.stitched_decode_attention_ref(q, view, view, pt, sl)
        err = max(err, attn_close(out, want, ("replay after growth", i)))
    assert bool((fill_t == 7).all()) and bool((fill_p == 7.0).all()), "a replay wrote freed memory"
    return err


# ---------------------------------------------------------------------------
# phases 3 and 4: serve, then the lake
# ---------------------------------------------------------------------------


def serve() -> dict:
    from repro_torch.launch import serve as serve_cli

    out = serve_cli.main(SERVE_ARGS)
    assert out["finished"] == out["requests"], out
    log(f"phase 3: served {out['finished']}/{out['requests']} requests in "
        f"{out['decode_steps']} decode steps, {out['tokens_per_s']} tokens/s "
        f"(host clock, synchronised)")
    return out


def lake(rng) -> dict:
    """Check the stitched data path against the engine's dense path; return
    the inputs phase 5 times the kernels on."""
    from repro_torch.alloc import CHUNK_SIZE
    from repro_torch.core.arena import Arena, ArenaConfig
    from repro_torch.launch import serve as serve_cli
    from repro_torch.models.layers import decode_attention_dense

    eng = serve_cli.build_engine(serve_cli.parse_args(SERVE_ARGS))
    for _ in range(LAKE_STEPS):
        eng.step()
    cfg, kv, cache = eng.cfg, eng.kv, eng._cache
    rids = list(eng.running)
    slots = [eng._slot_of[r] for r in rids]
    lens = [kv.seqs[r].length for r in rids]
    assert lens == cache["length"][slots].tolist(), (lens, cache["length"])
    assert len(rids) == 8, rids
    for layer in range(cfg.n_layers):
        for rid, slot, n in zip(rids, slots, lens):
            kv.write_tokens(rid, layer, "k", 0, cache["k"][layer, slot, :n])
            kv.write_tokens(rid, layer, "v", 0, cache["v"][layer, slot, :n])
    q = rand(rng, (len(rids), cfg.n_heads, cfg.dh), cfg.dtype)
    lens_t = ints(lens)
    err = 0.0
    for layer in range(cfg.n_layers):
        got = kv.decode_attention(rids, layer, q)
        want = decode_attention_dense(q[:, None], cache["k"][layer, slots],
                                      cache["v"][layer, slots], lens_t)[:, 0]
        torch.testing.assert_close(got.float(), want.float(), rtol=BF16_TOL, atol=BF16_TOL)
        err = max(err, max_err(got, want))
    log(f"phase 4: stitched attention == dense attention on {cfg.n_layers} layers x "
        f"{len(rids)} sequences (lens {lens}, chunk_tokens {kv.config.chunk_tokens}), "
        f"max abs err {err:.3g}")

    # the embedding table through an arena fragmented by alloc/free churn
    arena = Arena(ArenaConfig(n_chunks=64, dtype=cfg.dtype, device=DEVICE))
    churn = [arena.alloc_elems(2 * CHUNK_SIZE // cfg.dtype.itemsize) for _ in range(32)]
    for a in churn[::2]:
        arena.free(a)
    emb = eng.params["embed"]
    alloc = arena.alloc_elems(emb.numel())
    extents = alloc.block.extents
    assert len(extents) > 1, extents
    arena.store(alloc, emb)
    assert torch.equal(arena.load(alloc, tuple(emb.shape)), emb)
    log(f"phase 4: {emb.numel() * emb.element_size() / 1e6:.1f} MB embedding table "
        f"round-tripped bit-exact through {len(extents)} stitched extents")

    ptk, sl = kv.page_table(rids, 0, "k")
    ptv, _ = kv.page_table(rids, 0, "v", pad_chunks=ptk.shape[1])
    return dict(arena=arena.buf, cmap=arena.chunk_map(alloc), q=q, view=kv.arena_view(),
                ptk=ptk, ptv=ptv, sl=sl, lens=lens)


# ---------------------------------------------------------------------------
# phase 5: times
# ---------------------------------------------------------------------------


def timings(inp: dict, counts: dict) -> list:
    from repro_torch.kernels import ref
    from repro_torch.kernels.stitch_copy import stitch_gather, stitch_scatter
    from repro_torch.kernels.stitched_attention import stitched_decode_attention

    arena, cmap = inp["arena"], inp["cmap"]
    cmap_long = cmap.long()
    copy_bytes = 2 * cmap.numel() * arena.shape[1] * arena.element_size() + cmap.numel() * 4
    values = stitch_gather(arena, cmap)
    rows = []

    gather_err = max_err(stitch_gather(arena, cmap), ref.stitch_gather_ref(arena, cmap))
    assert gather_err == 0.0, gather_err
    rows.append(dict(
        name="stitch_gather", route="cuda", source="src/repro_torch/csrc/stitch_copy.cu",
        replaces="src/repro/kernels/stitch_copy.py:38",
        launches=counts["stitch_gather"], max_abs_err=gather_err,
        ms=time_ms(lambda: stitch_gather(arena, cmap)),
        call_ms=call_ms(lambda: stitch_gather(arena, cmap)),
        plain_ms=time_ms(lambda: ref.stitch_gather_ref(arena, cmap)),
        bound_ms=copy_bytes / HBM_BYTES_PER_S * 1e3, bound_by="bytes",
        library_ms=time_ms(lambda: torch.index_select(arena, 0, cmap_long)),
    ))

    a1, a2 = arena.clone(), arena.clone()
    scatter_err = max_err(stitch_scatter(a1, cmap, values),
                          ref.stitch_scatter_ref(a2, cmap, values))
    assert scatter_err == 0.0 and torch.equal(a1, a2), scatter_err
    del a1, a2
    rows.append(dict(
        name="stitch_scatter", route="cuda", source="src/repro_torch/csrc/stitch_copy.cu",
        replaces="src/repro/kernels/stitch_copy.py:65",
        launches=counts["stitch_scatter"], max_abs_err=scatter_err,
        ms=time_ms(lambda: stitch_scatter(arena, cmap, values)),
        call_ms=call_ms(lambda: stitch_scatter(arena, cmap, values)),
        plain_ms=time_ms(lambda: ref.stitch_scatter_ref(arena, cmap, values)),
        bound_ms=copy_bytes / HBM_BYTES_PER_S * 1e3, bound_by="bytes",
        library_ms=time_ms(lambda: arena.index_copy_(0, cmap_long, values)),
    ))

    q, view, ptk, ptv, sl = inp["q"], inp["view"], inp["ptk"], inp["ptv"], inp["sl"]
    b, h, d = q.shape
    n_kv = view.shape[2]
    tokens = sum(inp["lens"])
    attn_bytes = (2 * tokens * n_kv * d * view.element_size() + 2 * q.numel() * q.element_size()
                  + 2 * ptk.numel() * 4 + sl.numel() * 4)
    attn_flops = 4 * tokens * h * d
    bytes_ms = attn_bytes / HBM_BYTES_PER_S * 1e3
    flops_ms = attn_flops / BF16_FLOPS_PER_S * 1e3

    def kernel():
        return stitched_decode_attention(q, view, view, ptk, sl, page_table_v=ptv)

    def plain():
        return ref.stitched_decode_attention_ref(q, view, view, ptk, sl, ptv)

    attn_err = attn_close(kernel(), plain(), "main path")
    rows.append(dict(
        name="stitched_decode_attention", route="cuda",
        source="src/repro_torch/csrc/stitched_attention.cu",
        replaces="src/repro/kernels/stitched_attention.py:95",
        launches=counts["stitched_decode_attention"], max_abs_err=attn_err,
        ms=time_ms(kernel), call_ms=call_ms(kernel), plain_ms=time_ms(plain),
        bound_ms=max(bytes_ms, flops_ms), bound_by="bytes" if bytes_ms >= flops_ms else "operations",
        library_ms=None,
    ))
    return rows


def attention_shapes(rng) -> list:
    """Decode attention beyond the main path's shape, in smollm-135m's KV
    geometry (bf16, T_c = 5461, strided views of 2 MiB chunks): ``long``,
    8 sequences of 16383 tokens over 3 chunks, K and V in one buffer under
    one table; ``ragged``, 64 sequences of 1..16383 tokens (uniform, from
    the script's seed), separate K and V buffers under one table that is a
    permutation of 192 chunks (about 400 MB of KV, far over the 50 MB L2).
    Each is checked against the plain version once, then timed."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.stitched_attention import stitched_decode_attention

    H, KVH, D, Tc, C = 9, 3, 64, 5461, 3
    used = Tc * KVH * D
    rows = []
    for name, B, NP in (("long", 8, 32), ("ragged", 64, 192)):
        k_buf = rand(rng, (NP, 1 << 20), torch.bfloat16)
        v_buf = k_buf if name == "long" else rand(rng, (NP, 1 << 20), torch.bfloat16)
        k_view = k_buf[:, :used].unflatten(1, (Tc, KVH, D))
        v_view = v_buf[:, :used].unflatten(1, (Tc, KVH, D))
        q = rand(rng, (B, H, D), torch.bfloat16)
        if name == "long":
            pt = ints(np.stack([rng.permutation(NP)[:C] for _ in range(B)]))
            lens = [C * Tc] * B
        else:
            pt = ints(rng.permutation(NP).reshape(B, C))
            lens = rng.integers(1, C * Tc + 1, size=B).tolist()
        sl = ints(lens)

        def kernel():
            return stitched_decode_attention(q, k_view, v_view, pt, sl)

        def plain():
            return ref.stitched_decode_attention_ref(q, k_view, v_view, pt, sl)

        err = attn_close(kernel(), plain(), name)
        nbytes = (2 * sum(lens) * KVH * D * 2 + 2 * q.numel() * 2 + pt.numel() * 4
                  + sl.numel() * 4)
        rows.append(dict(shape=name, B=B, tokens=sum(lens), max_abs_err=err,
                         ms=time_ms(kernel), plain_ms=time_ms(plain, iters=3),
                         bound_ms=nbytes / HBM_BYTES_PER_S * 1e3, bound_by="bytes"))
        del k_buf, v_buf, k_view, v_view
    return rows


# ---------------------------------------------------------------------------
# phase 6: the training path
# ---------------------------------------------------------------------------


def same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    view = {2: torch.int16, 4: torch.int32, 8: torch.int64}[a.element_size()]
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(a.view(view), b.view(view))


def train_parity() -> dict:
    """6a: the smoke config's loss curve on the card against the CPU port's
    (the CPU tests hold the CPU port against JAX), in float32 and in the
    full config's working types (bf16, remat on). Returns the largest
    relative difference of each."""
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.data.pipeline import DataConfig, SyntheticTokens
    from repro_torch.train import optimizer as opt
    from repro_torch.train.step import init_state, make_train_step

    smoke = get_arch("smollm-135m").smoke
    adamw = opt.AdamWConfig()
    rels = {}
    for name, cfg, rtol in (
            ("float32", smoke, TRAIN_LOSS_RTOL),
            ("bfloat16", dataclasses.replace(smoke, dtype=torch.bfloat16, remat=True),
             TRAIN_LOSS_RTOL_BF16)):
        curves = {}
        for dev in ("cpu", DEVICE):
            state = init_state(cfg, adamw, torch.Generator().manual_seed(0), dev)
            step = make_train_step(cfg, adamw)
            data = SyntheticTokens(DataConfig(vocab=cfg.vocab, seq_len=64, global_batch=4), dev)
            curves[dev] = []
            for i in range(PARITY_STEPS):
                state, m = step(state, data.batch_at(i))
                curves[dev].append(float(m["loss"]))
        cpu, card = np.array(curves["cpu"]), np.array(curves[DEVICE])
        rels[name] = rel = float(np.max(np.abs(card - cpu) / np.abs(cpu)))
        assert rel <= rtol, (name, curves, rel)
        log(f"phase 6a: {name} smoke-config loss on the card matches the CPU port over "
            f"{PARITY_STEPS} steps ({card[0]:.6f} -> {card[-1]:.6f}), max relative "
            f"difference {rel:.3g} (limit {rtol:.3g})")
    return rels


def supervised_training(workdir: Path, card: str):
    """6b: full-width smollm-135m through the launcher and its supervisor,
    one fault injected, then timed in steady state; returns (result, final
    state, timing)."""
    from repro_torch.ckpt.checkpoint import CheckpointManager
    from repro_torch.configs import get_arch
    from repro_torch.data.pipeline import DataConfig, SyntheticTokens
    from repro_torch.launch import train
    from repro_torch.train import optimizer as opt
    from repro_torch.train.step import make_train_step
    from repro_torch.tree import flatten_with_path

    sys.path.insert(0, str(ROOT / "scripts"))
    from profile_train import measure

    args = train.parse_args(TRAIN_ARGS)
    entry = get_arch(args.arch)
    cfg = entry.smoke if args.smoke else entry.full
    watch = args.ckpt_every

    class Checked(CheckpointManager):
        """Keeps a copy, on the card, of the state saved at step ``watch``
        and holds every restore to it bit for bit."""

        def __init__(self, directory, keep):
            super().__init__(directory, keep=keep)
            self.saved, self.restored, self.saves = None, [], []

        def save_async(self, step, tree):
            self.saves.append(step)
            if step == watch:
                self.saved = [(p, t.clone()) for p, t in flatten_with_path(tree)]
            super().save_async(step, tree)

        def save(self, step, tree):
            self.saves.append(step)
            return super().save(step, tree)

        def restore(self, like, step=None, device=None):
            out = super().restore(like, step, device)
            for (path, want), (_, got) in zip(self.saved, flatten_with_path(out), strict=True):
                assert got.device == want.device and same_bits(got, want), path
            self.restored.append(step)
            return out

    pending = {TRAIN_FAIL_STEP}

    def inject(step):
        if step in pending:
            pending.discard(step)
            raise RuntimeError(f"injected failure at step {step}")

    ckpt = Checked(workdir, keep=2)
    free_gb = shutil.disk_usage(workdir).free / 1e9
    result, state = train.run(args, fail_injector=inject, ckpt=ckpt)
    # exactly one restart, the injected one: any other would be a fault the
    # supervisor recovered from silently. Stragglers are only logged (the
    # "log" policy): a step 3x the median on a shared host is not a fault.
    events = [e for e in result["events"] if e["kind"] != "straggler"]
    stragglers = len(result["events"]) - len(events)
    assert [e["kind"] for e in events] == ["restart"], result["events"]
    assert events[0]["step"] == TRAIN_FAIL_STEP and "injected" in events[0]["error"], events
    assert ckpt.restored == [watch], ckpt.restored
    assert len(ckpt.saves) <= 3, ckpt.saves
    steps = [h["step"] for h in result["history"]]
    assert steps == list(range(args.steps)), steps
    losses = [h["loss"] for h in result["history"]]
    assert all(math.isfinite(x) for x in losses), losses
    assert result["last_loss"] < result["first_loss"], result
    assert int(state.step) == args.steps and state.params["embed"].dtype == cfg.dtype

    log(f"phase 6b: {cfg.name} ({cfg.n_layers} layers, d_model {cfg.d_model}, "
        f"{str(cfg.dtype).split('.')[-1]}, remat {cfg.remat}, batch {args.batch}, seq "
        f"{args.seq}): {result['steps']} supervised steps, events {[e['kind'] for e in events]} "
        f"at step {events[0]['step']} and {stragglers} logged stragglers, restored step {watch} bit-exact, saves at steps "
        f"{ckpt.saves}, loss {result['first_loss']:.4f} -> {result['last_loss']:.4f} "
        f"(min {result['min_loss']:.4f}), wall {result['wall_s']} s incl. checkpoints, "
        f"{result['tokens_per_s']} tokens/s over the run, peak allocated "
        f"{result['peak_allocated_bytes'] / 2**30:.3f} GiB, reserved "
        f"{result['peak_reserved_bytes'] / 2**30:.3f} GiB (with this check's copy of the "
        f"step-{watch} state); disk free before {free_gb:.1f} GB")

    # steady state, measured as scripts/profile_train.py measures it
    ckpt.saved = None
    step_fn = make_train_step(cfg, opt.AdamWConfig(lr=args.lr))
    data = SyntheticTokens(DataConfig(vocab=cfg.vocab, seq_len=args.seq,
                                      global_batch=args.batch, seed=args.seed), DEVICE)
    torch.cuda.empty_cache()
    state, timing = measure(step_fn, state, data.batch_at, args.steps)
    assert math.isfinite(timing["last_loss"]), timing
    prof = timing["profiled"]
    log(f"phase 6b: steady state on {card}, over {timing['steps']} steps: "
        f"{timing['ms_per_step']:.3f} ms/step, {timing['tokens_per_s']:.0f} tokens/s, peak "
        f"allocated {timing['peak_allocated_bytes'] / 2**30:.3f} GiB, reserved "
        f"{timing['peak_reserved_bytes'] / 2**30:.3f} GiB; under the profiler "
        f"{prof['ms_per_step']:.3f} ms/step, device busy {prof['device_busy_ms_per_step']:.3f} "
        f"ms/step, idle share {prof['device_idle_share']:.4f}, "
        f"{prof['kernels_per_step']:.0f} kernels/step")
    return result, state, timing


def offload_moments(state) -> dict:
    """6c: the trained f32 first moments through host offload on an f32
    arena on the card (put, spill, fetch, get), bit-exact, arena empty at
    the end. Every kernel launch of the path is held bit for bit to its
    plain version on the same inputs, at the path's own chunk maps: after
    each store (put, fetch) the whole arena against ``stitch_scatter_ref``
    applied to a copy of the arena from before it, and each load (spill,
    get) against ``stitch_gather_ref`` of the arena it read."""
    from repro_torch.alloc import CHUNK_SIZE
    from repro_torch.core.arena import Arena, ArenaConfig
    from repro_torch.core.offload import OffloadManager
    from repro_torch.kernels import ref
    from repro_torch.tree import flatten_with_path

    mu = dict(flatten_with_path(state.opt.mu))
    assert all(t.dtype == torch.float32 for t in mu.values())
    chunks = sum(-(-t.numel() * 4 // CHUNK_SIZE) for t in mu.values())
    arena = Arena(ArenaConfig(n_chunks=chunks + 8, dtype=torch.float32, device=DEVICE))
    ce = arena.config.chunk_elems
    om = OffloadManager(arena)

    def chunk_map(name):
        return arena.chunk_map(om._device[name].alloc)[:-(-mu[name].numel() // ce)]

    def stored(name, before):
        """The arena after storing ``mu[name]`` equals the plain scatter."""
        cmap = chunk_map(name)
        values = torch.zeros((cmap.numel(), ce), dtype=torch.float32, device=DEVICE)
        values.view(-1)[:mu[name].numel()] = mu[name].reshape(-1)
        assert same_bits(arena.buf, ref.stitch_scatter_ref(before, cmap, values)), name

    def gathered(name):
        """The plain gather of ``mu[name]`` from the arena as it stands."""
        t = mu[name]
        return ref.stitch_gather_ref(arena.buf, chunk_map(name)).reshape(-1)[:t.numel()] \
            .reshape(t.shape)

    maps = []
    for name, t in mu.items():
        before = arena.buf.clone()
        om.put(name, t)
        stored(name, before)
        maps.append(chunk_map(name).numel())
    for name in mu:
        want = gathered(name)
        om.spill(name)
        assert same_bits(om._host[name], want.cpu()), name
    assert arena.active_bytes == 0 and not any(om.is_resident(n) for n in mu)
    for name in mu:
        before = arena.buf.clone()
        om.fetch(name)
        stored(name, before)
    del before
    for name, t in mu.items():
        want = gathered(name)
        back = om.get(name)
        assert back.device == t.device and same_bits(back, want) and same_bits(back, t), name
    nbytes = sum(t.numel() * 4 for t in mu.values())
    for name in mu:
        om.drop(name)
    assert arena.active_bytes == 0 and om.names() == set()
    torch.cuda.synchronize()
    log(f"phase 6c: {len(mu)} f32 moment leaves ({nbytes / 1e6:.1f} MB, chunk maps of "
        f"{min(maps)}-{max(maps)} chunks) put, spilled, fetched and read back bit-exact "
        f"through a {chunks + 8}-chunk arena, every store and load equal bit for bit to "
        f"the plain scatter and gather; active bytes 0 after drop")
    return dict(leaves=len(mu), bytes=nbytes, chunks_per_leaf=[min(maps), max(maps)])


def train_path(card: str) -> dict:
    """Phase 6 with the launch counts zeroed before it and read after."""
    from repro_torch.kernels import ops

    torch.cuda.empty_cache()  # peaks below count from the training path's own blocks
    ops.reset_launch_counts()
    rels = train_parity()
    build_dir = ROOT / "build"
    build_dir.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build_dir, prefix="ckpt-") as workdir:
        result, state, timing = supervised_training(Path(workdir), card)
    offload = offload_moments(state)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    log(f"phase 6: kernel launches on the training path {counts}")
    assert counts["stitch_gather"] > 0 and counts["stitch_scatter"] > 0, counts
    return dict(counts=counts, parity_rel=rels, timing=timing, offload=offload,
                steps=result["steps"], first_loss=result["first_loss"],
                last_loss=result["last_loss"], run_tokens_per_s=result["tokens_per_s"],
                run_peak_allocated_bytes=result["peak_allocated_bytes"],
                run_peak_reserved_bytes=result["peak_reserved_bytes"])


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this check needs a CUDA card",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.kernels import build, ops

    card = card_line()
    log(f"phase 1: {card} | torch {torch.__version__} cuda {torch.version.cuda} "
        f"| python {sys.version.split()[0]}")
    t0 = time.time()
    paths = build.build()
    log(f"phase 1: built {len(paths)} kernel libraries in {time.time() - t0:.1f} s "
        f"({', '.join(p.name for p in paths.values())})")

    rng = np.random.default_rng(0)
    check_copy_kernels(rng)
    check_attention_kernel(rng)

    ops.reset_launch_counts()
    serve()
    inp = lake(rng)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    log(f"phase 4: kernel launches on the main path {counts}")
    assert all(n > 0 for n in counts.values()), counts

    rows = timings(inp, counts)
    from repro_torch.kernels.stitched_attention import empty_kernel

    attn = rows[-1]
    log(f"phase 5: main-path attention {attn['ms']:.5f} ms device ({attn['call_ms']:.5f} ms "
        f"per call) beside an empty kernel's {time_ms(empty_kernel):.5f} ms, the practical "
        f"floor of one launch in this graph harness")
    shapes = attention_shapes(rng)
    log(f"phase 5: worst share of the row-scaled attention limit over all checks "
        f"{attn_share:.4g}")
    for r in shapes:
        log(f"phase 5: {r['shape']} attention (B={r['B']}, {r['tokens']} tokens, bf16): kernel "
            f"{r['ms']:.5f} ms, plain {r['plain_ms']:.5f} ms, bound {r['bound_ms']:.5f} ms "
            f"(bytes), {100 * r['bound_ms'] / r['ms']:.1f} % of bound")
    del inp  # the serving phases' arenas: phase 6 measures the training path alone
    trained = train_path(card)
    for row in rows:  # launches stays the serving path's count, at the timed shapes
        row["launches_by_path"] = {"serve": row["launches"],
                                   "train": trained["counts"][row["name"]]}
    print(json.dumps({"attention_shapes": shapes}))
    print(json.dumps({"training": {k: v for k, v in trained.items() if k != "counts"}}))
    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

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
   a larger call grew the kernel's workspace; and at the KV geometries of
   the newer architectures (``NEW_GEOMETRIES``: dbrx/grok/internlm2,
   starcoder2, danube3, paligemma), bf16 through ``arena_view`` of 2 MiB
   chunks, lengths at tile and chunk edges;
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
   1..16383 tokens) smollm-135m shapes, long shapes at dbrx-132b's and
   starcoder2-15b's geometry, and an empty kernel in the same graph
   harness as the practical floor of one launch;
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
   ``drop``;
7. supervised serving under faults, with launch counts zeroed before it
   and read after: (a) ``serve.killrecover``'s scenario for gmlake,
   caching, ellm and hybrid on the card, each held to the CPU port's run
   of it in this process (the reference: same restarts, every one an
   ``AllocatorOOM``, budget resets, memory report and allocation trace;
   gmlake's trace also equal to ``tests/data/serve_engine_killrecover
   .trace.json``), with tokens equal to the fault-free twin's on the card,
   then the chaos campaign's engine leg per backend (liveness, safety and
   quality); (b) the same scenario with smollm-135m at full width and the
   device model scaled to 30 layers (``KR_FULL``), held to the CPU port's
   run the same way, tokens equal bit for bit to the full-width fault-free
   twin's on the card; (c) a second full-width faulted engine stopped two
   steps past its restart: every live sequence's chunks over all layers
   and K/V pairwise disjoint and inside the arena, and a seeded bf16
   tensor scattered into them and gathered back bit-exact, each kernel
   call equal bit for bit to its plain version;
8. the MoE and VLM families: (a) dbrx-132b at full width, depth cut to
   ``DBRX_LAYERS``, served through the launcher's engine on phase 3's
   workload (16/16 finished, init time and tokens/s against the
   decode-step byte bound), and a second run on the same weights decoding
   the same tokens bit for bit; (b) the lake at its KV geometry (T_c =
   1024): stitched vs dense attention on both layers, its 1.23 GB
   embedding table round-tripped through a fragmented arena, with launch
   counts zeroed before (a) and all > 0 after (b), then 5 steady decode
   steps timed; (c) layer 0's MoE at
   full width on 64 tokens, card vs CPU in float32: routing and dropped
   slots equal, output within 1e-4 of each row's largest value, aux loss
   within 1e-5; (d) the smoke configs of danube3, internlm2, starcoder2,
   dbrx, grok and paligemma card vs CPU through prefill and 4 decode steps
   (logits within 1e-4, argmax equal), and paligemma-3b at full width cut
   to 2 layers (256 patches + 16 tokens, 8 decode steps, finite logits) with
   its stitched attention held to the dense path; phase 8's wall time.

Prints an ``{"attention_shapes": [...], "new_geometries": {...}}`` line, a
``{"training": {...}}`` line, a ``{"kernels": [...]}`` line (``launches``
is each kernel's count on the serving path, phases 3-4, whose shapes phase
5 times; ``launches_by_path`` has it beside the training path's, phase 6,
the kill/recover path's, phase 7, the MoE serving path's, 8a-b, and
8d's), a ``{"kill_recover": {...}}`` and a ``{"moe": {...}}`` line, then
the ``nvidia-smi`` line, and as the last line ``{"ok": true, "device":
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
F32_FLOPS_PER_S = 67e12  # H100 SXM float32 outside the tensor cores
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
#: phase 2's KV geometries of the newer architectures, bf16 in 2 MiB
#: chunks: (name, H, KVH, D); T_c 1024, 2048, 1092 (512 B left over in a
#: chunk) and 4096 tokens
NEW_GEOMETRIES = [("dbrx/grok/internlm2", 48, 8, 128), ("starcoder2", 48, 4, 128),
                  ("danube3", 32, 8, 120), ("paligemma", 8, 1, 256)]
#: phase 8a: dbrx-132b at full width cut to this depth (2 layers hold 6.34 B
#: expert parameters, 12.7 GB in bf16), serving phase 3's workload
DBRX_LAYERS = 2
DBRX_ARGS = ["--arch", "dbrx-132b", "--requests", "16", "--max-new", "16",
             "--max-batch", "8", "--seed", "0"]
#: phase 8b times this many decode steps of the lake's engine (8 running)
DBRX_TIMED_STEPS = 5
#: phase 8c: one full-width MoE layer on this many seeded tokens (capacity 20
#: against a mean load of 16; with this seed and the engine's router, 8 slots
#: drop, as the same float32 routing on the CPU shows)
MOE_TOKENS, MOE_SEED = 64, 1
MOE_OUT_TOL, MOE_AUX_RTOL = 1e-4, 1e-5
#: phase 8d: smoke configs held card against CPU, prefill then decode steps
FAMILY_ARCHS = ("h2o-danube-3-4b", "internlm2-20b", "starcoder2-15b", "dbrx-132b",
                "grok-1-314b", "paligemma-3b")
FAMILY_DECODE_STEPS = 4
FAMILY_RTOL = 1e-4
#: phase 8d: paligemma-3b at full width cut to 2 layers, 2 sequences of 256
#: patches + 16 tokens, then 8 decode steps
PALI_LAYERS, PALI_BATCH, PALI_TEXT, PALI_DECODE = 2, 2, 16, 8


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


def check_new_geometries(rng) -> dict:
    """Decode attention at the KV geometries of the newer architectures, in
    bf16 through ``StitchedKVCache.arena_view`` of real 2 MiB chunks (the
    strided view: danube3's 1092-token chunks leave 512 bytes unused), with
    K and V under separate tables and sequence lengths at the edges of the
    kernel's tiles and of the chunks (danube3's all below its 4096-token
    window: neither this kernel nor the reference's has a window). Returns
    each geometry's max abs error and plan."""
    from repro_torch.core.kvcache import KVCacheConfig, StitchedKVCache
    from repro_torch.kernels import ref
    from repro_torch.kernels.stitched_attention import attention_plan, stitched_decode_attention

    B, C, NP = 8, 3, 32
    out = {}
    for name, H, KVH, D in NEW_GEOMETRIES:
        kv = StitchedKVCache(KVCacheConfig(n_layers=1, n_kv=KVH, head_dim=D, n_chunks=NP,
                                           device=DEVICE))
        tc = kv.config.chunk_tokens
        kv.arena.buf.copy_(rand(rng, kv.arena.buf.shape, torch.bfloat16))
        view = kv.arena_view()
        plan = attention_plan(B, H, KVH, D, tc, C, 2)
        tt = plan.tile_tokens
        err = 0.0
        for lens in ([1, tt - 1, tt, tt + 1, tc - 1, tc, tc + 1, C * tc],
                     rng.integers(1, C * tc + 1, size=B).tolist()):
            q = rand(rng, (B, H, D), torch.bfloat16)
            ptk = ints(rng.integers(0, NP, size=(B, C)))
            ptv = ints(rng.integers(0, NP, size=(B, C)))
            sl = ints(lens)
            got = stitched_decode_attention(q, view, view, ptk, sl, page_table_v=ptv)
            want = ref.stitched_decode_attention_ref(q, view, view, ptk, sl, ptv)
            err = max(err, attn_close(got, want, (name, lens)))
        out[name] = dict(T_c=tc, tile_tokens=tt, kv_per_block=plan.kv_per_block,
                         max_abs_err=err)
        del kv, view
    torch.cuda.synchronize()
    log(f"phase 2: decode attention at the new KV geometries (bf16, 2 MiB chunks through "
        f"arena_view, tile/chunk-edge and random lengths, separate K/V tables) within "
        f"tolerance: {out}")
    return out


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


def lake(rng, eng, what: str) -> dict:
    """Check the stitched data path against the engine's dense path, after
    ``LAKE_STEPS`` steps of ``eng``; return the inputs phase 5 times the
    kernels on."""
    from repro_torch.alloc import CHUNK_SIZE
    from repro_torch.core.arena import Arena, ArenaConfig
    from repro_torch.models.layers import decode_attention_dense

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
        err = max(err, attn_close(got, want, (what, "lake layer", layer)))
    log(f"{what}: stitched attention == dense attention on {cfg.n_layers} layers x "
        f"{len(rids)} sequences (lens {lens}, chunk_tokens {kv.config.chunk_tokens}), "
        f"max abs err {err:.3g}")

    # the embedding table through an arena fragmented by alloc/free churn: 16
    # freed 2-chunk holes, and no more free chunks than the table needs
    emb = eng.params["embed"]
    emb_chunks = -(-emb.numel() * emb.element_size() // CHUNK_SIZE)
    arena = Arena(ArenaConfig(n_chunks=max(64, emb_chunks + 32), dtype=cfg.dtype,
                              device=DEVICE))
    churn = [arena.alloc_elems(2 * CHUNK_SIZE // cfg.dtype.itemsize) for _ in range(32)]
    for a in churn[::2]:
        arena.free(a)
    alloc = arena.alloc_elems(emb.numel())
    extents = alloc.block.extents
    assert len(extents) > 1, extents
    arena.store(alloc, emb)
    assert torch.equal(arena.load(alloc, tuple(emb.shape)), emb)
    log(f"{what}: {emb.numel() * emb.element_size() / 1e6:.1f} MB embedding table "
        f"round-tripped bit-exact through {len(extents)} stitched extents")

    ptk, sl = kv.page_table(rids, 0, "k")
    ptv, _ = kv.page_table(rids, 0, "v", pad_chunks=ptk.shape[1])
    return dict(arena=arena.buf, cmap=arena.chunk_map(alloc), q=q, view=kv.arena_view(),
                ptk=ptk, ptv=ptv, sl=sl, lens=lens, attn_err=err, extents=len(extents),
                emb_bytes=emb.numel() * emb.element_size())


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


#: attention_shapes: (shape, (H, KVH, D), sequences)
LONG_SHAPES = [("long", (9, 3, 64), 8), ("ragged", (9, 3, 64), 64),
               ("dbrx-long", (48, 8, 128), 8), ("starcoder2-long", (48, 4, 128), 8)]
LONG_TOKENS = 16383


def attention_shapes(rng) -> list:
    """Decode attention beyond the main path's shape, bf16 in strided views
    of 2 MiB chunks. Every shape has separate K and V buffers of B x C
    chunks under one page table that is a permutation of them, so no chunk
    is read twice and the counted bytes are the bytes in HBM. In
    smollm-135m's KV geometry (T_c = 5461): ``long``, 8 sequences of 16383
    tokens over 3 chunks each; ``ragged``, 64 sequences of 1..16383 tokens
    (uniform, from the script's seed; about 800 MB of K and V, far over the
    50 MB L2). ``dbrx-long`` and ``starcoder2-long`` are ``long`` in
    dbrx-132b's (48/8 heads, D 128, T_c 1024) and starcoder2-15b's (48/4,
    T_c 2048) geometry; at starcoder2's 12 query heads a kv head the
    kernel's float32 FMAs come to 60 % of the CUDA cores' time for the bytes
    (``fma_ms``). Each is checked against the plain version once, then
    timed."""
    from repro_torch.alloc import CHUNK_SIZE
    from repro_torch.kernels import ref
    from repro_torch.kernels.stitched_attention import stitched_decode_attention

    rows = []
    for name, (H, KVH, D), B in LONG_SHAPES:
        Tc = CHUNK_SIZE // (KVH * D * 2)
        C = -(-LONG_TOKENS // Tc)
        NP = B * C
        used = Tc * KVH * D
        k_buf = rand(rng, (NP, 1 << 20), torch.bfloat16)
        v_buf = rand(rng, (NP, 1 << 20), torch.bfloat16)
        k_view = k_buf[:, :used].unflatten(1, (Tc, KVH, D))
        v_view = v_buf[:, :used].unflatten(1, (Tc, KVH, D))
        q = rand(rng, (B, H, D), torch.bfloat16)
        pt = ints(rng.permutation(NP).reshape(B, C))
        if name == "ragged":
            lens = rng.integers(1, LONG_TOKENS + 1, size=B).tolist()
        else:
            lens = [LONG_TOKENS] * B
        sl = ints(lens)

        def kernel():
            return stitched_decode_attention(q, k_view, v_view, pt, sl)

        def plain():
            return ref.stitched_decode_attention_ref(q, k_view, v_view, pt, sl)

        err = attn_close(kernel(), plain(), name)
        nbytes = (2 * sum(lens) * KVH * D * 2 + 2 * q.numel() * 2 + pt.numel() * 4
                  + sl.numel() * 4)
        flops = 4 * sum(lens) * H * D
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        flops_ms = flops / BF16_FLOPS_PER_S * 1e3
        rows.append(dict(shape=name, H=H, KVH=KVH, D=D, T_c=Tc, B=B, tokens=sum(lens),
                         max_abs_err=err, ms=time_ms(kernel), plain_ms=time_ms(plain, iters=3),
                         bound_ms=max(bytes_ms, flops_ms),
                         bound_by="bytes" if bytes_ms >= flops_ms else "operations",
                         fma_ms=flops / F32_FLOPS_PER_S * 1e3))
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


# ---------------------------------------------------------------------------
# phase 7: supervised serving under faults (kill/recover)
# ---------------------------------------------------------------------------

KR_BACKENDS = ("gmlake", "caching", "ellm", "hybrid")
KR_GOLDEN = ROOT / "tests" / "data" / "serve_engine_killrecover.trace.json"
#: 7b's device model: the reference scenario (smoke model, 3 layers, a
#: 56-chunk device, 16 MB shrink, fault at alloc call 25) scaled to
#: smollm-135m's 30 layers, with its workload and KV accounting geometry
#: (32 tokens a 2 MiB chunk) kept. Each running sequence holds 30 x 2
#: allocations of 1-2 chunks, so 3 running sequences hold at most 360
#: chunks: n_chunks is the reference's 56 x 10 (a 1.1 GiB arena), shrink_mb
#: its 16 x 10. The admission ramp issues 180 device creates (the
#: reference's 18), and call 250 is the 70th growth create (the
#: reference's 7th): the fault lands at decode step 14, after the step-12
#: checkpoint, as in the reference. Confirmed with the CPU port, whose
#: accounting is host-side and the same at any model width.
KR_FULL = dict(n_chunks=560, shrink_mb=160, fault_call=250)
#: 7c stops its engine here, two steps past the restart at step 14, with
#: every admitted sequence still running (they finish at step 23 and later)
KR_STOP_STEPS = 16


def trace_events(trace) -> list:
    return [(e.op, e.tid, e.size, e.label, e.tenant, e.slo) for e in trace.events]


def restarts(events) -> list:
    return [(e["step"], e["error"]) for e in events if e["kind"] == "restart"]


def restore_targets(eng) -> list:
    """The steps ``load_state`` rebuilt from, read off the engine's trace."""
    prefix = "engine.restore@"
    return [int(e.label[len(prefix):]) for e in eng.recorder.trace.events
            if e.op == "mark" and e.label.startswith(prefix)]


def tokens(eng) -> dict:
    return {r.req_id: list(r.generated) for r in eng.finished}


def sync_s(t0: float) -> float:
    if DEVICE == "cuda":
        torch.cuda.synchronize()
    return round(time.perf_counter() - t0, 3)


def same_faulted_run(card: dict, cpu: dict, what: str) -> None:
    """A faulted run on the card against the CPU port's run of the same
    configuration, the reference it is held to: drained with every request
    finished, the same restarts (step and error, every one an
    ``AllocatorOOM``) and budget resets, the same memory report and the
    same allocation trace. Stragglers depend on timing and are left out."""
    for run in (card, cpu):
        assert run["drained"] and run["finished"] == run["requests"], (what, run["finished"])
    got = restarts(card["events"])
    assert got and got == restarts(cpu["events"]), (what, got, restarts(cpu["events"]))
    assert all(err.startswith("AllocatorOOM(") for _, err in got), (what, got)
    # the life after the last restore recovered every fault its ladder met;
    # read here, since the chaos engine leg looks under a key the report
    # does not have (ROADMAP queue C)
    counts = card["memory_report"]["recovery_events"]["counts"]
    assert counts.get("recovered", 0) >= 1 and not counts.get("unrecovered", 0), (what, counts)
    resets = [[e for e in run["events"] if e["kind"] == "budget_reset"] for run in (card, cpu)]
    assert resets[0] == resets[1], (what, resets)
    assert card["memory_report"] == cpu["memory_report"], (what, card["memory_report"],
                                                           cpu["memory_report"])
    assert trace_events(card["engine"].recorder.trace) == \
        trace_events(cpu["engine"].recorder.trace), what


def kill_recover_reference(workdir: Path) -> dict:
    """7a: the reference scenario for every backend with a calibrated fault
    point, on the card, held to the CPU port's run (and, for gmlake, to the
    checked-in recording); tokens equal to the fault-free twin's on the
    card; then the chaos campaign's engine leg for each backend."""
    from repro_torch.chaos.campaign import run_engine_leg
    from repro_torch.core.trace import load_trace
    from repro_torch.serve.killrecover import KillRecoverConfig, build_engine, run_scenario

    golden = trace_events(load_trace(KR_GOLDEN))
    rows = {}
    for b in KR_BACKENDS:
        cfg = KillRecoverConfig.for_backend(b)
        t0 = time.perf_counter()
        card = run_scenario(cfg, str(workdir / f"{b}-card"), device=DEVICE)
        card_s = sync_s(t0)
        t0 = time.perf_counter()
        cpu = run_scenario(cfg, str(workdir / f"{b}-cpu-reference"), device="cpu")
        cpu_s = round(time.perf_counter() - t0, 3)
        same_faulted_run(card, cpu, b)
        if b == "gmlake":
            assert trace_events(card["engine"].recorder.trace) == golden, "golden trace"
        t0 = time.perf_counter()
        twin = build_engine(cfg, None, device=DEVICE)
        twin.run_to_completion()
        twin_s = sync_s(t0)
        assert tokens(card["engine"]) == tokens(twin), b
        rep = card["memory_report"]
        rows[b] = dict(finished=card["finished"], restarts=restarts(card["events"]),
                       restore_targets=restore_targets(card["engine"]),
                       peak_reserved=rep["peak_reserved"],
                       injected_faults=rep["injected_faults"],
                       trace_events=rep["n_trace_events"], card_s=card_s,
                       twin_card_s=twin_s, cpu_reference_s=cpu_s)
        log(f"phase 7a: {b}: {card['finished']}/{card['requests']} finished on the card, "
            f"restarts at steps {[st for st, _ in rows[b]['restarts']]} (AllocatorOOM), "
            f"restored from steps {rows[b]['restore_targets']}, peak reserved "
            f"{rep['peak_reserved']}, {rep['n_trace_events']} trace events: restarts, memory "
            f"report and trace equal to the CPU port's run"
            f"{' and to the checked-in recording' if b == 'gmlake' else ''}; tokens equal to "
            f"the fault-free twin's; card {card_s} s, twin {twin_s} s, CPU reference {cpu_s} s")
    for b in KR_BACKENDS:
        v = run_engine_leg(b)
        assert v.liveness and v.safety and v.quality, v.to_payload()
        rows[b]["engine_leg"] = v.detail
    log(f"phase 7a: chaos engine legs on the card: liveness, safety and quality hold for "
        f"{', '.join(KR_BACKENDS)}")
    return rows


def full_width_engine(kr, params, schedule, device):
    """``serve.killrecover.build_engine``'s engine with smollm-135m at full
    width (the package builds the smoke model only, as the reference does)."""
    from repro_torch.alloc import CHUNK_SIZE, FaultInjector, FaultSchedule, VMMDevice, registry
    from repro_torch.configs import get_arch
    from repro_torch.serve.engine import EngineConfig, ServeEngine

    cfg = get_arch(kr.arch).full
    injector = FaultInjector(VMMDevice(kr.n_chunks * CHUNK_SIZE),
                             schedule if schedule is not None else FaultSchedule())
    eng = ServeEngine(cfg, params, EngineConfig(
        max_batch=kr.max_batch, max_len=128, n_chunks=kr.n_chunks,
        allocator=registry.create(kr.backend, injector), kv_n_kv=kr.kv_n_kv,
        kv_head_dim=kr.kv_head_dim, device=device))
    rng = np.random.default_rng(kr.seed)
    for _ in range(kr.requests):
        plen = int(rng.integers(8, 24))
        eng.submit(rng.integers(0, cfg.vocab, size=plen), max_new=kr.max_new)
    return eng


def full_width_params(kr, device):
    from repro_torch.configs import get_arch
    from repro_torch.models.transformer import init_params

    return init_params(get_arch(kr.arch).full, torch.Generator().manual_seed(kr.seed), device)


def supervised(eng, workdir: Path, kr, max_steps: int) -> dict:
    from repro_torch.ckpt.checkpoint import CheckpointManager
    from repro_torch.serve.killrecover import summarize, supervisor_config

    sup = eng.run_supervised(CheckpointManager(workdir, keep=3), max_steps=max_steps,
                             config=supervisor_config(kr))
    return summarize(eng, sup, kr.requests)


def kill_recover_full(workdir: Path, card: str) -> dict:
    """7b: smollm-135m at full width under the scaled fault schedule on the
    card, held to the CPU port's run of the same configuration; tokens
    equal bit for bit to the fault-free twin's on the card."""
    from repro_torch.configs import get_arch
    from repro_torch.serve.killrecover import KillRecoverConfig, build_schedule

    kr = KillRecoverConfig.for_backend("gmlake", **KR_FULL)
    cfg = get_arch(kr.arch).full
    params = full_width_params(kr, DEVICE)
    t0 = time.perf_counter()
    out = supervised(full_width_engine(kr, params, build_schedule(kr), DEVICE),
                     workdir / "card", kr, kr.max_steps)
    card_s = sync_s(t0)
    t0 = time.perf_counter()
    twin = full_width_engine(kr, params, None, DEVICE)
    twin.run_to_completion()
    twin_s = sync_s(t0)
    del params
    t0 = time.perf_counter()
    cpu = supervised(full_width_engine(kr, full_width_params(kr, "cpu"), build_schedule(kr),
                                       "cpu"), workdir / "cpu-reference", kr, kr.max_steps)
    cpu_s = round(time.perf_counter() - t0, 3)
    same_faulted_run(out, cpu, "full width")
    eng = out["engine"]
    targets = restore_targets(eng)
    # the fault lands after the first checkpoint: no restore goes back to step 0
    assert targets and min(targets) >= kr.checkpoint_every, targets
    assert tokens(eng) == tokens(twin), "full width: faulted run != fault-free twin"
    assert all(len(t) == kr.max_new for t in tokens(eng).values())
    rep = out["memory_report"]
    log(f"phase 7b: {cfg.name} ({cfg.n_layers} layers, d_model {cfg.d_model}, "
        f"{str(cfg.dtype).split('.')[-1]}) on {card}: {out['finished']}/{out['requests']} "
        f"finished, restarts {[st for st, _ in restarts(out['events'])]} (AllocatorOOM), "
        f"restored from steps {targets}, peak reserved {rep['peak_reserved']} of "
        f"{kr.n_chunks} x 2 MiB, injected {rep['injected_faults']}, {rep['n_trace_events']} "
        f"trace events; restarts, memory report and trace equal to the CPU port's run; tokens "
        f"equal bit for bit to the fault-free twin's. Wall time on the card: faulted run "
        f"{card_s} s, twin {twin_s} s (CPU reference {cpu_s} s)")
    return dict(config=dict(KR_FULL, n_layers=cfg.n_layers, d_model=cfg.d_model,
                            dtype=str(cfg.dtype).split(".")[-1]),
                finished=out["finished"], restarts=restarts(out["events"]),
                restore_targets=targets, peak_reserved=rep["peak_reserved"],
                injected_faults=rep["injected_faults"], trace_events=rep["n_trace_events"],
                card_s=card_s, twin_card_s=twin_s, cpu_reference_s=cpu_s)


def rebuilt_arena(workdir: Path, rng) -> dict:
    """7c: a second full-width faulted engine stopped two steps past its
    restart, sequences still running. Every live sequence's chunks, over
    all layers and K/V, are pairwise disjoint and inside the arena; a
    seeded bf16 tensor scattered into them and gathered back is bit-exact,
    and each kernel call equals its plain version bit for bit."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.stitch_copy import stitch_gather, stitch_scatter
    from repro_torch.serve.killrecover import KillRecoverConfig, build_schedule

    kr = KillRecoverConfig.for_backend("gmlake", **KR_FULL)
    eng = full_width_engine(kr, full_width_params(kr, DEVICE), build_schedule(kr), DEVICE)
    out = supervised(eng, workdir / "stopped", kr, KR_STOP_STEPS)
    got = restarts(out["events"])
    targets = restore_targets(eng)
    assert got and targets and max(targets) < KR_STOP_STEPS == eng.steps, (got, targets)
    assert sorted(eng.running) == sorted(eng.kv.seqs) and eng.running, eng.kv.seqs
    kv = eng.kv
    rids = sorted(kv.seqs)
    ids = []
    for layer in range(kv.config.n_layers):
        for name in ("k", "v"):
            table, lens = kv.page_table(rids, layer, name)
            for i, rid in enumerate(rids):
                row = kv._extent_chunks(rid, layer, name)
                assert table[i, :len(row)].tolist() == row, (rid, layer, name)
                assert len(row) * kv.config.chunk_tokens >= int(lens[i])
                ids.extend(row)
    assert len(ids) == len(set(ids)), "live sequences share a chunk"
    assert 0 <= min(ids) and max(ids) < kv.config.n_chunks == kv.arena.buf.shape[0]
    buf = kv.arena.buf
    cmap = ints(ids)
    values = rand(rng, (len(ids), buf.shape[1]), buf.dtype)
    want = ref.stitch_scatter_ref(buf.clone(), cmap, values)
    stitch_scatter(buf, cmap, values)
    assert same_bits(buf, want), "stitch_scatter != plain scatter"
    del want
    back = stitch_gather(buf, cmap)
    assert same_bits(back, values), "gather(scatter(x)) != x"
    assert same_bits(back, ref.stitch_gather_ref(buf, cmap)), "stitch_gather != plain gather"
    if DEVICE == "cuda":
        torch.cuda.synchronize()
    nbytes = values.numel() * values.element_size()
    log(f"phase 7c: stopped at step {eng.steps} after restarts {[st for st, _ in got]} "
        f"(restored from {targets}) with {len(rids)} sequences running: {len(ids)} chunks "
        f"over {kv.config.n_layers} layers x K/V, pairwise disjoint inside the "
        f"{kv.config.n_chunks}-chunk arena; {nbytes / 2**20:.0f} MiB of bf16 scattered and "
        f"gathered back bit-exact, each equal bit for bit to its plain version")
    return dict(stopped_at=eng.steps, restarts=got, restore_targets=targets,
                sequences=len(rids), chunks=len(ids), bytes=nbytes)


def kill_recover(card: str, rng) -> dict:
    """Phase 7 with the launch counts zeroed before it and read after."""
    from repro_torch.kernels import ops

    ops.reset_launch_counts()
    with tempfile.TemporaryDirectory(prefix="kill-recover-") as tmp:
        workdir = Path(tmp)
        reference = kill_recover_reference(workdir)
        full = kill_recover_full(workdir / "full", card)
        arena = rebuilt_arena(workdir / "arena", rng)
    if DEVICE == "cuda":
        torch.cuda.synchronize()
    counts = ops.launch_counts()
    log(f"phase 7: kernel launches on the kill/recover path {counts}")
    assert counts["stitch_gather"] > 0 and counts["stitch_scatter"] > 0, counts
    return dict(counts=counts, reference_scenario=reference, full_width=full,
                rebuilt_arena=arena)


# ---------------------------------------------------------------------------
# phase 8: the MoE and VLM families
# ---------------------------------------------------------------------------


def rel_rows(got: torch.Tensor, want: torch.Tensor) -> float:
    """The largest error over each last-axis row's largest |value|."""
    err = (got.double().cpu() - want.double().cpu()).abs().amax(-1)
    return float((err / want.double().cpu().abs().amax(-1)).max())


def dbrx_config():
    import dataclasses

    from repro_torch.configs import get_arch

    return dataclasses.replace(get_arch("dbrx-132b").full, n_layers=DBRX_LAYERS)


def dbrx_engine(cfg, params):
    """``launch/serve.py``'s ``build_engine`` for dbrx-132b cut to
    ``DBRX_LAYERS`` (the launcher builds whole configs only): its engine
    config and submit loop on ``DBRX_ARGS``, with ``params`` given."""
    from repro_torch.launch import serve as serve_cli
    from repro_torch.serve.engine import EngineConfig, ServeEngine

    args = serve_cli.parse_args(DBRX_ARGS)
    eng = ServeEngine(cfg, params, EngineConfig(max_batch=args.max_batch, device=DEVICE))
    rng = np.random.default_rng(args.seed)
    for _ in range(args.requests):
        plen = int(rng.integers(8, 64))
        eng.submit(rng.integers(0, cfg.vocab, size=plen), max_new=args.max_new)
    return eng


def serve_dbrx(card: str):
    """8a: dbrx-132b at full width (depth cut to ``DBRX_LAYERS``) through the
    serving launcher's engine and drain, phase 3's workload; then a second
    engine on the same weights must decode the same tokens bit for bit (the
    MoE combine is deterministic). Returns (params, result)."""
    from repro_torch.launch import serve as serve_cli
    from repro_torch.models.api import family_of
    from repro_torch.tree import leaves

    cfg = dbrx_config()
    args = serve_cli.parse_args(DBRX_ARGS)
    t0 = time.perf_counter()
    params = family_of(cfg).init_params(cfg, torch.Generator().manual_seed(args.seed), DEVICE)
    eng = dbrx_engine(cfg, params)
    init_s = sync_s(t0)
    out = serve_cli.run(eng, args)
    assert out["finished"] == out["requests"] == 16, out
    twin = dbrx_engine(cfg, params)
    twin_out = serve_cli.run(twin, args)
    assert tokens(twin) == tokens(eng), "dbrx: two runs decoded different tokens"
    # a decode step reads every weight once: all experts' (the dispatch runs
    # all E x C slots), attention's, and the tied embedding as the logits head
    step_bytes = wbytes = sum(t.numel() * t.element_size() for t in leaves(eng.params))
    step_ms = step_bytes / HBM_BYTES_PER_S * 1e3
    bound_tps = args.max_batch / step_ms * 1e3
    log(f"phase 8a: {cfg.name} at full width ({cfg.n_layers} layers, d_model {cfg.d_model}, "
        f"{cfg.n_heads}/{cfg.n_kv} heads, {cfg.n_experts} experts top-{cfg.top_k}, d_ff "
        f"{cfg.d_ff}, vocab {cfg.vocab}, bf16; {wbytes / 1e9:.2f} GB of weights) on {card}: "
        f"init {init_s} s (seeded weights drawn on the host, copied to the card); served "
        f"{out['finished']}/{out['requests']} in {out['decode_steps']} decode steps at "
        f"{out['tokens_per_s']} tokens/s (second run {twin_out['tokens_per_s']}, same tokens "
        f"bit for bit), against a decode-step bound of {step_ms:.3f} ms ({step_bytes / 1e9:.2f}"
        f" GB at 3.35 TB/s), at most {bound_tps:.0f} tokens/s at batch {args.max_batch}")
    return eng.params, dict(init_s=init_s, finished=out["finished"], requests=out["requests"],
                            decode_steps=out["decode_steps"], tokens_per_s=out["tokens_per_s"],
                            twin_tokens_per_s=twin_out["tokens_per_s"], weight_bytes=wbytes,
                            step_bound_ms=step_ms, bound_tokens_per_s=bound_tps,
                            arena=out["arena"])


def moe_layer(params, cfg) -> dict:
    """8c: layer 0's MoE at full width on ``MOE_TOKENS`` seeded tokens, in
    float32 (TF32 off) on the card and on the CPU from the same weights: the
    same routing exactly (top-k experts, sorted slots, dropped slots), the
    output within ``MOE_OUT_TOL`` of each row's largest value and the aux
    loss within ``MOE_AUX_RTOL``."""
    from repro_torch.models import moe

    p = {k: v[0].float() for k, v in params["layers"]["mlp"].items()}
    x = torch.from_numpy(np.random.default_rng(MOE_SEED).standard_normal(
        (1, MOE_TOKENS, cfg.d_model)).astype(np.float32))
    got = {}
    for dev in (DEVICE, "cpu"):
        pd = {k: v.to(dev) for k, v in p.items()}
        xd = x.to(dev)
        t0 = time.perf_counter()
        out, aux = moe.moe_apply(cfg, pd, xd)
        s_ = sync_s(t0) if dev == DEVICE else round(time.perf_counter() - t0, 3)
        r = moe.route(cfg, pd["router"], xd[0])
        got[dev] = (out.cpu(), float(aux), r.topi.cpu(), r.order.cpu(), r.kept.cpu(), s_)
        del pd
    (o_c, a_c, ti_c, or_c, k_c, s_card), (o_h, a_h, ti_h, or_h, k_h, s_cpu) = \
        got[DEVICE], got["cpu"]
    capacity = r.capacity
    assert torch.equal(ti_c, ti_h) and torch.equal(or_c, or_h), "routing differs"
    assert torch.equal(k_c, k_h), "dropped slots differ"
    dropped = int((~k_h).sum())
    assert dropped > 0, "no slot dropped: the capacity path was not exercised"
    rel = rel_rows(o_c[0], o_h[0])
    assert rel <= MOE_OUT_TOL, rel
    aux_rel = abs(a_c - a_h) / abs(a_h)
    assert aux_rel <= MOE_AUX_RTOL, (a_c, a_h)
    log(f"phase 8c: one full-width MoE layer on {MOE_TOKENS} tokens, card vs CPU in float32: "
        f"the same top-{cfg.top_k} experts and the same {dropped} dropped slots of "
        f"{k_h.numel()} (capacity {capacity}); "
        f"output within {rel:.3g} of each row's largest value (limit {MOE_OUT_TOL}), aux "
        f"{a_c:.7f} vs {a_h:.7f} (rel {aux_rel:.3g}); card {s_card} s, CPU {s_cpu} s")
    return dict(tokens=MOE_TOKENS, capacity=capacity, dropped=dropped, slots=k_h.numel(),
                out_rel=rel, aux=a_c, aux_rel=aux_rel, card_s=s_card, cpu_s=s_cpu)


def family_batch(cfg, rng, n_batch: int, n_text: int, device) -> dict:
    """Seeded prompt tokens, and for the vlm family patch embeddings."""
    batch = {"tokens": torch.from_numpy(
        rng.integers(0, cfg.vocab, size=(n_batch, n_text)).astype(np.int32))}
    if hasattr(cfg, "n_patches"):
        batch["patch_embeds"] = torch.from_numpy(rng.standard_normal(
            (n_batch, cfg.n_patches, cfg.d_model)).astype(np.float32))
    return {k: v.to(device) for k, v in batch.items()}


def family_smoke() -> dict:
    """8d: each newer architecture's smoke config (float32) on the card and
    on the CPU from the same seeded weights: prefill of 2 x 31 positions,
    then ``FAMILY_DECODE_STEPS`` decode steps; logits within ``FAMILY_RTOL``
    of each row's largest value and the same argmax."""
    from repro_torch.configs import get_arch
    from repro_torch.models.api import family_of

    rows = {}
    for arch in FAMILY_ARCHS:
        cfg = get_arch(arch).smoke
        fam = family_of(cfg)
        logits = {}
        for dev in (DEVICE, "cpu"):
            rng = np.random.default_rng(8)
            params = fam.init_params(cfg, torch.Generator().manual_seed(0), dev)
            n_text = 31 - getattr(cfg, "n_patches", 0)
            out, cache = fam.prefill(cfg, params, family_batch(cfg, rng, 2, n_text, dev),
                                     fam.init_cache(cfg, 2, 40, dev))
            seq = [out[:, -1]]
            for _ in range(FAMILY_DECODE_STEPS):
                nxt = torch.from_numpy(rng.integers(0, cfg.vocab, size=(2,)).astype(np.int32))
                out, cache = fam.decode_step(cfg, params, cache, nxt.to(dev))
                seq.append(out)
            logits[dev] = torch.stack(seq).cpu()
        rel = rel_rows(logits[DEVICE], logits["cpu"])
        assert rel <= FAMILY_RTOL, (arch, rel)
        assert torch.equal(logits[DEVICE].argmax(-1), logits["cpu"].argmax(-1)), arch
        rows[arch] = dict(family=fam.name, rel=rel)
    log(f"phase 8d: smoke configs, prefill + {FAMILY_DECODE_STEPS} decode steps, card vs CPU "
        f"in float32, logits within {FAMILY_RTOL} of each row's largest value and argmax "
        f"equal: {rows}")
    return rows


def paligemma_full(rng, card: str) -> dict:
    """8d: paligemma-3b at full width cut to ``PALI_LAYERS`` layers: prefill
    of ``PALI_BATCH`` sequences of 256 seeded patch embeddings and
    ``PALI_TEXT`` tokens, ``PALI_DECODE`` decode steps, every logit finite;
    then its K/V written into a stitched KV cache at its geometry (MQA, D
    256, 4096 tokens a chunk) and stitched decode attention held to the
    dense path on every layer (row-scaled 2e-2)."""
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.core.kvcache import KVCacheConfig, StitchedKVCache
    from repro_torch.models import paligemma
    from repro_torch.models.layers import decode_attention_dense

    cfg = dataclasses.replace(get_arch("paligemma-3b").full, n_layers=PALI_LAYERS)
    t0 = time.perf_counter()
    params = paligemma.init_params(cfg, torch.Generator().manual_seed(0), DEVICE)
    init_s = sync_s(t0)
    n = cfg.n_patches + PALI_TEXT + PALI_DECODE
    batch = family_batch(cfg, np.random.default_rng(9), PALI_BATCH, PALI_TEXT, DEVICE)
    t0 = time.perf_counter()
    out, cache = paligemma.prefill(cfg, params, batch,
                                   paligemma.init_cache(cfg, PALI_BATCH, n, DEVICE))
    finite = bool(torch.isfinite(out).all())
    tok = out[:, -1].argmax(-1).int()
    for _ in range(PALI_DECODE):
        out, cache = paligemma.decode_step(cfg, params, cache, tok)
        finite &= bool(torch.isfinite(out).all())
        tok = out.argmax(-1).int()
    run_s = sync_s(t0)
    assert finite and cache["length"].tolist() == [n] * PALI_BATCH, cache["length"]

    kv = StitchedKVCache(KVCacheConfig(n_layers=cfg.n_layers, n_kv=cfg.n_kv, head_dim=cfg.dh,
                                       dtype=cfg.dtype, n_chunks=16, device=DEVICE))
    rids = list(range(PALI_BATCH))
    for rid in rids:
        kv.add_sequence(rid, n)
    err = 0.0
    q = rand(rng, (PALI_BATCH, cfg.n_heads, cfg.dh), cfg.dtype)
    for layer in range(cfg.n_layers):
        for rid in rids:
            kv.write_tokens(rid, layer, "k", 0, cache["k"][layer, rid, :n])
            kv.write_tokens(rid, layer, "v", 0, cache["v"][layer, rid, :n])
        got = kv.decode_attention(rids, layer, q)
        want = decode_attention_dense(q[:, None], cache["k"][layer], cache["v"][layer],
                                      ints([n] * PALI_BATCH))[:, 0]
        err = max(err, attn_close(got, want, ("paligemma lake", layer)))
    log(f"phase 8d: {cfg.name} at full width ({cfg.n_layers} layers, d_model {cfg.d_model}, "
        f"{cfg.n_heads}/{cfg.n_kv} heads of {cfg.dh}, vocab {cfg.vocab}, bf16) on {card}: "
        f"init {init_s} s; prefill of {PALI_BATCH} x ({cfg.n_patches} patches + {PALI_TEXT} "
        f"tokens) and {PALI_DECODE} decode steps in {run_s} s, every logit finite; stitched "
        f"attention == dense on {cfg.n_layers} layers (chunk_tokens "
        f"{kv.config.chunk_tokens}), max abs err {err:.3g}")
    return dict(init_s=init_s, run_s=run_s, tokens=n, attn_err=err,
                chunk_tokens=kv.config.chunk_tokens)


def moe_path(card: str, rng) -> dict:
    """Phase 8. The MoE path (8a, 8b) runs with the launch counts zeroed
    before it and read after; 8c uses no kernel; 8d with the counts zeroed
    again and read after."""
    from repro_torch.kernels import ops

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    ops.reset_launch_counts()
    params, served = serve_dbrx(card)
    cfg = dbrx_config()
    eng = dbrx_engine(cfg, params)
    inp = lake(rng, eng, "phase 8b")
    lake_row = dict(attn_err=inp["attn_err"], extents=inp["extents"],
                    emb_bytes=inp["emb_bytes"], chunk_tokens=inp["view"].shape[1])
    del inp
    # steady decode: 8 sequences running, none finishing or admitted yet
    t0 = time.perf_counter()
    for _ in range(DBRX_TIMED_STEPS):
        eng.step()
    served["decode_step_ms"] = sync_s(t0) * 1e3 / DBRX_TIMED_STEPS
    assert len(eng.running) == 8 and not eng.finished, (len(eng.running), len(eng.finished))
    log(f"phase 8b: {DBRX_TIMED_STEPS} steady decode steps of 8 sequences, "
        f"{served['decode_step_ms']:.3f} ms a step (host clock after synchronize) against "
        f"the {served['step_bound_ms']:.3f} ms byte bound")
    del eng
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    log(f"phase 8b: kernel launches on the MoE serving path {counts}")
    assert all(n > 0 for n in counts.values()), counts
    layer = moe_layer(params, cfg)
    del params
    torch.cuda.empty_cache()
    ops.reset_launch_counts()
    smoke = family_smoke()
    pali = paligemma_full(rng, card)
    torch.cuda.synchronize()
    fam_counts = ops.launch_counts()
    assert fam_counts["stitched_decode_attention"] > 0, fam_counts
    wall = round(time.perf_counter() - t_phase, 3)
    log(f"phase 8: wall time {wall} s")
    return dict(counts=counts, family_counts=fam_counts, served=served, lake=lake_row,
                layer=layer, smoke=smoke, paligemma=pali, wall_s=wall)


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
    geometries = check_new_geometries(rng)

    ops.reset_launch_counts()
    serve()
    from repro_torch.launch import serve as serve_cli

    inp = lake(rng, serve_cli.build_engine(serve_cli.parse_args(SERVE_ARGS)), "phase 4")
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
        log(f"phase 5: {r['shape']} attention (H/KVH/D {r['H']}/{r['KVH']}/{r['D']}, B={r['B']}, "
            f"{r['tokens']} tokens, bf16): kernel {r['ms']:.5f} ms, plain {r['plain_ms']:.5f} ms, "
            f"bound {r['bound_ms']:.5f} ms ({r['bound_by']}), {100 * r['bound_ms'] / r['ms']:.1f} "
            f"% of bound; its float32 FMAs at the CUDA cores' peak {r['fma_ms']:.5f} ms")
    del inp  # the serving phases' arenas: phase 6 measures the training path alone
    trained = train_path(card)
    kr = kill_recover(card, rng)
    moe = moe_path(card, rng)
    for row in rows:  # launches stays the serving path's count, at the timed shapes
        row["launches_by_path"] = {"serve": row["launches"],
                                   "train": trained["counts"][row["name"]],
                                   "kill_recover": kr["counts"][row["name"]],
                                   "moe": moe["counts"][row["name"]],
                                   "families": moe["family_counts"][row["name"]]}
    print(json.dumps({"attention_shapes": shapes, "new_geometries": geometries}))
    print(json.dumps({"training": {k: v for k, v in trained.items() if k != "counts"}}))
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"kill_recover": {k: v for k, v in kr.items() if k != "counts"}}))
    print(json.dumps({"moe": {k: v for k, v in moe.items()
                              if k not in ("counts", "family_counts")}}, default=str))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one CUDA card and check it.

    python3 chip_smoke.py

Needs one CUDA card, ``nvcc`` and the repository checkout (it imports
``src/repro_torch``); imports nothing of JAX or of the JAX package. Phases:

1. print the card's name and power limit; build every kernel from
   ``src/repro_torch/csrc`` (one ``nvcc`` per source, all at once);
2. hold each CUDA kernel against its plain PyTorch version on the card:
   gather/scatter bit-exact, decode attention within 2e-5 (f32) / 2e-2
   (bf16), at the shapes of ``tests/test_kernels.py`` and at real 2 MiB
   chunks, including smollm-135m's KV geometry (T_c = 5461);
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
   with host work included (``call_ms``), and compute its bound.

Prints a ``{"kernels": [...]}`` line, then the ``nvidia-smi`` line, and as
the last line ``{"ok": true, "device": {...}}``. Any failed check raises,
so the script exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
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
    tol = F32_TOL if dtype == torch.float32 else BF16_TOL
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
    return max_err(got, want)


def check_attention_kernel(rng) -> None:
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
    torch.cuda.synchronize()
    log(f"phase 2: decode attention within tolerance on {n} ATTN_CASES runs + separate-KV, "
        f"short, empty, smollm-full (max err {err_full:.3g}) and engine-smoke "
        f"(max err {err_smoke:.3g}) geometries")


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

    attn_err = max_err(kernel(), plain())
    assert attn_err <= BF16_TOL, attn_err
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


def long_attention_times(rng) -> str:
    """Attention at long sequences (smollm-full geometry, 3 chunks each):
    not the main path's shape, reported beside it."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.stitched_attention import stitched_decode_attention

    B, H, KVH, D, Tc, C, NP = 8, 9, 3, 64, 5461, 3, 32
    used = Tc * KVH * D
    buf = rand(rng, (NP, 1 << 20), torch.bfloat16)
    view = buf[:, :used].unflatten(1, (Tc, KVH, D))
    q = rand(rng, (B, H, D), torch.bfloat16)
    pt = ints(np.stack([rng.permutation(NP)[:C] for _ in range(B)]))
    sl = ints([C * Tc] * B)
    nbytes = 2 * B * C * Tc * KVH * D * 2 + 2 * q.numel() * 2
    ms = time_ms(lambda: stitched_decode_attention(q, view, view, pt, sl))
    plain = time_ms(lambda: ref.stitched_decode_attention_ref(q, view, view, pt, sl))
    return (f"long-seq attention (B=8, seq 16383, T_c=5461, bf16): kernel {ms:.4f} ms, "
            f"plain {plain:.4f} ms, bound {nbytes / HBM_BYTES_PER_S * 1e3:.4f} ms (bytes)")


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
    log("phase 5: " + long_attention_times(rng))
    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

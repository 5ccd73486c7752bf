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
   starcoder2, danube3, paligemma, zamba2, whisper), bf16 through
   ``arena_view`` of 2 MiB chunks, lengths at tile and chunk edges; and
   ``decode_attention_dense``, which on the card runs the kernel over the
   dense cache, against the plain dense path (``dense_plain``) at every
   family's decode geometry (``DENSE_ROUTE_CASES``: the chat cell's,
   danube3 windowed, whisper's cross-attention over 1500 frames);
3. serve smollm-135m at full width through ``repro_torch.launch.serve``;
4. the lake: write a mid-run engine's dense K/V into its own stitched KV
   cache, compare stitched decode attention (the kernel) with the plain
   dense path for every layer, and round-trip the embedding table bit-exact
   through an arena fragmented by alloc/free churn; launch counts are
   zeroed before phase 3 and must all be > 0 after phase 4;
5. at the shapes phase 4 used, hold each kernel against its plain version
   once more (same tolerances) and time the kernel, its plain version and
   the one-call PyTorch yardstick as device time (calls captured in a CUDA
   graph, replayed between CUDA events), the kernel's wrapper also per call
   with host work included (``call_ms``), and compute its bound; time
   decode attention also at long (16383-token) and ragged (64 sequences of
   1..16383 tokens) smollm-135m shapes, long shapes at dbrx-132b's and
   starcoder2-15b's geometry, the dense route at the chat cell's shape
   (``CHAT_SHAPE``) beside the plain dense path and one
   ``scaled_dot_product_attention`` call (the yardstick only; timed last,
   after phase 12, so that the workspaces its yardsticks' warm-up streams
   keep do not count in 11a's process peak), and an empty kernel in the
   same graph harness as the practical floor of one launch;
6. the training path, with launch counts zeroed before it and read after:
   (a) the smoke config trained 10 steps on the card and on the CPU from
   the same seed and batches, in float32 (each loss within
   ``TRAIN_LOSS_RTOL``) and in bf16 with remat on, the full config's
   working types (within ``TRAIN_LOSS_RTOL_BF16``);
   (b) smollm-135m at full width (bf16, remat on, batch 8, seq 256) for 20
   steps through ``repro_torch.launch.train``, whose step is captured in a
   CUDA graph (``train/graph.py``), and its ``Supervisor``, checkpointing
   every 10 steps into a temporary directory, with one ``RuntimeError``
   injected at step 15: exactly that one restart (and no other event but
   logged stragglers), one capture, the restored step-10 state equal bit for
   bit to the state saved, all 20 steps in the history, every loss finite,
   the last below the first, and each within ``TRAIN_LOSS_RTOL_BF16`` of the
   eager step's on the same steps (bit-equality reported); then the eager
   and the graphed step in turns (eager, graph, graph, eager), each turn 2
   steps to warm up (the graph's warm-up and capture), 5 timed and 5
   profiled by ``measure`` of ``scripts/profile_train.py`` (ms/step,
   tokens/s, peak memory allocated and reserved, device busy and idle
   share, kernels per step); (c) the trained f32 first moments through
   ``OffloadManager`` on an f32 arena on the card (put, spill, fetch, get),
   bit-exact, every gather and scatter of it equal bit for bit to its plain
   version at the path's own chunk maps, and the arena empty after
   ``drop``; after the path's launch counts are read, both copy kernels
   timed as phase 5 times them at the largest moment's chunk map (the
   embedding's, 54 f32 chunks), beside their bound, plain version and
   library call;
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
   its stitched attention held to the dense path; phase 8's wall time;
9. the hybrid, ssm and audio families: (a) the smoke configs of zamba2,
   rwkv6 and whisper card vs CPU in float32 through prefill of 2 x 32
   positions (whisper beside 16 frames) and 4 decode steps (logits within
   1e-4 of each row's largest value, argmax equal), then 10 training steps
   each (losses within ``TRAIN_LOSS_RTOL``); (b) one full-width layer of
   each new mixer card vs CPU in float32 on 2 x 128 seeded inputs and 4
   single-token steps (zamba2's mamba2 mixer, rwkv6's time- and
   channel-mix, a whisper decoder layer over 1500 frames), every output and
   state within 1e-4 of each row's largest value; (c) zamba2-1.2b,
   rwkv6-7b and whisper-medium at full width and depth in bf16: prefill,
   16 decode steps, finite logits, init and prefill seconds, steady decode
   ms/step beside its byte bound, peak memory; (d) on 9c's caches, zamba2's
   and whisper's self-K/V through a stitched KV cache (stitched vs dense
   attention on every application or layer) and rwkv6-7b's WKV state
   through the offload arena (bit-exact, every scatter and gather equal to
   its plain version, then 4 decode steps from it equal bit for bit to
   those from the state that never left), with launch counts zeroed before
   (c) and all > 0 after (d); (e) zamba2-1.2b and whisper-medium trained 5
   steps at full width through ``repro_torch.launch.train`` on the graphed
   step (finite losses within ``TRAIN_LOSS_RTOL_BF16`` of the eager step's,
   no restart, one capture, ms/step and peak memory), then the graphed
   step timed by ``measure`` (one turn; the eager step's figures are
   PERF.md's, and whether the profiler sees inside replays is 6b's verdict);
   phase 9's wall time;
10. parallelism on a one-rank ``nccl`` group (``launch/mesh.py``), destroyed
   at the end: (a) phase 6b's run (smollm-135m at full width, bf16, remat,
   same seed and batches) cut to ``PAR_STEPS`` steps through the sharded
   launcher path with ``--model-parallel 2``, which one rank clamps to a
   (1, 1) mesh, on the graphed step (one capture): every loss within
   ``TRAIN_LOSS_RTOL_BF16`` of 6b's first steps (and whether bit-equal),
   every state leaf a DTensor on the mesh with the rules' placements; then
   ``measure`` of the graphed sharded step (ms/step, peak memory, device
   busy and idle share, kernels a step; one turn, as 9e) beside 6b's turns;
   (b) dbrx-132b at full width cut to ``DBRX_LAYERS`` (phase 8's weights,
   kept on the host meanwhile), one loss and the router and expert
   gradients at batch 2 x seq 256 through ``moe_apply_a2a`` on the
   one-rank mesh with ZeRO-3 weights (``zero_axis="data"``) against the
   global dispatch: every layer's routing and dropped slots equal, the
   loss within rtol 5e-4, the gradients within 2e-2 of each row's largest
   value; (c) ``compressed_psum`` for 30 error-feedback steps on a 49152 x
   576 f32 gradient (smollm's embedding, error below 0.05), and
   ``ring_layer_matmul`` and ``pipeline_forward`` against their dense
   versions within 2e-5 (f32); each leg prints a ``{"parallel": {...}}``
   line with the card's name and power limit;
11. the dry run and its cost model (``launch/dryrun.py``), after phase 10's
   group is gone: (a) ``validate`` for smollm-135m and zamba2-1.2b at 8 x
   256 tokens, the one-rank train step of ``launch/train.py`` predicted on
   meta tensors and run on the card: the predicted peak within
   ``DRYRUN_PEAK_RTOL`` of ``torch.cuda.max_memory_allocated`` over one step
   after a warm-up one, the FLOPs ``utils.opstats`` counts on the card's
   step equal to the meta count, the roofline lower bound beside the
   device-busy ms, and the predicted peak split into its parts; (b) the
   dry run's command line for smollm-135m on pod16x16 (``DRYRUN_SHAPES``,
   a fake group of 256 ranks per cell, nothing allocated): train_4k and
   decode_32k ok and long_500k skipped, decode_32k's
   per-device argument bytes the reference's 96,905,795,200, and
   train_4k's per-device matmul FLOPs x 256 within ``DOT_FLOPS_RTOL`` of
   the one-rank count at the same global batch. No kernel runs in phase 11;
12. the engine-trace recorder (``examples/record_engine_trace_torch.py``)
   on the card: its ``default`` and ``multitenant`` scenarios, each trace
   equal event for event, in decode steps and, saved, byte for byte to its
   checked-in recording in ``tests/data/``; its engine decodes through the
   attention kernel on the dense cache, so of the launch counts, zeroed
   before and reported, the kernel's must be above 0.

Prints an ``{"attention_shapes": [...], "new_geometries": {...},
"dense_route": {...}, "dense_route_chat": {...}}`` line, a
``{"training": {...}}`` line, a ``{"kernels": [...]}`` line (``launches``
is each kernel's count on the serving path, phases 3-4, whose shapes phase
5 times; ``launches_by_path`` has it beside the training path's, phase 6,
the kill/recover path's, phase 7, the MoE serving path's, 8a-b, 8d's, and
the new families', 9c-d, and the recorder's, 12), a ``{"kill_recover":
{...}}``, a ``{"moe": {...}}``, a ``{"new_families": {...}}``, a
``{"dryrun": {...}}`` and a ``{"record_engine_trace": {...}}`` line
(phase 10 prints its three ``{"parallel": {...}}`` lines and phases 6b, 9e
and 10a one ``{"graph": {...}}`` line per path as they run), then
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

from repro_torch.utils.roofline import HBM_BW as HBM_BYTES_PER_S  # noqa: E402
from repro_torch.utils.roofline import PEAK_FLOPS as BF16_FLOPS_PER_S  # noqa: E402

DEVICE = "cuda"
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
#: chunk), 4096, and for zamba2's shared block and whisper's decoder one
#: query head a kv head (G = 1) at T_c 512 and 1024
NEW_GEOMETRIES = [("dbrx/grok/internlm2", 48, 8, 128), ("starcoder2", 48, 4, 128),
                  ("danube3", 32, 8, 120), ("paligemma", 8, 1, 256),
                  ("zamba2", 32, 32, 64), ("whisper", 16, 16, 64)]
#: phase 2's dense route: ``decode_attention_dense`` on the card (the kernel
#: over one layer's dense cache) against ``dense_plain`` at every family's
#: decode geometry: (name, H, KVH, D, B, S, window, dtype). Danube3 twice
#: windowed: its smoke config's window 32 and its own 4096 over a longer
#: cache (several splits merge); whisper's cross-attention over all 1500
#: frames of every sequence
DENSE_ROUTE_CASES = [
    ("starcoder2 chat64", 48, 4, 128, 64, 1536, None, torch.bfloat16),
    ("smollm-135m", 9, 3, 64, 8, 2048, None, torch.bfloat16),
    ("danube3", 32, 8, 120, 8, 1024, None, torch.bfloat16),
    ("danube3 window 32", 32, 8, 120, 8, 1024, 32, torch.bfloat16),
    ("danube3 window 4096", 32, 8, 120, 4, 6144, 4096, torch.bfloat16),
    ("danube3-smoke window 32", 8, 4, 16, 4, 96, 32, torch.float32),
    ("internlm2/grok/dbrx", 48, 8, 128, 8, 1024, None, torch.bfloat16),
    ("paligemma", 8, 1, 256, 2, 288, None, torch.bfloat16),
    ("zamba2 shared", 32, 32, 64, 2, 1024, None, torch.bfloat16),
    ("whisper self", 16, 16, 64, 8, 448, None, torch.bfloat16),
    ("whisper cross", 16, 16, 64, 8, 1500, None, torch.bfloat16),
    ("smollm-smoke", 3, 1, 32, 4, 64, None, torch.float32),
]
#: phase 5 times the dense route at the chat cell's shape: 64 sequences of
#: 1..1536 tokens (seeded), starcoder2-15b's 48 query and 4 kv heads, D 128
CHAT_SHAPE = (64, 48, 4, 128, 1536)
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
#: phase 9: the hybrid, ssm and audio families
NEW_FAMILY_ARCHS = ("zamba2-1.2b", "rwkv6-7b", "whisper-medium")
#: 9a: prompt positions of the smoke configs, so zamba2's and rwkv6's chunk-8
#: scans run whole chunks; the audio family's seeded frames a sequence
NEW_SMOKE_POS, SMOKE_FRAMES = 32, 16
#: 9b: one full-width layer on 2 sequences of this many seeded positions,
#: then this many single-token steps; whisper's cross-attention over
#: FULL_FRAMES frames
LAYER_POS, LAYER_STEPS, FULL_FRAMES = 128, 4, 1500
#: 9c: full width and depth, bf16: 2 sequences of prompt tokens (whisper's
#: text tokens, beside FULL_FRAMES frames), then FULL_DECODE decode steps
FULL_BATCH, FULL_DECODE = 2, 16
FULL_PROMPT = {"zamba2-1.2b": 512, "rwkv6-7b": 512, "whisper-medium": 64}
#: 9d: decode steps from rwkv6's state fetched back from the offload arena
STATE_DECODE = 4
#: 9e: full-width training through the launcher (rwkv6-7b does not fit one
#: card: its f32 AdamW moments alone are 56 GB beside 14 GB of weights and
#: 14 GB of gradients)
NEW_TRAIN_ARCHS = ("zamba2-1.2b", "whisper-medium")
NEW_TRAIN_ARGS = ["--steps", "5", "--batch", "8", "--seq", "256", "--seed", "0",
                  "--device", "cuda"]
#: phase 10a: phase 6b's run cut to this many steps, on the sharded path
PAR_STEPS = 5
#: 10b: dbrx-132b's loss and gradients through the a2a dispatch on this
#: batch of seeded tokens, against the global dispatch
PAR_MOE_BATCH, PAR_MOE_SEQ, PAR_MOE_SEED = 2, 256, 2
PAR_MOE_LOSS_RTOL, PAR_MOE_GRAD_TOL = 5e-4, 2e-2
#: 10c: compressed_psum on smollm's embedding-sized gradient; the ring
#: matmul and GPipe at smollm's width (x (tokens, d) @ W (d, d_ff); 8
#: tanh layers in 4 stages, 6 microbatches); f32, TF32 off
PSUM_SHAPE, PSUM_STEPS, PSUM_SEED = (49152, 576), 30, 3
RING_X, RING_W = (2048, 576), (576, 1536)
PIPE_LAYERS, PIPE_MICRO, PIPE_MB = 8, 6, (2, 256, 576)
PAR_TOL = 2e-5
#: phase 11a: the one-rank train step (the launcher's: full config, f32
#: moments, one microbatch) predicted on meta tensors and run on the card,
#: at 6b's and 9e's shape (arch, batch, seq); the predicted peak must be
#: within DRYRUN_PEAK_RTOL of the measured one, both of the process's peak
#: and of the step's own (the process's less what earlier phases left
#: allocated)
DRYRUN_VALIDATE = (("smollm-135m", 8, 256), ("zamba2-1.2b", 8, 256))
DRYRUN_PEAK_RTOL = 0.10
#: 11b: the dry run's command line for this arch on pod16x16, these shapes.
#: prefill_32k is left out: with it phase 11 took 203.8 s in a whole run
#: (its trace alone 100.5 s: batch 32 does not split 256 ways, so each
#: rank traces the whole prefill), over the 150 s this phase may take
DRYRUN_ARCH = "smollm-135m"
DRYRUN_SHAPES = ("train_4k", "decode_32k", "long_500k")
#: the reference's per-device argument bytes for smollm-135m decode_32k
#: (its own dry run; the KV cache is replicated: batch 128 does not split
#: 256 ways)
SMOLLM_DECODE_ARGS = 96_905_795_200
#: train_4k's per-device matmul FLOPs x 256 against the one-rank count
DOT_FLOPS_RTOL = 1e-3


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


def dense_plain(q, k_cache, v_cache, lengths, window=None) -> torch.Tensor:
    """The plain dense decode attention, ``decode_attention_dense``'s code for
    CPU tensors, on any device: each kv head repeated to its query heads, the
    cache cast to float32, a softmax over every position, the probabilities
    rounded to q's dtype before P.V. On the card ``decode_attention_dense``
    runs the kernel, so this is what the kernel is held to, and the old
    path's time."""
    from repro_torch.models.layers import NEG_INF, _expand_kv

    h, d = q.shape[2], q.shape[3]
    s = k_cache.shape[1]
    kf, vf = _expand_kv(k_cache, h), _expand_kv(v_cache, h)
    logits = torch.einsum("bqhd,bshd->bhqs", (q * d**-0.5).float(), kf.float())
    pos = torch.arange(s, device=q.device)[None, :]
    valid = pos < lengths.long()[:, None]
    if window is not None:
        valid = valid & (pos > (lengths.long()[:, None] - 1 - window))
    logits = logits.masked_fill(~valid[:, None, None, :], NEG_INF)
    p = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhqs,bshd->bqhd", p.float(), vf.float()).to(q.dtype)


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
                chunk_elems=None, window=0):
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
        got = stitched_decode_attention(q, ka, ka, pt, sl, page_table_v=ptv, window=window)
        want = ref.stitched_decode_attention_ref(q, ka, ka, pt, sl, ptv, window=window)
    else:
        got = stitched_decode_attention(q, ka, va, pt, sl, window=window)
        want = ref.stitched_decode_attention_ref(q, ka, va, pt, sl, window=window)
    return attn_close(got, want, (B, H, KVH, D, Tc, C, dtype, seq_lens, window))


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
    # a sliding window: the walk starts inside a chunk, its first tile masks,
    # splits count from there and merge (smollm's geometry, windows of a few
    # tiles up to more than a chunk); and a window in float32 at tile size 1-64
    err_window = _attn_check(rng, 8, 9, 3, 64, 5461, 3, 32, bf16, seq_lens=lens,
                             separate_v=True, chunk_elems=1 << 20, window=6000)
    for window in (1, 5, 100):
        err_window = max(err_window, _attn_check(
            rng, 8, 9, 3, 64, 5461, 3, 32, bf16, seq_lens=lens, chunk_elems=1 << 20,
            window=window))
        err_window = max(err_window, _attn_check(rng, 3, 9, 3, 64, 8, 5, 16, f32,
                                                 seq_lens=[0, 5, 40], window=window))
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
        f"sliding windows (max err {err_window:.3g}), "
        f"unaligned arenas, {GRAPH_REPLAYS} graph replays (max err {err_graph:.3g}) and "
        f"replays after the workspace grew (max err {err_grown:.3g}); worst share of the "
        f"row-scaled limit {attn_share:.4g}")


def check_new_geometries(rng) -> dict:
    """Decode attention at the KV geometries of the newer architectures, in
    bf16 through ``StitchedKVCache.arena_view`` of real 2 MiB chunks (the
    strided view: danube3's 1092-token chunks leave 512 bytes unused), with
    K and V under separate tables and sequence lengths at the edges of the
    kernel's tiles and of the chunks (danube3's all below its 4096-token
    window: the stitched path passes none; ``check_dense_route`` holds the
    kernel's window). Returns
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


def check_dense_route(rng) -> dict:
    """``decode_attention_dense`` on the card, which runs the kernel over the
    dense cache (B chunks of S tokens under the identity page table), held
    to ``dense_plain`` at each of ``DENSE_ROUTE_CASES``: lengths at the
    edges of the kernel's tiles, of the window and of the cache, then a
    seeded ragged mix (whisper's cross-attention: every sequence all 1500
    frames). Returns each case's max abs error and plan."""
    from repro_torch.kernels.stitched_attention import attention_plan
    from repro_torch.models.layers import decode_attention_dense

    out = {}
    for name, H, KVH, D, B, S, window, dtype in DENSE_ROUTE_CASES:
        plan = attention_plan(B, H, KVH, D, S, 1, dtype.itemsize)
        tt = plan.tile_tokens
        k = rand(rng, (B, S, KVH, D), dtype)
        v = rand(rng, (B, S, KVH, D), dtype)
        if name == "whisper cross":
            draws = [[S] * B]
        else:
            edges = [1, tt - 1, tt, tt + 1, S - 1, S]
            if window:
                edges += [window - 1, window, window + 1, window + tt + 1]
            edges = sorted({n for n in edges if 1 <= n <= S})
            draws = [(edges[i:i + B] + [S] * B)[:B] for i in range(0, len(edges), B)]
            draws.append(rng.integers(1, S + 1, size=B).tolist())
        err = 0.0
        for lens in draws:
            q = rand(rng, (B, 1, H, D), dtype)
            sl = ints(lens)
            got = decode_attention_dense(q, k, v, sl, window=window)
            want = dense_plain(q, k, v, sl, window=window)
            err = max(err, attn_close(got[:, 0], want[:, 0], (name, lens)))
        out[name] = dict(tile_tokens=tt, kv_per_block=plan.kv_per_block, splits=plan.splits,
                         tiles_per_split=plan.tiles_per_split, max_abs_err=err)
        del k, v
    torch.cuda.synchronize()
    log(f"phase 2: dense decode attention through the kernel within tolerance of the plain "
        f"dense path at every family's decode geometry: {out}")
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
        want = dense_plain(q[:, None], cache["k"][layer, slots], cache["v"][layer, slots],
                           lens_t)[:, 0]
        err = max(err, attn_close(got, want, (what, "lake layer", layer)))
    log(f"{what}: stitched attention == plain dense attention on {cfg.n_layers} layers x "
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


def copy_times(arena: torch.Tensor, cmap: torch.Tensor) -> dict:
    """``stitch_gather`` and ``stitch_scatter`` on ``arena`` at ``cmap``:
    each held bit for bit to its plain version, then its device time, call
    time, plain version's and one-call library yardstick's device time
    (``index_select``, ``index_copy_``) beside its byte bound (each logical
    chunk read once and written once, and the map read). The scatter writes
    the gathered values back in place."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.stitch_copy import stitch_gather, stitch_scatter

    cmap_long = cmap.long()
    copy_bytes = 2 * cmap.numel() * arena.shape[1] * arena.element_size() + cmap.numel() * 4
    bound = dict(bound_ms=copy_bytes / HBM_BYTES_PER_S * 1e3, bound_by="bytes")
    values = stitch_gather(arena, cmap)

    gather_err = max_err(stitch_gather(arena, cmap), ref.stitch_gather_ref(arena, cmap))
    assert gather_err == 0.0, gather_err
    gather = dict(
        max_abs_err=gather_err, ms=time_ms(lambda: stitch_gather(arena, cmap)),
        call_ms=call_ms(lambda: stitch_gather(arena, cmap)),
        plain_ms=time_ms(lambda: ref.stitch_gather_ref(arena, cmap)), **bound,
        library_ms=time_ms(lambda: torch.index_select(arena, 0, cmap_long)),
    )

    a1, a2 = arena.clone(), arena.clone()
    scatter_err = max_err(stitch_scatter(a1, cmap, values),
                          ref.stitch_scatter_ref(a2, cmap, values))
    assert scatter_err == 0.0 and torch.equal(a1, a2), scatter_err
    del a1, a2
    scatter = dict(
        max_abs_err=scatter_err, ms=time_ms(lambda: stitch_scatter(arena, cmap, values)),
        call_ms=call_ms(lambda: stitch_scatter(arena, cmap, values)),
        plain_ms=time_ms(lambda: ref.stitch_scatter_ref(arena, cmap, values)), **bound,
        library_ms=time_ms(lambda: arena.index_copy_(0, cmap_long, values)),
    )
    return {"stitch_gather": gather, "stitch_scatter": scatter}


def timings(inp: dict, counts: dict) -> list:
    from repro_torch.kernels import ref
    from repro_torch.kernels.stitched_attention import stitched_decode_attention

    copies = copy_times(inp["arena"], inp["cmap"])
    rows = [dict(name=name, route="cuda", source="src/repro_torch/csrc/stitch_copy.cu",
                 replaces=replaces, launches=counts[name], **copies[name])
            for name, replaces in (("stitch_gather", "src/repro/kernels/stitch_copy.py:38"),
                                   ("stitch_scatter", "src/repro/kernels/stitch_copy.py:65"))]

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


def dense_route_times(rng) -> dict:
    """The dense route at the chat cell's shape (``CHAT_SHAPE``, bf16,
    ragged lengths): held to ``dense_plain`` once, then the route's device
    time and time per call, the plain path's device time (the dense decode
    attention before the route: heads repeated, cache cast to float32), one
    ``scaled_dot_product_attention`` call over the same cache with a length
    mask as the yardstick only, and the bound: the valid tokens' K and V
    read once, q read and the output written, over HBM bandwidth."""
    import torch.nn.functional as F

    from repro_torch.models.layers import decode_attention_dense

    B, H, KVH, D, S = CHAT_SHAPE
    k = rand(rng, (B, S, KVH, D), torch.bfloat16)
    v = rand(rng, (B, S, KVH, D), torch.bfloat16)
    q = rand(rng, (B, 1, H, D), torch.bfloat16)
    lens = rng.integers(1, S + 1, size=B).tolist()
    sl = ints(lens)
    mask = (torch.arange(S, device=DEVICE)[None, :] < sl.long()[:, None])[:, None, None, :]
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)

    def route():
        return decode_attention_dense(q, k, v, sl)

    def plain():
        return dense_plain(q, k, v, sl)

    def library():
        return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask, enable_gqa=True)

    err = attn_close(route()[:, 0], plain()[:, 0], "chat64 dense route")
    tokens = sum(lens)
    nbytes = 2 * tokens * KVH * D * 2 + 2 * q.numel() * 2 + 2 * B * 4
    flops = 4 * tokens * H * D
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    flops_ms = flops / BF16_FLOPS_PER_S * 1e3
    return dict(shape="starcoder2-chat64-dense", H=H, KVH=KVH, D=D, S=S, B=B, tokens=tokens,
                max_abs_err=err, ms=time_ms(route), call_ms=call_ms(route),
                plain_ms=time_ms(plain, iters=3), library_ms=time_ms(library, iters=3),
                bound_ms=max(bytes_ms, flops_ms),
                bound_by="bytes" if bytes_ms >= flops_ms else "operations",
                fma_ms=flops / F32_FLOPS_PER_S * 1e3)


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


def loss_curves(cfg, rtol: float, what: str) -> float:
    """``PARITY_STEPS`` training steps of ``cfg`` on the CPU and on the card
    from the same seed and batches (the audio family's with frames): each
    loss within ``rtol`` of the CPU port's (the CPU tests hold the CPU port
    against JAX). Returns the largest relative difference."""
    from repro_torch.data.pipeline import DataConfig, SyntheticTokens
    from repro_torch.models.api import family_of
    from repro_torch.train import optimizer as opt
    from repro_torch.train.step import init_state, make_train_step

    adamw = opt.AdamWConfig()
    frame_dim = cfg.d_model if family_of(cfg).name == "audio" else None
    curves = {}
    for dev in ("cpu", DEVICE):
        state = init_state(cfg, adamw, torch.Generator().manual_seed(0), dev)
        step = make_train_step(cfg, adamw)
        data = SyntheticTokens(DataConfig(vocab=cfg.vocab, seq_len=64, global_batch=4,
                                          frame_dim=frame_dim), dev)
        curves[dev] = []
        for i in range(PARITY_STEPS):
            state, m = step(state, data.batch_at(i))
            curves[dev].append(float(m["loss"]))
    cpu, card = np.array(curves["cpu"]), np.array(curves[DEVICE])
    rel = float(np.max(np.abs(card - cpu) / np.abs(cpu)))
    assert rel <= rtol, (what, curves, rel)
    log(f"{what} loss on the card matches the CPU port over {PARITY_STEPS} steps "
        f"({card[0]:.6f} -> {card[-1]:.6f}), max relative difference {rel:.3g} (limit "
        f"{rtol:.3g})")
    return rel


def train_parity() -> dict:
    """6a: the smoke config's loss curve on the card against the CPU port's,
    in float32 and in the full config's working types (bf16, remat on).
    Returns the largest relative difference of each."""
    import dataclasses

    from repro_torch.configs import get_arch

    smoke = get_arch("smollm-135m").smoke
    return {
        "float32": loss_curves(smoke, TRAIN_LOSS_RTOL, "phase 6a: float32 smoke-config"),
        "bfloat16": loss_curves(dataclasses.replace(smoke, dtype=torch.bfloat16, remat=True),
                                TRAIN_LOSS_RTOL_BF16, "phase 6a: bfloat16 smoke-config"),
    }


def launcher_data(cfg, args):
    """The train launcher's data pipeline for ``cfg`` and its arguments."""
    from repro_torch.data.pipeline import DataConfig, SyntheticTokens
    from repro_torch.models.api import family_of

    fam = family_of(cfg).name
    return SyntheticTokens(DataConfig(
        vocab=cfg.vocab, seq_len=args.seq, global_batch=args.batch, seed=args.seed,
        patch_dim=cfg.d_model if fam == "vlm" else None,
        frame_dim=cfg.d_model if fam == "audio" else None), DEVICE)


def eager_losses(cfg, args) -> list:
    """The launcher's first ``args.steps`` steps run by the eager step, with
    no supervisor: the same seeded state, batches and AdamW."""
    from repro_torch.train import optimizer as opt
    from repro_torch.train.step import init_state, make_train_step

    adamw = opt.AdamWConfig(lr=args.lr)
    state = init_state(cfg, adamw, torch.Generator().manual_seed(args.seed), DEVICE)
    step, data = make_train_step(cfg, adamw), launcher_data(cfg, args)
    losses = []
    for i in range(args.steps):
        state, m = step(state, data.batch_at(i))
        losses.append(float(m["loss"]))
    del state
    torch.cuda.empty_cache()
    return losses


def hold_losses(graphed: list, eager: list, what: str) -> dict:
    """Each graphed loss within ``TRAIN_LOSS_RTOL_BF16`` (one bf16 rounding)
    of the eager step's at the same step; bit-equality is reported."""
    rel = max(abs(g - e) / abs(e) for g, e in zip(graphed, eager, strict=True))
    assert rel <= TRAIN_LOSS_RTOL_BF16, (what, graphed, eager)
    return dict(max_rel=rel, bit_equal=graphed == eager)


def graph_turns(step_fn, state, batch_at, first: int, order) -> tuple:
    """``measure`` of ``scripts/profile_train.py`` on the eager step and on
    the graphed one (``train.graph.GraphedStep`` of the same step) in turns
    (``order``, e.g. eager, graph, graph, eager), each turn on fresh
    batches; the graph and its pool go before an eager turn that no graph
    turn follows. Returns (state, {"eager": [...], "graph": [...]})."""
    from repro_torch.train.graph import GraphedStep

    sys.path.insert(0, str(ROOT / "scripts"))
    from profile_train import STEPS, WARMUP, measure

    graphed, rows = None, {"eager": [], "graph": []}
    for i, mode in enumerate(order):
        if mode == "graph" and graphed is None:
            graphed = GraphedStep(step_fn, DEVICE)
        if mode == "eager" and "graph" not in order[i:]:
            graphed = None
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        state, timing = measure(graphed if mode == "graph" else step_fn, state, batch_at,
                                first + i * (WARMUP + 2 * STEPS))
        timing["wall_s"] = time.perf_counter() - t0
        assert math.isfinite(timing["last_loss"]), (mode, timing)
        if mode == "graph":
            assert graphed.signatures == 1 and graphed.captured == 1, graphed.signatures
        rows[mode].append(timing)
    return state, rows


def turn_figures(timing: dict, busy_measured: bool) -> dict:
    prof = timing["profiled"]
    return dict(ms_per_step=timing["ms_per_step"], tokens_per_s=timing["tokens_per_s"],
                peak_allocated_bytes=timing["peak_allocated_bytes"],
                peak_reserved_bytes=timing["peak_reserved_bytes"],
                device_busy_ms_per_step=prof["device_busy_ms_per_step"] if busy_measured
                else "not measured",
                device_idle_share=prof["device_idle_share"] if busy_measured
                else "not measured",
                kernels_per_step=prof["kernels_per_step"],
                profiled_ms_per_step=prof["ms_per_step"], wall_s=timing["wall_s"])


def graph_line(path: str, card: str, rows: dict, losses: dict, sees_replays=None,
               **extra) -> dict:
    """Print one ``{"graph": {...}}`` line: each eager and graphed turn's
    ms/step, device busy, idle share, kernels a step and peak memory. If the
    profiler records under a tenth of the eager kernels a step in replays,
    it does not see inside the graph: busy and idle are "not measured" there
    and the CUDA-event ms/step stands. Whether it does is a property of the
    torch build, not of the model, so a path timed without an eager turn
    takes ``sees_replays``, 6b's verdict in the same run, and says so."""
    if rows["eager"]:
        eager_k = min(t["profiled"]["kernels_per_step"] for t in rows["eager"])
        seen = all(t["profiled"]["kernels_per_step"] >= 0.1 * eager_k for t in rows["graph"])
        extra["profiler_verdict_from"] = path
    else:
        assert sees_replays is not None, path
        seen = sees_replays
        extra["profiler_verdict_from"] = "6b"
    row = dict(path=path, card=card, losses=losses, profiler_sees_replays=seen,
               eager=[turn_figures(t, True) for t in rows["eager"]],
               graph=[turn_figures(t, seen) for t in rows["graph"]], **extra)
    print(json.dumps({"graph": row}, default=str), flush=True)
    for mode in ("eager", "graph"):
        for r in row[mode]:
            busy, idle = r["device_busy_ms_per_step"], r["device_idle_share"]
            log(f"phase {path}: {mode} turn on {card}: {r['ms_per_step']:.3f} ms/step, device "
                f"busy {busy if isinstance(busy, str) else f'{busy:.3f} ms'}, idle share "
                f"{idle if isinstance(idle, str) else f'{idle:.4f}'}, "
                f"{r['kernels_per_step']:.0f} kernels/step, peak allocated "
                f"{r['peak_allocated_bytes'] / 2**30:.3f} GiB, reserved "
                f"{r['peak_reserved_bytes'] / 2**30:.3f} GiB ({r['wall_s']:.1f} s)")
    return row


def supervised_training(workdir: Path, card: str):
    """6b: full-width smollm-135m through the launcher (on the graphed step)
    and its supervisor, one fault injected, its losses held to the eager
    step's on the same steps; then the eager and graphed steps timed in
    turns in steady state. Returns (result, final state, timing, graph
    row)."""
    from repro_torch.ckpt.checkpoint import CheckpointManager
    from repro_torch.configs import get_arch
    from repro_torch.launch import train
    from repro_torch.train import optimizer as opt
    from repro_torch.train.step import make_train_step
    from repro_torch.tree import flatten_with_path

    args = train.parse_args(TRAIN_ARGS)
    entry = get_arch(args.arch)
    cfg = entry.smoke if args.smoke else entry.full
    watch = args.ckpt_every
    eager = eager_losses(cfg, args)

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
    # one batch signature, captured once and never again for the restore
    assert (result["signatures"], result["graphs"]) == (1, 1), result
    held = hold_losses(losses, eager, "phase 6b")

    log(f"phase 6b: {cfg.name} ({cfg.n_layers} layers, d_model {cfg.d_model}, "
        f"{str(cfg.dtype).split('.')[-1]}, remat {cfg.remat}, batch {args.batch}, seq "
        f"{args.seq}): {result['steps']} supervised steps, events {[e['kind'] for e in events]} "
        f"at step {events[0]['step']} and {stragglers} logged stragglers, restored step {watch} bit-exact, saves at steps "
        f"{ckpt.saves}, loss {result['first_loss']:.4f} -> {result['last_loss']:.4f} "
        f"(min {result['min_loss']:.4f}), wall {result['wall_s']} s incl. checkpoints, "
        f"{result['tokens_per_s']} tokens/s over the run, peak allocated "
        f"{result['peak_allocated_bytes'] / 2**30:.3f} GiB, reserved "
        f"{result['peak_reserved_bytes'] / 2**30:.3f} GiB (with this check's copy of the "
        f"step-{watch} state); disk free before {free_gb:.1f} GB; on the graphed step "
        f"({result['graphs']} capture), every loss within {held['max_rel']:.3g} of the eager "
        f"step's (bit-equal {held['bit_equal']})")

    # steady state, measured as scripts/profile_train.py measures it, eager
    # and graphed in turns on this card
    ckpt.saved = None
    step_fn = make_train_step(cfg, opt.AdamWConfig(lr=args.lr))
    state, timing = graph_turns(step_fn, state, launcher_data(cfg, args).batch_at, args.steps,
                                ("eager", "graph", "graph", "eager"))
    row = graph_line("6b", card, timing, held, arch=cfg.name, launcher_graphs=result["graphs"])
    return result, state, timing, row


def offload_roundtrip(tensors: dict, what: str):
    """Float32 tensors through host offload on an f32 arena on the card
    (put, spill, fetch, get), bit-exact, arena empty at the end. Every
    kernel launch of the path is held bit for bit to its plain version on
    the same inputs, at the path's own chunk maps: after each store (put,
    fetch) the whole arena against ``stitch_scatter_ref`` applied to a copy
    of the arena from before it, and each load (spill, get) against
    ``stitch_gather_ref`` of the arena it read. Returns (summary, the
    tensors ``get`` gave back, the arena's buffer and the largest tensor's
    chunk map as ``put`` placed it)."""
    from repro_torch.alloc import CHUNK_SIZE
    from repro_torch.core.arena import Arena, ArenaConfig
    from repro_torch.core.offload import OffloadManager
    from repro_torch.kernels import ref

    assert all(t.dtype == torch.float32 for t in tensors.values())
    chunks = sum(-(-t.numel() * 4 // CHUNK_SIZE) for t in tensors.values())
    arena = Arena(ArenaConfig(n_chunks=chunks + 8, dtype=torch.float32, device=DEVICE))
    ce = arena.config.chunk_elems
    om = OffloadManager(arena)

    def chunk_map(name):
        return arena.chunk_map(om._device[name].alloc)[:-(-tensors[name].numel() // ce)]

    def stored(name, before):
        """The arena after storing ``tensors[name]`` equals the plain scatter."""
        cmap = chunk_map(name)
        values = torch.zeros((cmap.numel(), ce), dtype=torch.float32, device=DEVICE)
        values.view(-1)[:tensors[name].numel()] = tensors[name].reshape(-1)
        assert same_bits(arena.buf, ref.stitch_scatter_ref(before, cmap, values)), name

    def gathered(name):
        """The plain gather of ``tensors[name]`` from the arena as it stands."""
        t = tensors[name]
        return ref.stitch_gather_ref(arena.buf, chunk_map(name)).reshape(-1)[:t.numel()] \
            .reshape(t.shape)

    maps, largest = [], max(tensors, key=lambda n: tensors[n].numel())
    for name, t in tensors.items():
        before = arena.buf.clone()
        om.put(name, t)
        stored(name, before)
        maps.append(chunk_map(name).numel())
        if name == largest:
            largest_map = chunk_map(name)
    for name in tensors:
        want = gathered(name)
        om.spill(name)
        assert same_bits(om._host[name], want.cpu()), name
    assert arena.active_bytes == 0 and not any(om.is_resident(n) for n in tensors)
    for name in tensors:
        before = arena.buf.clone()
        om.fetch(name)
        stored(name, before)
    del before
    back = {}
    for name, t in tensors.items():
        want = gathered(name)
        back[name] = om.get(name)
        assert back[name].device == t.device and same_bits(back[name], want) \
            and same_bits(back[name], t), name
    nbytes = sum(t.numel() * 4 for t in tensors.values())
    for name in tensors:
        om.drop(name)
    assert arena.active_bytes == 0 and om.names() == set()
    torch.cuda.synchronize()
    log(f"{what} ({len(tensors)} f32 tensors, {nbytes / 1e6:.1f} MB, chunk maps of "
        f"{min(maps)}-{max(maps)} chunks) put, spilled, fetched and read back bit-exact "
        f"through a {chunks + 8}-chunk arena, every store and load equal bit for bit to "
        f"the plain scatter and gather; active bytes 0 after drop")
    return (dict(leaves=len(tensors), bytes=nbytes, chunks_per_leaf=[min(maps), max(maps)]),
            back, dict(arena=arena.buf, cmap=largest_map, leaf=largest))


def offload_copy_times(probe: dict, card: str) -> dict:
    """6c's copy kernels timed as phase 5 times them, at the offload path's
    largest chunk map in its f32 arena (the embedding's first moment),
    after the path's launch counts are read: these launches compare and
    time, they are not the path's."""
    arena, cmap = probe["arena"], probe["cmap"]
    times = copy_times(arena, cmap)
    for name, t in times.items():
        log(f"phase 6c: {name} at {probe['leaf']}'s {cmap.numel()} f32 chunks "
            f"({cmap.numel() * arena.shape[1] * 4 / 1e6:.1f} MB) on {card}: "
            f"{t['ms']:.5f} ms device ({t['call_ms']:.5f} per call), bound {t['bound_ms']:.5f} "
            f"ms ({100 * t['bound_ms'] / t['ms']:.1f} %), plain {t['plain_ms']:.5f}, library "
            f"{t['library_ms']:.5f}")
    return dict(leaf=probe["leaf"], chunks=cmap.numel(), card=card, **times)


def train_path(card: str) -> dict:
    """Phase 6 with the launch counts zeroed before it and read after."""
    from repro_torch.kernels import ops

    torch.cuda.empty_cache()  # peaks below count from the training path's own blocks
    ops.reset_launch_counts()
    rels = train_parity()
    build_dir = ROOT / "build"
    build_dir.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build_dir, prefix="ckpt-") as workdir:
        result, state, timing, graph = supervised_training(Path(workdir), card)
    from repro_torch.tree import flatten_with_path

    offload, _, probe = offload_roundtrip(dict(flatten_with_path(state.opt.mu)),
                                          "phase 6c: the trained first moments")
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    log(f"phase 6: kernel launches on the training path {counts}")
    assert counts["stitch_gather"] > 0 and counts["stitch_scatter"] > 0, counts
    offload["copy_times"] = offload_copy_times(probe, card)
    return dict(counts=counts, parity_rel=rels, timing=timing, graph=graph, offload=offload,
                steps=result["steps"], losses=[h["loss"] for h in result["history"]],
                first_loss=result["first_loss"],
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


def family_batch(cfg, rng, n_batch: int, n_text: int, device,
                 n_frames: int = None) -> dict:
    """Seeded prompt tokens; for the vlm family patch embeddings, for the
    audio family ``n_frames`` frame embeddings (``SMOKE_FRAMES`` by
    default)."""
    from repro_torch.models.api import family_of

    batch = {"tokens": torch.from_numpy(
        rng.integers(0, cfg.vocab, size=(n_batch, n_text)).astype(np.int32))}
    if hasattr(cfg, "n_patches"):
        batch["patch_embeds"] = torch.from_numpy(rng.standard_normal(
            (n_batch, cfg.n_patches, cfg.d_model)).astype(np.float32))
    if family_of(cfg).name == "audio":
        batch["frames"] = torch.from_numpy(rng.standard_normal(
            (n_batch, n_frames or SMOKE_FRAMES, cfg.d_model)).astype(np.float32))
    return {k: v.to(device) for k, v in batch.items()}


def family_cache(cfg, batch: dict, max_len: int, device) -> dict:
    """The family's empty cache for ``batch`` (the audio family's also sized
    to the batch's frames)."""
    from repro_torch.models.api import family_of

    fam = family_of(cfg)
    n = batch["tokens"].shape[0]
    if fam.name == "audio":
        return fam.init_cache(cfg, n, max_len, batch["frames"].shape[1], device)
    return fam.init_cache(cfg, n, max_len, device)


def family_smoke(archs, n_pos: int, what: str) -> dict:
    """Each architecture's smoke config (float32) on the card and on the CPU
    from the same seeded weights: prefill of 2 x ``n_pos`` positions (the
    vlm family's patches counted, the audio family beside its frames), then
    ``FAMILY_DECODE_STEPS`` decode steps; logits within ``FAMILY_RTOL`` of
    each row's largest value and the same argmax."""
    from repro_torch.configs import get_arch
    from repro_torch.models.api import family_of

    rows = {}
    for arch in archs:
        cfg = get_arch(arch).smoke
        fam = family_of(cfg)
        logits = {}
        for dev in (DEVICE, "cpu"):
            rng = np.random.default_rng(8)
            params = fam.init_params(cfg, torch.Generator().manual_seed(0), dev)
            batch = family_batch(cfg, rng, 2, n_pos - getattr(cfg, "n_patches", 0), dev)
            out, cache = fam.prefill(cfg, params, batch, family_cache(cfg, batch, 40, dev))
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
    log(f"{what}: smoke configs, prefill of 2 x {n_pos} positions + {FAMILY_DECODE_STEPS} decode "
        f"steps, card vs CPU in float32, logits within {FAMILY_RTOL} of each row's largest "
        f"value and argmax equal: {rows}")
    return rows


def stitched_vs_dense(k_all: torch.Tensor, v_all: torch.Tensor, n: int, n_heads: int, rng,
                      what: str):
    """Write each layer's dense K/V ``(L, B, S, KVH, D)`` (the first ``n``
    tokens of every sequence) into a ``StitchedKVCache`` at its geometry and
    hold stitched decode attention (the kernel) to the plain dense path
    (``dense_plain``) on every layer, row-scaled (``attn_close``). Returns
    (max abs error, chunk tokens)."""
    from repro_torch.core.kvcache import KVCacheConfig, StitchedKVCache

    import dataclasses

    n_layers, b, _, n_kv, dh = k_all.shape
    kcfg = KVCacheConfig(n_layers=n_layers, n_kv=n_kv, head_dim=dh, dtype=k_all.dtype,
                         device=DEVICE)
    per_seq = -(-n // kcfg.chunk_tokens)
    kv = StitchedKVCache(dataclasses.replace(kcfg, n_chunks=n_layers * b * 2 * per_seq + 8))
    rids = list(range(b))
    for rid in rids:
        kv.add_sequence(rid, n)
    q = rand(rng, (b, n_heads, dh), k_all.dtype)
    err = 0.0
    for layer in range(n_layers):
        for rid in rids:
            kv.write_tokens(rid, layer, "k", 0, k_all[layer, rid, :n])
            kv.write_tokens(rid, layer, "v", 0, v_all[layer, rid, :n])
        got = kv.decode_attention(rids, layer, q)
        want = dense_plain(q[:, None], k_all[layer], v_all[layer], ints([n] * b))[:, 0]
        err = max(err, attn_close(got, want, (what, layer)))
    return err, kv.config.chunk_tokens


def paligemma_full(rng, card: str) -> dict:
    """8d: paligemma-3b at full width cut to ``PALI_LAYERS`` layers: prefill
    of ``PALI_BATCH`` sequences of 256 seeded patch embeddings and
    ``PALI_TEXT`` tokens, ``PALI_DECODE`` decode steps, every logit finite;
    then its K/V written into a stitched KV cache at its geometry (MQA, D
    256, 4096 tokens a chunk) and stitched decode attention held to the
    dense path on every layer (row-scaled 2e-2)."""
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.models import paligemma

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

    err, chunk_tokens = stitched_vs_dense(cache["k"], cache["v"], n, cfg.n_heads, rng,
                                          "paligemma lake")
    log(f"phase 8d: {cfg.name} at full width ({cfg.n_layers} layers, d_model {cfg.d_model}, "
        f"{cfg.n_heads}/{cfg.n_kv} heads of {cfg.dh}, vocab {cfg.vocab}, bf16) on {card}: "
        f"init {init_s} s; prefill of {PALI_BATCH} x ({cfg.n_patches} patches + {PALI_TEXT} "
        f"tokens) and {PALI_DECODE} decode steps in {run_s} s, every logit finite; stitched "
        f"attention == dense on {cfg.n_layers} layers (chunk_tokens "
        f"{chunk_tokens}), max abs err {err:.3g}")
    return dict(init_s=init_s, run_s=run_s, tokens=n, attn_err=err, chunk_tokens=chunk_tokens)


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
    # phase 10b reuses the weights: they wait on the host, so phases 8d and
    # 9 measure their peaks without them
    from repro_torch.tree import tree_map

    host_params = tree_map(lambda t: t.cpu(), params)
    del params
    torch.cuda.empty_cache()
    ops.reset_launch_counts()
    smoke = family_smoke(FAMILY_ARCHS, 31, "phase 8d")
    pali = paligemma_full(rng, card)
    torch.cuda.synchronize()
    fam_counts = ops.launch_counts()
    assert fam_counts["stitched_decode_attention"] > 0, fam_counts
    wall = round(time.perf_counter() - t_phase, 3)
    log(f"phase 8: wall time {wall} s")
    return dict(counts=counts, family_counts=fam_counts, served=served, lake=lake_row,
                layer=layer, smoke=smoke, paligemma=pali, wall_s=wall,
                host_params=host_params)


# ---------------------------------------------------------------------------
# phase 9: the hybrid, ssm and audio families
# ---------------------------------------------------------------------------


def new_family_smoke() -> dict:
    """9a: the smoke configs card vs CPU in float32, prefill + decode, then
    each trained ``PARITY_STEPS`` steps on both from the same seed and
    batches (losses within ``TRAIN_LOSS_RTOL``)."""
    from repro_torch.configs import get_arch

    rows = family_smoke(NEW_FAMILY_ARCHS, NEW_SMOKE_POS, "phase 9a")
    for arch in NEW_FAMILY_ARCHS:
        rows[arch]["train_rel"] = loss_curves(get_arch(arch).smoke, TRAIN_LOSS_RTOL,
                                              f"phase 9a: {arch} float32 smoke-config")
    return rows


def layer_config(arch: str):
    """The full config cut to one layer (a stack each for whisper), float32,
    with a 256-token vocabulary: the layer's widths are the full config's."""
    import dataclasses

    from repro_torch.configs import get_arch

    cfg = get_arch(arch).full
    over = dict(n_layers=1, vocab=256, dtype=torch.float32, remat=False)
    if hasattr(cfg, "max_positions"):
        over["max_positions"] = 256
    return dataclasses.replace(cfg, **over)


def card_vs_cpu(run, what: str) -> float:
    """``run(device)`` (a list of tensors) on the card and on the CPU: each
    within ``FAMILY_RTOL`` of its last-axis rows' largest |value|. Returns
    the worst share."""
    with torch.no_grad():
        card = [t.cpu() for t in run(DEVICE)]
        cpu = run("cpu")
    rel = 0.0
    for i, (a, b) in enumerate(zip(card, cpu, strict=True)):
        assert a.shape == b.shape and torch.isfinite(a).all(), (what, i)
        rel = max(rel, rel_rows(a, b))
    assert rel <= FAMILY_RTOL, (what, rel)
    return rel


def full_width_layers() -> dict:
    """9b: one full-width layer of each new mixer, card vs CPU in float32 on
    2 x ``LAYER_POS`` seeded inputs: zamba2's mamba2 mixer (output, final
    SSM and conv state, then ``LAYER_STEPS`` decode steps from them);
    rwkv6's time-mix and channel-mix (output, final WKV state, then
    ``LAYER_STEPS`` single-token steps from it); one whisper decoder layer
    (self-attention, cross-attention over ``FULL_FRAMES`` frames, MLP; its
    self- and cross-K/V)."""
    from repro_torch.models import mamba2 as M2
    from repro_torch.models import rwkv6, whisper

    rng = np.random.default_rng(11)

    def seeded(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))

    def on(tree, dev):
        return {k: on(v, dev) if isinstance(v, dict) else v.to(dev) for k, v in tree.items()}

    rows = {}
    zcfg = layer_config("zamba2-1.2b").mamba
    zp = {k: v[0] for k, v in M2.block_init(zcfg, torch.Generator().manual_seed(0), 1,
                                            torch.float32, "cpu").items()}
    x, xs = seeded(2, LAYER_POS, zcfg.d_model), seeded(LAYER_STEPS, 2, zcfg.d_model)

    def mamba(dev):
        p = on(zp, dev)
        y, hs, conv = M2.apply_block_with_state(zcfg, p, x.to(dev))
        out, st = [y, hs, conv], {"ssm": hs, "conv": conv}
        for t in range(LAYER_STEPS):
            o, st = M2.decode_block(zcfg, p, st, xs[t].to(dev))
            out += [o, st["ssm"]]
        return out

    t0 = time.perf_counter()
    rows["zamba2 mamba2 mixer"] = dict(rel=card_vs_cpu(mamba, "9b mamba2"),
                                       heads=zcfg.n_heads, chunk=zcfg.chunk)
    rcfg = layer_config("rwkv6-7b")
    rp = rwkv6.init_params(rcfg, torch.Generator().manual_seed(0), "cpu")["layers"]
    rp = {g: {k: v[0] for k, v in rp[g].items()} for g in ("tm", "cm")}
    x, xs = seeded(2, LAYER_POS, rcfg.d_model), seeded(LAYER_STEPS, 2, rcfg.d_model)

    def rwkv(dev):
        tm, cm = on(rp["tm"], dev), on(rp["cm"], dev)
        xd = x.to(dev)
        y, S = rwkv6.time_mix_with_state(rcfg, tm, xd)
        out, prev = [y, S, rwkv6.channel_mix(rcfg, cm, xd)], xd[:, -1]
        for t in range(LAYER_STEPS):
            xt = xs[t].to(dev)
            o, S = rwkv6._tm_step(rcfg, tm, xt, prev, S)
            out += [o, S, rwkv6._cm_step(rcfg, cm, xt, prev)]
            prev = xt
        return out

    rows["rwkv6 time-mix + channel-mix"] = dict(rel=card_vs_cpu(rwkv, "9b rwkv6"),
                                                heads=rcfg.n_heads, chunk=rcfg.chunk)
    wcfg = layer_config("whisper-medium")
    wp = whisper.init_params(wcfg, torch.Generator().manual_seed(0), "cpu")["decoder"]
    wp = whisper._stack(wp, ("ln1", "self_attn", "ln_x", "cross_attn", "ln2", "mlp"), 1)[0]
    x, memory = seeded(2, LAYER_POS, wcfg.d_model), seeded(2, FULL_FRAMES, wcfg.d_model)

    def decoder_layer(dev):
        h, (k, v), (xk, xv) = whisper._dec_layer(wcfg, on(wp, dev), x.to(dev), memory.to(dev))
        return [h, k, v, xk, xv]

    rows["whisper decoder layer"] = dict(rel=card_vs_cpu(decoder_layer, "9b whisper"),
                                         frames=FULL_FRAMES)
    log(f"phase 9b: one full-width layer of each new mixer on 2 x {LAYER_POS} seeded inputs "
        f"(+ {LAYER_STEPS} steps), card vs CPU in float32, every output and state within "
        f"{FAMILY_RTOL} of each row's largest value: {rows} ({time.perf_counter() - t0:.1f} s)")
    return rows


def decode_step_bytes(arch: str, cfg, params, cache, length: int) -> int:
    """The bytes one decode step must move at ``length`` tokens: every
    weight it reads once (an embedding used as the logits head whole, a
    table only looked up by row not at all), the shared block once per
    application (zamba2), the recurrent state read and written, and the
    K/V a sequence has (self, and whisper's static cross-K/V) read once."""
    from repro_torch.tree import leaves

    def nbytes(tree):
        return sum(t.numel() * t.element_size() for t in leaves(tree))

    b = cache["length"].numel()
    if arch == "zamba2-1.2b":
        kv = 2 * cfg.n_apps * b * length * cfg.n_kv * cfg.dh * cfg.dtype.itemsize
        return (nbytes(params) + (cfg.n_apps - 1) * nbytes(params["shared"])
                + 2 * nbytes({k: cache[k] for k in ("ssm", "conv")}) + kv)
    if arch == "rwkv6-7b":
        return (nbytes(params) - nbytes(params["embed"])
                + 2 * nbytes({k: cache[k] for k in ("wkv", "x_tm", "x_cm")}))
    dec = params["decoder"]
    kv = 2 * cfg.n_layers * b * length * cfg.n_kv * cfg.dh * cfg.dtype.itemsize
    return nbytes(dec) - nbytes(dec["pos"]) + nbytes({k: cache[k] for k in ("xk", "xv")}) + kv


def decode_from(arch, cfg, params, cache, tokens) -> torch.Tensor:
    """``tokens`` (steps, B) decoded from ``cache`` (updated in place);
    returns the stacked logits."""
    from repro_torch.models.api import family_of

    fam = family_of(cfg)
    out = []
    for tok in tokens:
        logits, cache = fam.decode_step(cfg, params, cache, tok)
        out.append(logits)
    return torch.stack(out)


def full_width_family(arch: str, rng, card: str) -> dict:
    """9c: ``arch`` at full width and depth in bf16: seeded weights, prefill
    of ``FULL_BATCH`` sequences, ``FULL_DECODE`` greedy decode steps, every
    logit finite and the lengths right; init and prefill seconds, steady
    decode ms/step (host clock after synchronize, first step left out)
    beside its byte bound, peak allocated. Then 9d on the same caches:
    zamba2's and whisper's self-K/V through a stitched KV cache (kernel vs
    dense on every application or layer); rwkv6's WKV state through the
    offload arena and decoded ``STATE_DECODE`` steps from there and from the
    state that never left, logits equal bit for bit."""
    from repro_torch.configs import get_arch
    from repro_torch.models.api import family_of
    from repro_torch.tree import leaves

    cfg = get_arch(arch).full
    fam = family_of(cfg)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = fam.init_params(cfg, torch.Generator().manual_seed(0), DEVICE)
    init_s = sync_s(t0)
    n_tok = FULL_PROMPT[arch]
    batch = family_batch(cfg, np.random.default_rng(10), FULL_BATCH, n_tok, DEVICE,
                         n_frames=FULL_FRAMES)
    cache = family_cache(cfg, batch, n_tok + FULL_DECODE + STATE_DECODE, DEVICE)
    t0 = time.perf_counter()
    out, cache = fam.prefill(cfg, params, batch, cache)
    prefill_s = sync_s(t0)
    finite = bool(torch.isfinite(out).all())
    tok = out[:, -1].argmax(-1).int()
    step_s = []
    for _ in range(FULL_DECODE):
        t0 = time.perf_counter()
        out, cache = fam.decode_step(cfg, params, cache, tok)
        tok = out.argmax(-1).int()
        finite &= bool(torch.isfinite(out).all())
        step_s.append(time.perf_counter() - t0)
    n = n_tok + FULL_DECODE
    assert finite and cache["length"].tolist() == [n] * FULL_BATCH, (arch, cache["length"])
    step_ms = statistics.median(step_s[1:]) * 1e3
    step_bytes = decode_step_bytes(arch, cfg, params, cache, n)
    bound_ms = step_bytes / HBM_BYTES_PER_S * 1e3
    weight_bytes = sum(t.numel() * t.element_size() for t in leaves(params))
    row = dict(init_s=init_s, prefill_s=prefill_s, prompt=n_tok, decode_steps=FULL_DECODE,
               decode_ms=step_ms, decode_bound_ms=bound_ms, step_bytes=step_bytes,
               weight_bytes=weight_bytes,
               peak_allocated_bytes=torch.cuda.max_memory_allocated())
    what = f"{arch} prompt {n_tok}" + (f" + {FULL_FRAMES} frames" if "frames" in batch else "")
    log(f"phase 9c: {cfg.name} at full width and depth (bf16, {weight_bytes / 1e9:.2f} GB of "
        f"weights) on {card}: init {init_s} s, prefill of {FULL_BATCH} x ({what}) "
        f"{prefill_s} s, {FULL_DECODE} decode steps, every logit finite; steady decode "
        f"{step_ms:.3f} ms/step against a {bound_ms:.3f} ms byte bound "
        f"({step_bytes / 1e9:.3f} GB at 3.35 TB/s); peak allocated "
        f"{row['peak_allocated_bytes'] / 2**30:.3f} GiB")

    if arch == "rwkv6-7b":
        summary, back, _ = offload_roundtrip({"wkv": cache["wkv"]},
                                             f"phase 9d: {arch}'s WKV state")
        moved = dict(cache, wkv=back["wkv"])
        kept = {k: v.clone() for k, v in cache.items()}
        toks = ints(rng.integers(0, cfg.vocab, size=(STATE_DECODE, FULL_BATCH)))
        a = decode_from(arch, cfg, params, moved, toks)
        b = decode_from(arch, cfg, params, kept, toks)
        assert same_bits(a, b), "decoding from the fetched state differs"
        row["offload"] = summary
        log(f"phase 9d: {STATE_DECODE} decode steps from the state fetched back equal bit for "
            f"bit to those from the state that never left")
    else:
        err, chunk_tokens = stitched_vs_dense(cache["k"], cache["v"], n, cfg.n_heads, rng,
                                              f"{arch} lake")
        row.update(attn_err=err, chunk_tokens=chunk_tokens, kv_layers=cache["k"].shape[0])
        log(f"phase 9d: {arch}'s self-attention K/V ({cache['k'].shape[0]} "
            f"{'applications' if arch.startswith('zamba2') else 'layers'} x {FULL_BATCH} x "
            f"{n} tokens, {cfg.n_heads}/{cfg.n_kv} heads of {cfg.dh}) through a stitched KV "
            f"cache (chunk_tokens {chunk_tokens}): stitched attention == dense on each, max "
            f"abs err {err:.3g}")
    del params, cache
    return row


def train_new_families(card: str, sees_replays: bool) -> dict:
    """9e: zamba2-1.2b and whisper-medium at full width trained through
    ``repro_torch.launch.train`` on the graphed step (bf16, remat on): every
    loss finite and within one bf16 rounding of the eager step's on the same
    steps, no restart, one capture; the launcher run's ms/step (host clock
    between steps, which end with the loss read back; the warm-up and
    capture steps left out) and peak memory; then the graphed step timed by
    ``measure`` (no eager turn: the eager step's figures are PERF.md's, and
    ``sees_replays`` is 6b's profiler verdict). rwkv6-7b is left out
    (``NEW_TRAIN_ARCHS``)."""
    from repro_torch.configs import get_arch
    from repro_torch.launch import train
    from repro_torch.train import optimizer as opt
    from repro_torch.train.step import make_train_step

    rows = {}
    build_dir = ROOT / "build"
    build_dir.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build_dir, prefix="ckpt-9e-") as workdir:
        for arch in NEW_TRAIN_ARCHS:
            torch.cuda.empty_cache()
            args = train.parse_args(["--arch", arch, *NEW_TRAIN_ARGS, "--ckpt-dir",
                                     str(Path(workdir) / arch)])
            cfg = get_arch(arch).full
            eager = eager_losses(cfg, args)
            stamps = []
            result, state = train.run(args, fail_injector=lambda _: stamps.append(
                time.perf_counter()))
            stamps.append(time.perf_counter())
            assert [e for e in result["events"] if e["kind"] != "straggler"] == [], \
                result["events"]
            assert (result["signatures"], result["graphs"]) == (1, 1), result
            losses = [h["loss"] for h in result["history"]]
            assert len(losses) == args.steps and all(math.isfinite(x) for x in losses), losses
            held = hold_losses(losses, eager, f"phase 9e: {arch}")
            step_ms = [1e3 * (b - a) for a, b in zip(stamps, stamps[1:])]
            rows[arch] = dict(losses=losses, eager_losses=eager,
                              ms_per_step=statistics.median(step_ms[2:]),
                              warm_up_ms=step_ms[0], capture_ms=step_ms[1],
                              tokens_per_s=result["tokens_per_s"],
                              peak_allocated_bytes=result["peak_allocated_bytes"],
                              peak_reserved_bytes=result["peak_reserved_bytes"])
            log(f"phase 9e: {arch} at full width (bf16, remat on, batch {args.batch}, seq "
                f"{args.seq}) on {card}: {args.steps} supervised steps on the graphed step, no "
                f"restart, losses {[round(x, 4) for x in losses]}, within {held['max_rel']:.3g} "
                f"of the eager step's (bit-equal {held['bit_equal']}), "
                f"{rows[arch]['ms_per_step']:.1f} ms/step (warm-up {step_ms[0]:.1f}, capture "
                f"and first replay {step_ms[1]:.1f}), peak allocated "
                f"{result['peak_allocated_bytes'] / 2**30:.3f} GiB, reserved "
                f"{result['peak_reserved_bytes'] / 2**30:.3f} GiB")
            step_fn = make_train_step(cfg, opt.AdamWConfig(lr=args.lr))
            state, timing = graph_turns(step_fn, state, launcher_data(cfg, args).batch_at,
                                        args.steps, ("graph",))
            rows[arch]["turns"] = graph_line(f"9e {arch}", card, timing, held, sees_replays,
                                             arch=arch)
            del state
    log("phase 9e: rwkv6-7b is not trained: its f32 AdamW moments (56 GB), bf16 weights "
        "(14 GB) and gradients (14 GB) exceed the card's 80 GB")
    return rows


def new_families(card: str, rng, sees_replays: bool) -> dict:
    """Phase 9. 9a-9b use no kernel; the launch counts are zeroed before 9c
    and read after 9d, and every kernel must have launched. 9e takes 6b's
    profiler verdict, ``sees_replays``."""
    from repro_torch.kernels import ops

    t_phase = time.perf_counter()
    smoke = new_family_smoke()
    layers = full_width_layers()
    torch.cuda.empty_cache()
    ops.reset_launch_counts()
    full = {arch: full_width_family(arch, rng, card) for arch in NEW_FAMILY_ARCHS}
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    log(f"phase 9d: kernel launches on the new families' path {counts}")
    assert all(n > 0 for n in counts.values()), counts
    trained = train_new_families(card, sees_replays)
    wall = round(time.perf_counter() - t_phase, 3)
    log(f"phase 9: wall time {wall} s")
    return dict(counts=counts, smoke=smoke, layers=layers, full=full, train=trained,
                wall_s=wall)


# ---------------------------------------------------------------------------
# phase 10: parallelism on a one-rank mesh
# ---------------------------------------------------------------------------


def parallel_line(leg: str, card: str, row: dict) -> None:
    print(json.dumps({"parallel": {"leg": leg, "card": card, **row}}, default=str))


def sharded_training(card: str, trained: dict) -> dict:
    """10a: phase 6b's run cut to ``PAR_STEPS`` steps through the launcher's
    sharded path (``--model-parallel 2``, a (1, 1) mesh on one rank), on the
    graphed step, then the graphed sharded step timed and profiled by
    ``measure`` (no eager turn: the eager step's figures are PERF.md's, and
    the profiler's verdict is 6b's), beside 6b's turns."""
    from torch.distributed.tensor import DTensor

    from repro_torch.configs import get_arch
    from repro_torch.launch import train
    from repro_torch.parallel import sharding as S
    from repro_torch.train import optimizer as opt
    from repro_torch.train.step import make_train_step, state_axes
    from repro_torch.tree import flatten_with_path, leaves

    build_dir = ROOT / "build"
    build_dir.mkdir(exist_ok=True)
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(dir=build_dir, prefix="ckpt-par-") as workdir:
        args = train.parse_args(TRAIN_ARGS + ["--steps", str(PAR_STEPS), "--model-parallel", "2",
                                              "--ckpt-dir", workdir])
        result, state = train.run(args)
    entry = get_arch(args.arch)
    cfg = entry.smoke if args.smoke else entry.full
    mesh = leaves(state)[0].device_mesh
    assert result["mesh"] == {"shape": [1, 1], "names": ["data", "model"]}, result["mesh"]
    assert (result["signatures"], result["graphs"]) == (1, 1), result
    rules = S.make_rules(mesh, kind="train", seq_parallel=False)
    want = S.tree_shardings(state, state_axes(cfg), rules, mesh, zero=entry.zero)
    for (path, leaf), sh in zip(flatten_with_path(state), leaves(want), strict=True):
        assert isinstance(leaf, DTensor) and leaf.device_mesh == mesh, path
        assert tuple(leaf.placements) == sh.placements, (path, leaf.placements, sh.placements)
    losses = [h["loss"] for h in result["history"]]
    plain = trained["losses"][:PAR_STEPS]
    held = hold_losses(losses, plain, "phase 10a")
    n_leaves = len(leaves(state))
    # steady state, measured as 6b's: the sharded step on placed batches
    step_fn = make_train_step(cfg, opt.AdamWConfig(lr=args.lr), S.make_sharder(mesh, rules))
    data = launcher_data(cfg, args)

    def batch_at(step):
        batch = data.batch_at(step)
        return S.place_tree(batch, S.batch_shardings(batch, rules, mesh))

    state, timing = graph_turns(step_fn, state, batch_at, args.steps, ("graph",))
    turns = graph_line("10a", card, timing, held, trained["graph"]["profiler_sees_replays"],
                       arch=cfg.name)
    row = dict(arch=cfg.name, mesh=result["mesh"], world=result["world"],
               backend=result["backend"], fallbacks=result["fallbacks"], steps=result["steps"],
               graphs=result["graphs"], losses=losses, plain_losses=plain, **held,
               graph=turns["graph"][0],
               phase6b=dict(eager=trained["graph"]["eager"][0],
                            graph=trained["graph"]["graph"][0]))
    log(f"phase 10a: {cfg.name} on the sharded launcher path, mesh {result['mesh']['shape']} "
        f"({result['backend']}), {n_leaves} DTensor leaves with the rules' "
        f"placements, {result['graphs']} capture; losses {['%.6f' % x for x in losses]} vs "
        f"6b's {['%.6f' % x for x in plain]} (max rel {row['max_rel']:.3g}, bit-equal "
        f"{row['bit_equal']}); "
        f"steady state on {card}: sharded graphed {row['graph']['ms_per_step']:.3f} ms/step "
        f"(6b eager {row['phase6b']['eager']['ms_per_step']:.3f} / graphed "
        f"{row['phase6b']['graph']['ms_per_step']:.3f}); fallbacks {result['fallbacks']}")
    del state
    torch.cuda.empty_cache()
    return row


def a2a_dbrx(card: str, host_params) -> dict:
    """10b: dbrx-132b cut to ``DBRX_LAYERS``, one loss and the router and
    expert gradients through ``moe_apply_a2a`` on the one-rank mesh with
    ZeRO-3 expert weights, against the global dispatch."""
    import dataclasses

    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import moe
    from repro_torch.parallel import sharding as S
    from repro_torch.tree import tree_map

    cfg = dbrx_config()
    assert cfg.a2a_dispatch
    mesh = make_host_mesh(model=2, device=DEVICE)
    sharder = S.make_sharder(mesh, S.make_rules(mesh, kind="train"), zero_params=True)
    t0 = time.perf_counter()
    params = tree_map(lambda t: t.to(DEVICE), host_params)
    to_card_s = sync_s(t0)
    keys = sorted(params["layers"]["mlp"])
    tokens = {"tokens": torch.from_numpy(np.random.default_rng(PAR_MOE_SEED).integers(
        0, cfg.vocab, (PAR_MOE_BATCH, PAR_MOE_SEQ))).to(DEVICE)}
    routed = []
    dispatch = moe.dispatch

    def recorded(cfg_, router, xf):
        r, dest, buf = dispatch(cfg_, router, xf)
        routed.append((r.topi, r.order, r.kept))
        return r, dest, buf

    def loss_and_grads(c, shard):
        mlp = {k: v.detach().requires_grad_(True) for k, v in params["layers"]["mlp"].items()}
        p = dict(params, layers=dict(params["layers"], mlp=mlp))
        t = time.perf_counter()
        loss = moe.loss_fn(c, p, tokens, sharder=shard)
        grads = torch.autograd.grad(loss, [mlp[k] for k in keys])
        return float(loss), dict(zip(keys, grads)), sync_s(t)

    moe.dispatch = recorded
    try:
        loss_a2a, g_a2a, a2a_s = loss_and_grads(cfg, sharder)
        n_a2a = len(routed)
        loss_g, g_glob, glob_s = loss_and_grads(dataclasses.replace(cfg, a2a_dispatch=False),
                                                lambda x, names: x)
    finally:
        moe.dispatch = dispatch
    assert n_a2a > 0 and len(routed) == 2 * n_a2a, (n_a2a, len(routed))
    dropped = []
    for (ti_a, or_a, k_a), (ti_g, or_g, k_g) in zip(routed[:n_a2a], routed[n_a2a:]):
        assert torch.equal(ti_a, ti_g) and torch.equal(or_a, or_g), "a2a routing differs"
        assert torch.equal(k_a, k_g), "a2a dropped slots differ"
        dropped.append(int((~k_g).sum()))
    loss_rel = abs(loss_a2a - loss_g) / abs(loss_g)
    assert loss_rel <= PAR_MOE_LOSS_RTOL, (loss_a2a, loss_g)
    grad_rel = {}
    for k in keys:
        a, g = g_a2a[k], g_glob[k]
        worst = 0.0
        for i in range(a.shape[0]):  # a layer at a time: f32 rows of one layer at once
            err = (a[i].float() - g[i].float()).abs().amax(-1)
            worst = max(worst, float((err / g[i].float().abs().amax(-1).clamp_min(1e-30)).max()))
        grad_rel[k] = worst
        assert worst <= PAR_MOE_GRAD_TOL, (k, worst)
    row = dict(arch=cfg.name, layers=cfg.n_layers, batch=PAR_MOE_BATCH, seq=PAR_MOE_SEQ,
               mesh=list(mesh.shape), zero_axis="data", loss_a2a=loss_a2a, loss_global=loss_g,
               loss_rel=loss_rel, bit_equal_loss=loss_a2a == loss_g, grad_rel=grad_rel,
               dispatches=n_a2a, dropped=dropped, a2a_s=a2a_s, global_s=glob_s,
               to_card_s=to_card_s, peak_allocated_bytes=torch.cuda.max_memory_allocated())
    log(f"phase 10b: {cfg.name} at full width ({cfg.n_layers} layers), batch {PAR_MOE_BATCH} x "
        f"seq {PAR_MOE_SEQ}, one loss and gradient through moe_apply_a2a on mesh "
        f"{list(mesh.shape)} with ZeRO-3 weights vs the global dispatch: routing and dropped "
        f"slots equal in all {n_a2a} dispatches (dropped {dropped}), loss {loss_a2a:.6f} vs "
        f"{loss_g:.6f} (rel {loss_rel:.3g}), gradients within {max(grad_rel.values()):.3g} of "
        f"each row's largest value ({grad_rel}); a2a {a2a_s} s, global {glob_s} s; weights "
        f"back on the card in {to_card_s} s")
    del params, g_a2a, g_glob
    torch.cuda.empty_cache()
    return row


def collectives_on_card(card: str) -> dict:
    """10c: compressed_psum, the ring matmul and GPipe on the one-rank group."""
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.parallel.collectives import compressed_psum, ring_layer_matmul
    from repro_torch.parallel.pipeline import pipeline_forward, split_stages

    rng = np.random.default_rng(PSUM_SEED)
    g = rand(rng, PSUM_SHAPE, torch.float32)
    residual, acc = torch.zeros_like(g), torch.zeros_like(g)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(PSUM_STEPS):
        mean, residual = compressed_psum(g, residual)
        acc += mean
    psum_ms = sync_s(t0) * 1e3 / PSUM_STEPS
    # one rank: the exact mean is the gradient itself
    psum_err = float((acc / PSUM_STEPS - g).abs().max() / g.abs().max())
    assert psum_err < 0.05, psum_err
    x, w = rand(rng, RING_X, torch.float32), rand(rng, RING_W, torch.float32)
    ring_err = max_err(ring_layer_matmul(x, w), x @ w) / float((x @ w).abs().max())
    assert ring_err <= PAR_TOL, ring_err
    d = PIPE_MB[-1]
    ws = rand(rng, (PIPE_LAYERS, d, d), torch.float32) / math.sqrt(d)
    xs = rand(rng, (PIPE_MICRO,) + PIPE_MB, torch.float32)

    def stage_fn(stage_ws, h):
        for wl in stage_ws:
            h = torch.tanh(h @ wl)
        return h

    pod = init_device_mesh(DEVICE, (1,), mesh_dim_names=("pod",))
    t0 = time.perf_counter()
    ys = pipeline_forward(stage_fn, split_stages(ws, 1), xs, pod, "pod")
    pipe_s = sync_s(t0)
    dense = stage_fn(ws, xs)
    pipe_err = max_err(ys, dense) / float(dense.abs().max())
    assert pipe_err <= PAR_TOL, pipe_err
    row = dict(psum_shape=list(PSUM_SHAPE), psum_steps=PSUM_STEPS, psum_err=psum_err,
               psum_ms_per_step=psum_ms, ring_shapes=[list(RING_X), list(RING_W)],
               ring_rel=ring_err, pipeline_layers=PIPE_LAYERS, pipeline_micro=PIPE_MICRO,
               pipeline_rel=pipe_err, pipeline_s=pipe_s)
    log(f"phase 10c: compressed_psum {PSUM_STEPS} steps on {PSUM_SHAPE} f32, time-averaged "
        f"error {psum_err:.3g} (limit 0.05), {psum_ms:.3f} ms a step; ring matmul "
        f"{RING_X} @ {RING_W} within {ring_err:.3g} of the dense product; GPipe "
        f"{PIPE_LAYERS} layers x {PIPE_MICRO} microbatches of {PIPE_MB} within {pipe_err:.3g}")
    return row


def parallel(card: str, trained: dict, host_params) -> dict:
    """Phase 10, on a one-rank process group started here and destroyed at
    the end; no check in it is caught."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import ensure_process_group

    t0 = time.perf_counter()
    backend = ensure_process_group(DEVICE)
    rows = {"10a": sharded_training(card, trained)}
    parallel_line("10a", card, rows["10a"])
    torch.cuda.reset_peak_memory_stats()
    rows["10b"] = a2a_dbrx(card, host_params)
    parallel_line("10b", card, rows["10b"])
    rows["10c"] = collectives_on_card(card)
    parallel_line("10c", card, rows["10c"])
    dist.destroy_process_group()
    log(f"phase 10: {backend} group of one rank; wall time {time.perf_counter() - t0:.1f} s")
    return rows


# ---------------------------------------------------------------------------
# phase 11: the dry run and its cost model
# ---------------------------------------------------------------------------


def validate_one_rank(card: str) -> list:
    """11a: ``validate`` for each of ``DRYRUN_VALIDATE``."""
    from repro_torch.launch import dryrun as D

    rows = []
    for arch, batch, seq in DRYRUN_VALIDATE:
        torch.cuda.empty_cache()
        v = D.validate(arch, batch, seq, DEVICE)
        other = v["measured_before_bytes"] - v["card_argument_bytes"]
        step_peak = v["measured_peak_bytes"] - other
        rel = v["predicted_peak_bytes"] / v["measured_peak_bytes"] - 1.0
        step_rel = v["predicted_peak_bytes"] / step_peak - 1.0
        v.update(peak_rel=rel, step_peak_bytes=step_peak, step_peak_rel=step_rel)
        gib = {k: round(b / 2**30, 4) for k, b in v["predicted_split"].items()}
        log(f"phase 11a: {arch} ({batch} x {seq}, one rank) on {card}: predicted peak "
            f"{v['predicted_peak_bytes'] / 2**30:.4f} GiB ({gib}; set in "
            f"{v['peak_phase']}), measured max_memory_allocated "
            f"{v['measured_peak_bytes'] / 2**30:.4f} GiB ({100 * rel:+.2f} %), the step's own "
            f"{step_peak / 2**30:.4f} GiB ({100 * step_rel:+.2f} %; "
            f"{other / 2**30:.4f} GiB held before it besides its arguments); FLOPs meta "
            f"{v['meta_flops']:.6e} vs card {v['card_flops']:.6e}; roofline lower bound "
            f"{v['bound_ms']:.3f} ms ({v['bound_by']}) beside {v['device_busy_ms']:.3f} ms "
            f"device-busy")
        assert abs(rel) <= DRYRUN_PEAK_RTOL and abs(step_rel) <= DRYRUN_PEAK_RTOL, (arch, v)
        assert v["card_flops"] == v["meta_flops"], (arch, v["card_flops"], v["meta_flops"])
        rows.append(v)
    return rows


def production_cells() -> dict:
    """11b: the dry run's command line for ``DRYRUN_ARCH`` on pod16x16 (a
    fake group of 256 ranks, meta tensors), then the one-rank matmul count
    at train_4k's global batch."""
    from repro_torch.configs import SHAPES, get_arch
    from repro_torch.configs.shapes import token_batch_specs
    from repro_torch.launch import dryrun as D

    build_dir = ROOT / "build"
    build_dir.mkdir(exist_ok=True)
    cells = {}
    with tempfile.TemporaryDirectory(dir=build_dir, prefix="dryrun-") as out:
        for shape in DRYRUN_SHAPES:
            assert D.main(["--arch", DRYRUN_ARCH, "--shape", shape, "--out", out]) == 0, shape
            rec = json.loads((Path(out) / "pod16x16" / f"{DRYRUN_ARCH}__{shape}.json")
                             .read_text())
            cells[shape] = rec
    want = {s: ("skip" if s == "long_500k" else "ok") for s in DRYRUN_SHAPES}
    assert {s: r["status"] for s, r in cells.items()} == want, cells
    got = cells["decode_32k"]["memory_analysis"]["argument_size_in_bytes"]
    assert got == SMOLLM_DECODE_ARGS, got
    entry = get_arch(DRYRUN_ARCH)
    t0 = time.perf_counter()
    one = D.trace_one_rank(entry.full, token_batch_specs(entry.full, SHAPES["train_4k"]),
                           D._adamw_for(entry), entry.microbatches)
    one_s = time.perf_counter() - t0
    per_dev = cells["train_4k"]["dot_flops_per_device"]
    dot_rel = per_dev * cells["train_4k"]["n_devices"] / one["dot_flops_per_device"] - 1.0
    assert abs(dot_rel) <= DOT_FLOPS_RTOL, (per_dev, one["dot_flops_per_device"])
    for shape, r in cells.items():
        if r["status"] == "ok":
            log(f"phase 11b: {DRYRUN_ARCH} x {shape} x pod16x16: traced in {r['trace_s']} s, "
                f"arguments {r['memory_analysis']['argument_size_in_bytes']} B, peak "
                f"{r['peak_memory_per_device'] / 2**30:.3f} GiB, {r['flops_per_device']:.4e} "
                f"FLOPs, {r['bytes_per_device']:.4e} B, collectives "
                f"{r['collective_bytes_per_device']:.4e} B/device; bound "
                f"{r['roofline']['bottleneck']}")
        else:
            log(f"phase 11b: {DRYRUN_ARCH} x {shape}: {r['status']} ({r.get('reason')})")
    log(f"phase 11b: train_4k matmul FLOPs {per_dev:.6e} a device x 256 against "
        f"{one['dot_flops_per_device']:.6e} on one rank ({dot_rel:+.2e}; traced in "
        f"{one_s:.1f} s)")
    keep = ("status", "memory_analysis", "peak_memory_per_device", "memory_split",
            "flops_per_device", "dot_flops_per_device", "bytes_per_device", "collectives",
            "collective_bytes_per_device", "model_flops", "n_devices", "trace_s", "roofline",
            "reason")
    return {"cells": {s: {k: r[k] for k in keep if k in r} for s, r in cells.items()},
            "one_rank_dot_flops": one["dot_flops_per_device"], "dot_rel": dot_rel,
            "one_rank_trace_s": one_s}


def dryrun(card: str) -> dict:
    """Phase 11: 11a on the card, 11b on the host; no group is left."""
    import torch.distributed as dist

    t0 = time.perf_counter()
    row = {"card": card, "validate": validate_one_rank(card)}
    row.update(production_cells())
    assert not dist.is_initialized()
    row["wall_s"] = round(time.perf_counter() - t0, 3)
    log(f"phase 11: wall time {row['wall_s']} s")
    return row


# ---------------------------------------------------------------------------
# phase 12: the engine-trace recorder
# ---------------------------------------------------------------------------


def record_traces(card: str) -> dict:
    """Phase 12: ``record`` and ``record_multitenant`` of
    ``examples/record_engine_trace_torch.py`` on the card, each trace held
    event for event and in decode steps to its checked-in recording (so a
    failure says where they part), then saved under a temporary directory in
    ``build/`` and held byte for byte to it. The engine decodes on its dense
    cache (through the decode attention kernel) and drives the stitched KV
    cache for accounting only: the counts, zeroed before, are reported, and
    the attention kernel's must be above 0."""
    from repro_torch.core.trace import load_trace
    from repro_torch.kernels import ops

    sys.path.insert(0, str(ROOT / "examples"))
    import record_engine_trace_torch as recorder

    build_dir = ROOT / "build"
    build_dir.mkdir(exist_ok=True)
    torch.cuda.empty_cache()
    ops.reset_launch_counts()
    rows = {}
    with tempfile.TemporaryDirectory(dir=build_dir, prefix="traces-") as out:
        for scenario, name in recorder.FILE_NAMES.items():
            record = recorder.record if scenario == "default" else recorder.record_multitenant
            t0 = time.perf_counter()
            trace = record(device=DEVICE)
            wall = sync_s(t0)
            golden = ROOT / "tests" / "data" / name
            want = load_trace(golden)
            got_ev, want_ev = trace_events(trace), trace_events(want)
            part = next((i for i, (a, b) in enumerate(zip(got_ev, want_ev)) if a != b),
                        min(len(got_ev), len(want_ev)))
            assert got_ev == want_ev, (scenario, len(got_ev), len(want_ev), part,
                                       got_ev[part:part + 3], want_ev[part:part + 3])
            steps = trace.meta["decode_steps"]
            assert steps == want.meta["decode_steps"], (scenario, steps, want.meta)
            path = Path(out) / name
            trace.save(path)
            assert path.read_bytes() == golden.read_bytes(), (scenario, trace.meta, want.meta)
            rows[scenario] = dict(events=len(got_ev), allocs=trace.n_allocs,
                                  decode_steps=steps, wall_s=wall)
            log(f"phase 12: {scenario} trace on {card}: {len(got_ev)} events "
                f"({trace.n_allocs} allocs, mean {trace.mean_alloc_mb:.1f} MB), {steps} decode "
                f"steps in {wall} s, byte-identical to tests/data/{name}")
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    log(f"phase 12: kernel launches on the recorder's path {counts} (its engine decodes on "
        f"the dense cache, through the attention kernel)")
    assert counts["stitched_decode_attention"] > 0, counts
    return dict(card=card, counts=counts, **rows)


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
    dense_route = check_dense_route(rng)

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
    fams = new_families(card, rng, trained["graph"]["profiler_sees_replays"])
    parallel(card, trained, moe.pop("host_params"))
    dry = dryrun(card)
    record = record_traces(card)
    # phase 5's last row, timed after phase 11: the side streams its plain
    # and library yardsticks warm up keep workspaces that would otherwise
    # count in 11a's process peak
    chat = dense_route_times(rng)
    log(f"phase 5: dense route at the chat shape (B={chat['B']}, {chat['tokens']} tokens, "
        f"H/KVH/D {chat['H']}/{chat['KVH']}/{chat['D']}, bf16): kernel {chat['ms']:.5f} ms "
        f"({chat['call_ms']:.5f} ms per call), plain {chat['plain_ms']:.5f} ms, "
        f"scaled_dot_product_attention {chat['library_ms']:.5f} ms, bound "
        f"{chat['bound_ms']:.5f} ms ({chat['bound_by']}), "
        f"{100 * chat['bound_ms'] / chat['ms']:.1f} % of bound")
    for row in rows:  # launches stays the serving path's count, at the timed shapes
        row["launches_by_path"] = {"serve": row["launches"],
                                   "train": trained["counts"][row["name"]],
                                   "kill_recover": kr["counts"][row["name"]],
                                   "moe": moe["counts"][row["name"]],
                                   "families": moe["family_counts"][row["name"]],
                                   "new_families": fams["counts"][row["name"]],
                                   "record": record["counts"][row["name"]]}
    print(json.dumps({"attention_shapes": shapes, "new_geometries": geometries,
                      "dense_route": dense_route, "dense_route_chat": chat}))
    print(json.dumps({"training": {k: v for k, v in trained.items() if k != "counts"}}))
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"kill_recover": {k: v for k, v in kr.items() if k != "counts"}}))
    print(json.dumps({"moe": {k: v for k, v in moe.items()
                              if k not in ("counts", "family_counts", "host_params")}},
                     default=str))
    print(json.dumps({"new_families": {k: v for k, v in fams.items() if k != "counts"}},
                     default=str))
    print(json.dumps({"dryrun": dry}, default=str))
    print(json.dumps({"record_engine_trace": record}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Dry run: trace every (arch x shape x mesh) cell at full width on a fake
production mesh, with no memory allocated on any device, and record the
per-device memory, FLOPs, bytes and collective traffic with the H100
roofline as JSON under ``artifacts/dryrun_torch/<mesh>/``.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch smollm-135m --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod]

Counterpart of ``repro.launch.dryrun``, with its rules, sharder,
``tree_shardings``, ``batch_shardings``, ``state_axes``, ZeRO settings,
microbatches, moment dtype and ``long_500k`` decode rules. Where the
reference lowers and compiles on 512 forced host devices, this traces the
step eagerly: a ``DeviceMesh`` of the production shape, (16, 16) or
(2, 16, 16), on a ``fake`` process group of 256 or 512 ranks, whose state
and inputs are DTensors with local shards on the ``meta`` device (shapes
and dtypes, no memory). ``utils.opstats`` counts the ops rank 0 runs on
its own shards. The group is started in ``run_cell`` and destroyed after
it, never at import.

Each record has the reference's keys except ``xla_cost_analysis``,
``hlo_bytes``, ``lower_s`` and ``generated_code_size_in_bytes``, which
have no counterpart; ``trace_s`` stands in ``compile_s``'s place:
  * ``memory_analysis.argument_size_in_bytes``: exact, summed from
    ``Sharding.shard_shape`` over every argument leaf;
  * ``memory_analysis.temp_size_in_bytes``: the high-water mark of the live
    bytes the step allocates beyond its arguments (``opstats``);
  * ``flops_per_device`` (with ``dot_flops_per_device``), ``bytes_per_device``
    (eager operand + result bytes: an upper bound), ``collectives``,
    ``model_flops``, ``n_devices`` and ``roofline`` on the H100's datasheet
    constants (``utils.roofline``).

``validate`` runs the one-rank train step of ``launch/train.py`` for real
on the card and returns the prediction beside the measurement.
"""

from __future__ import annotations

import argparse
import json
import math
import time
import traceback
from pathlib import Path
from typing import Any, Dict

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from ..configs import ARCHS, get_arch
from ..configs.shapes import (SHAPES, ShapeSpec, cache_specs, decode_token_specs,
                              supports_long_context, token_batch_specs)
from ..device import DeviceLike, resolve_device
from ..models.api import family_of, param_shapes
from ..parallel.sharding import (Sharding, batch_shardings, make_rules, make_sharder,
                                 place_tree, taken_sites, tree_shardings)
from ..train import optimizer as opt
from ..train.step import TrainState, init_state, make_serve_steps, make_train_step, state_axes
from ..tree import leaves, tree_map
from ..utils import opstats
from ..utils.roofline import RooflineReport, model_flops
from .mesh import make_production_mesh

ARTIFACTS = Path(__file__).resolve().parents[3] / "artifacts" / "dryrun_torch"


def _adamw_for(entry) -> opt.AdamWConfig:
    dt = torch.bfloat16 if entry.opt_dtype == "bfloat16" else torch.float32
    return opt.AdamWConfig(moment_dtype=dt)


def _shard_bytes(tree, shardings) -> int:
    """Bytes of each rank's blocks of ``tree`` laid out by ``shardings``."""
    return sum(math.prod(sh.shard_shape(t.shape)) * t.element_size()
               for t, sh in zip(leaves(tree), leaves(shardings), strict=True))


def _local_bytes(tree) -> int:
    """Bytes of this rank's shards of every tensor in ``tree``."""
    total = 0
    for t in leaves(tree):
        if isinstance(t, torch.Tensor):
            local = t.to_local() if isinstance(t, DTensor) else t
            total += local.numel() * local.element_size()
    return total


def trace_train(entry, cfg, shape: ShapeSpec, mesh) -> Dict[str, Any]:
    rules = make_rules(mesh, kind="train", seq_parallel=entry.seq_parallel,
                       pure_dp=entry.pure_dp)
    sharder = make_sharder(mesh, rules, zero_params=entry.zero_params)
    adamw = _adamw_for(entry)
    step_fn = make_train_step(cfg, adamw, sharder, microbatches=entry.microbatches)

    params = param_shapes(cfg)
    state = TrainState(params=params, opt=opt.init(adamw, params),
                       step=torch.zeros((), dtype=torch.int32, device="meta"))
    axes = state_axes(cfg)
    repl = Sharding(mesh, ())
    param_sh = tree_shardings(state.params, axes.params, rules, mesh, zero=entry.zero_params)
    fallbacks = list(tree_shardings.last_fallbacks)
    state_sh = TrainState(
        params=param_sh,
        opt=opt.OptState(
            mu=tree_shardings(state.opt.mu, axes.opt.mu, rules, mesh, zero=entry.zero),
            nu=tree_shardings(state.opt.nu, axes.opt.nu, rules, mesh, zero=entry.zero),
            count=repl,
        ),
        step=repl,
    )
    batch = token_batch_specs(cfg, shape)
    batch_sh = batch_shardings(batch, rules, mesh)
    split = {"params": _shard_bytes(state.params, param_sh),
             "moments": _shard_bytes((state.opt.mu, state.opt.nu),
                                     (state_sh.opt.mu, state_sh.opt.nu)),
             "inputs": _shard_bytes(batch, batch_sh)}
    split["scalars"] = 8  # the int32 step and moment count
    args = (place_tree(state, state_sh), place_tree(batch, batch_sh))
    return dict(fn=step_fn, args=args, split=split, fallbacks=fallbacks)


def trace_prefill(entry, cfg, shape: ShapeSpec, mesh) -> Dict[str, Any]:
    rules = make_rules(mesh, kind="prefill", seq_parallel=entry.seq_parallel,
                       pure_dp=entry.pure_dp)
    sharder = make_sharder(mesh, rules, zero_params=entry.zero_params)
    fam = family_of(cfg)
    prefill_fn, _ = make_serve_steps(cfg, sharder)

    params = param_shapes(cfg)
    param_sh = tree_shardings(params, fam.param_axes(cfg), rules, mesh,
                              zero=entry.zero_params)
    fallbacks = list(tree_shardings.last_fallbacks)
    batch = token_batch_specs(cfg, shape)
    batch_sh = batch_shardings(batch, rules, mesh)
    cache = cache_specs(cfg, shape)
    dec_rules = make_rules(mesh, kind="decode", long_context=shape.name == "long_500k")
    cache_sh = tree_shardings(cache, fam.cache_axes(cfg), dec_rules, mesh)
    split = {"params": _shard_bytes(params, param_sh), "inputs": _shard_bytes(batch, batch_sh),
             "cache": _shard_bytes(cache, cache_sh)}
    args = (place_tree(params, param_sh), place_tree(batch, batch_sh),
            place_tree(cache, cache_sh))
    return dict(fn=prefill_fn, args=args, split=split, fallbacks=fallbacks)


def trace_decode(entry, cfg, shape: ShapeSpec, mesh) -> Dict[str, Any]:
    rules = make_rules(mesh, kind="decode", long_context=shape.name == "long_500k",
                       pure_dp=entry.pure_dp)
    sharder = make_sharder(mesh, rules, zero_params=entry.zero_params)
    fam = family_of(cfg)
    _, decode_fn = make_serve_steps(cfg, sharder)

    params = param_shapes(cfg)
    param_sh = tree_shardings(params, fam.param_axes(cfg), rules, mesh,
                              zero=entry.zero_params)
    fallbacks = list(tree_shardings.last_fallbacks)
    cache = cache_specs(cfg, shape)
    cache_sh = tree_shardings(cache, fam.cache_axes(cfg), rules, mesh)
    fallbacks += tree_shardings.last_fallbacks
    toks = decode_token_specs(shape)
    tok_sh = batch_shardings({"t": toks}, rules, mesh)["t"]
    split = {"params": _shard_bytes(params, param_sh), "cache": _shard_bytes(cache, cache_sh),
             "inputs": _shard_bytes(toks, tok_sh)}
    args = (place_tree(params, param_sh), place_tree(cache, cache_sh),
            place_tree(toks, tok_sh))
    return dict(fn=decode_fn, args=args, split=split, fallbacks=fallbacks)


TRACE = {"train": trace_train, "prefill": trace_prefill, "decode": trace_decode}


def fake_group(world: int) -> None:
    """A ``fake`` process group of ``world`` ranks, this process rank 0:
    collectives return at once and move nothing."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world)


def measure_step(fn, args, split: Dict[str, int]) -> Dict[str, Any]:
    """Run ``fn(*args)`` under ``opstats`` and turn its counts into the
    record's memory, FLOP, byte and collective fields. ``split`` is the
    argument bytes by part; ``memory_split`` adds the live bytes at the
    peak by when they were allocated."""
    counter = opstats.OpCounter()
    with counter:
        out = fn(*args)
    stats = counter.stats
    arg_bytes = sum(split.values())
    return {
        "memory_analysis": {"argument_size_in_bytes": arg_bytes,
                            "output_size_in_bytes": _local_bytes(out),
                            "temp_size_in_bytes": stats.temp_peak_bytes},
        "peak_memory_per_device": arg_bytes + stats.temp_peak_bytes,
        "memory_split": dict(split, **stats.temp_at_peak),
        "peak_phase": stats.peak_phase,
        "flops_per_device": stats.flops,
        "dot_flops_per_device": stats.dot_flops,
        "bytes_per_device": stats.traffic_bytes,
        "collectives": stats.collectives,
        "collective_bytes_per_device": stats.collective_bytes,
    }


def trace_cell(entry, cfg, shape: ShapeSpec, mesh) -> Dict[str, Any]:
    """Trace one cell on ``mesh`` (a group must be running): the record's
    memory, FLOP, byte, collective and fallback fields and ``trace_s``."""
    taken_sites(clear=True)
    t0 = time.time()
    cell = TRACE[shape.kind](entry, cfg, shape, mesh)
    record = measure_step(cell["fn"], cell["args"], cell["split"])
    record["trace_s"] = round(time.time() - t0, 2)
    record["fallbacks"] = cell["fallbacks"] + [f"site:{s}" for s in taken_sites(clear=True)]
    return record


def run_cell(arch_id: str, shape_name: str, multi_pod: bool) -> dict:
    """Trace one cell on a fake group of 256 (512 with ``multi_pod``) ranks,
    started here and destroyed before returning."""
    entry = get_arch(arch_id)
    cfg = entry.full
    shape = SHAPES[shape_name]
    mesh_name = "pod2x16x16" if multi_pod else "pod16x16"
    record = {"arch": arch_id, "shape": shape_name, "mesh": mesh_name, "kind": shape.kind,
              "status": "ok"}
    if shape_name == "long_500k" and not supports_long_context(cfg):
        record["status"] = "skip"
        record["reason"] = "pure full attention arch; long_500k needs sub-quadratic attention"
        return record

    fake_group(512 if multi_pod else 256)
    try:
        mesh = make_production_mesh(multi_pod=multi_pod, device="cpu")
        n_dev = mesh.size()
        record.update(trace_cell(entry, cfg, shape, mesh))
    finally:
        dist.destroy_process_group()
    record["model_flops"] = model_flops(cfg, shape.kind, shape.seq_len, shape.global_batch)
    record["n_devices"] = int(n_dev)
    rep = RooflineReport(
        arch=arch_id, shape=shape_name, mesh=mesh_name, kind=shape.kind,
        flops_per_device=record["flops_per_device"],
        bytes_per_device=record["bytes_per_device"],
        collective_bytes_per_device=record["collective_bytes_per_device"],
        model_flops=record["model_flops"], n_devices=int(n_dev),
        peak_memory_per_device=record["peak_memory_per_device"],
        collectives=record["collectives"],
    )
    record["roofline"] = {
        "t_compute": rep.t_compute, "t_memory": rep.t_memory,
        "t_collective": rep.t_collective, "bottleneck": rep.bottleneck,
        "useful_flops_fraction": rep.useful_flops_fraction,
        "roofline_fraction": rep.roofline_fraction,
    }
    return record


# ---------------------------------------------------------------------------
# one rank: the launcher's plain step, predicted on meta, measured on the card
# ---------------------------------------------------------------------------


def trace_one_rank(cfg, batch, adamw: opt.AdamWConfig, microbatches: int = 1) -> Dict[str, Any]:
    """The plain train step (no mesh, as ``launch/train.py`` runs one rank)
    on meta params, moments and a meta copy of ``batch``: the same record
    fields as ``measure_step`` gives a cell, and the argument bytes split."""
    params = param_shapes(cfg)
    state = TrainState(params=params, opt=opt.init(adamw, params),
                       step=torch.zeros((), dtype=torch.int32, device="meta"))
    batch = tree_map(lambda t: torch.empty_like(t, device="meta"), batch)
    split = {"params": _local_bytes(params), "moments": _local_bytes((state.opt.mu, state.opt.nu)),
             "inputs": _local_bytes(batch), "scalars": _local_bytes((state.opt.count, state.step))}
    step_fn = make_train_step(cfg, adamw, microbatches=microbatches)
    return measure_step(step_fn, (state, batch), split)


def validate(arch_id: str, batch: int = 8, seq: int = 256,
             device: DeviceLike = "cuda") -> Dict[str, Any]:
    """The one-rank train step of ``launch/train.py`` (the full config,
    f32 moments, one microbatch, the pipeline's batches) predicted on meta
    tensors and run for real on ``device``: one warm-up step, then one step
    for the peak memory allocated (``torch.cuda.max_memory_allocated``,
    beside what was allocated before it and the step's own arguments),
    one under ``opstats`` for the FLOPs, and one under ``torch.profiler``
    for the device-busy time. Runs on the card unless asked for the CPU,
    where only the prediction and the FLOPs are compared."""
    from ..data.pipeline import DataConfig, SyntheticTokens

    dev = resolve_device(device)
    cfg = get_arch(arch_id).full
    fam = family_of(cfg)
    adamw = opt.AdamWConfig()
    data = SyntheticTokens(DataConfig(
        vocab=cfg.vocab, seq_len=seq, global_batch=batch, seed=0,
        patch_dim=cfg.d_model if fam.name == "vlm" else None,
        frame_dim=cfg.d_model if fam.name == "audio" else None), dev)
    batches = [data.batch_at(i) for i in range(4)]
    t0 = time.time()
    pred = trace_one_rank(cfg, batches[0], adamw)
    trace_s = time.time() - t0
    rep = RooflineReport(arch=arch_id, shape=f"{batch}x{seq}", mesh="one-rank", kind="train",
                         flops_per_device=pred["flops_per_device"],
                         bytes_per_device=pred["bytes_per_device"],
                         collective_bytes_per_device=0.0,
                         model_flops=model_flops(cfg, "train", seq, batch), n_devices=1)
    out = {"arch": arch_id, "batch": batch, "seq": seq, "device": str(dev),
           "predicted_peak_bytes": pred["peak_memory_per_device"],
           "predicted_argument_bytes": pred["memory_analysis"]["argument_size_in_bytes"],
           "predicted_temp_bytes": pred["memory_analysis"]["temp_size_in_bytes"],
           "predicted_split": pred["memory_split"], "peak_phase": pred["peak_phase"],
           "meta_flops": pred["flops_per_device"], "meta_dot_flops": pred["dot_flops_per_device"],
           "bound_ms": rep.step_time_lower_bound * 1e3, "bound_by": rep.bottleneck,
           "trace_s": trace_s}
    on_card = dev.type == "cuda"
    step_fn = make_train_step(cfg, adamw)
    state = init_state(cfg, adamw, torch.Generator().manual_seed(0), dev)
    state, _ = step_fn(state, batches[0])  # warm-up: the caching allocator fills
    if on_card:
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        before = torch.cuda.memory_allocated(dev)
        state, _ = step_fn(state, batches[1])
        torch.cuda.synchronize(dev)
        out.update(measured_peak_bytes=torch.cuda.max_memory_allocated(dev),
                   measured_before_bytes=before,
                   card_argument_bytes=_local_bytes((state, batches[1])))
    counter = opstats.OpCounter()
    with counter:
        state, _ = step_fn(state, batches[2])
    out.update(card_flops=counter.stats.flops, card_dot_flops=counter.stats.dot_flops,
               card_temp_bytes=counter.stats.temp_peak_bytes)
    if on_card:
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize(dev)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            state, _ = step_fn(state, batches[3])
            torch.cuda.synchronize(dev)
        out["device_busy_ms"] = opstats.device_busy_ms(prof)
    return out


# ---------------------------------------------------------------------------
# the command line
# ---------------------------------------------------------------------------


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", default=None, help="architecture id (default: all)")
    ap.add_argument("--shape", default=None, help="shape name (default: all)")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=str(ARTIFACTS))
    args = ap.parse_args(argv)

    out_dir = Path(args.out)
    archs = [args.arch] if args.arch else sorted(ARCHS)
    shapes = [args.shape] if args.shape else list(SHAPES)
    meshes = [False, True] if args.both_meshes else [args.multi_pod]

    n_ok = n_skip = n_fail = 0
    for multi_pod in meshes:
        mesh_name = "pod2x16x16" if multi_pod else "pod16x16"
        mdir = out_dir / mesh_name
        mdir.mkdir(parents=True, exist_ok=True)
        for arch_id in archs:
            for shape_name in shapes:
                tag = f"{arch_id} x {shape_name} x {mesh_name}"
                try:
                    rec = run_cell(arch_id, shape_name, multi_pod)
                except Exception:  # a failed cell is recorded; the others still run
                    rec = {"arch": arch_id, "shape": shape_name, "mesh": mesh_name,
                           "status": "fail", "error": traceback.format_exc()}
                (mdir / f"{arch_id}__{shape_name}.json").write_text(
                    json.dumps(rec, indent=2, default=str))
                if rec["status"] == "ok":
                    n_ok += 1
                    r = rec["roofline"]
                    print(f"OK   {tag}: trace={rec['trace_s']}s "
                          f"peak/dev={rec['peak_memory_per_device']:.3e}B "
                          f"flops/dev={rec['flops_per_device']:.3e} "
                          f"coll={rec['collective_bytes_per_device']:.3e}B "
                          f"bottleneck={r['bottleneck']} "
                          f"roofline={r['roofline_fraction']:.3f}", flush=True)
                elif rec["status"] == "skip":
                    n_skip += 1
                    print(f"SKIP {tag}: {rec['reason']}", flush=True)
                else:
                    n_fail += 1
                    print(f"FAIL {tag}:\n{rec['error']}", flush=True)
    print(f"\ndry-run summary: {n_ok} ok, {n_skip} skip, {n_fail} fail")
    return 1 if n_fail else 0


if __name__ == "__main__":
    raise SystemExit(main())

"""A training cell: the launcher's graphed train step on seeded batches.

Set-up builds the one train step that the window drives, as
``launch/train.py`` builds it without the supervisor and its checkpoints:
``GraphedStep(make_train_step(cfg, AdamWConfig(...)))`` over a
``TrainState`` of the benchmark's weights, zero moments and step 0. Its
first three calls (the eager warm-up, the capture and a replay) are the
first three steps, on distinct batches, and the program's readings are
taken from its own state: each step's loss, each leaf's first gradient
from the first moment after step 1 (its norm, and a seeded sample of its
elements), and each leaf's change after step 3 against the starting
weights, kept on the host meanwhile.
The window then replays the step on the cycled batches, synchronising
after each so the host clock reads the device's pace.

After the window the program's state is freed and the reference trains
the same three steps in float32 from the same weights and batches.
"""

from __future__ import annotations

import gc
import math
import time
from typing import Dict, List

import torch

from .. import compare, families, model, traffic, weights
from ..runtime import Context, Outcome, free, peaks, profiled, sync

PROGRAM_STEPS = 3
PROFILED_STEPS = 3


def optimizer(ctx: Context) -> Dict:
    return ctx.cell.traffic["optimizer"]


def build(ctx: Context):
    """(config, shapes, weights, train step, state, batches) on the device."""
    from repro_torch.train import optimizer as opt
    from repro_torch.train.graph import GraphedStep
    from repro_torch.train.step import TrainState, make_train_step

    cfg = model.port_config(ctx.cell.config)
    shapes = model.param_shapes(cfg)
    params = weights.draw(shapes, ctx.seed, ctx.device, ctx.cell.config["model"]["n_layers"])
    adamw = opt.AdamWConfig(**optimizer(ctx))
    state = TrainState(params=params, opt=opt.init(adamw, params),
                       step=torch.zeros((), dtype=torch.int32, device=ctx.device))
    step = GraphedStep(make_train_step(cfg, adamw), ctx.device)
    batches = traffic.train_batches(ctx.cell.traffic, ctx.cell.family, ctx.cell.config["model"],
                                    ctx.seed, ctx.device)
    return cfg, shapes, step, state, batches


#: elements a chunk when the change of a leaf is summed on the device
CHUNK = 1 << 24


def first_steps(ctx: Context, step, state, batches, initial: Dict[str, torch.Tensor]):
    """The first ``PROGRAM_STEPS`` calls of the train step and the
    program's readings; returns (state, readings). ``initial`` holds each
    leaf's starting value on the host. The readings allocate nothing of a
    leaf's size on the device, so they cannot raise the run's peak."""
    hp = optimizer(ctx)
    names = [n for n, _ in weights.leaves(state.params)]
    losses: List[float] = []
    first_grad: Dict[str, float] = {}
    sampled: Dict[str, torch.Tensor] = {}
    for i in range(PROGRAM_STEPS):
        state, met = step(state, batches[i])
        # what the step left in reference cycles goes now, not whenever the
        # collector happens to run, so the allocator's state repeats
        gc.collect()
        losses.append(float(met["loss"]))
        if i == 0:
            unscale = (1 - hp["b1"]) * min(1.0, hp["grad_clip"] / (float(met["grad_norm"]) + 1e-9))
            for n, mu in zip(names, [t for _, t in weights.leaves(state.opt.mu)]):
                first_grad[n] = float(torch.linalg.vector_norm(mu, dtype=torch.float32)) / unscale
                idx = weights.sample_index(n, mu.numel(), ctx.seed).to(mu.device)
                sampled[n] = (mu.reshape(-1)[idx].float() / unscale).cpu()
    change = {}
    for n, p in weights.leaves(state.params):
        flat, start = p.reshape(-1), initial[n].reshape(-1)
        total = torch.zeros((), dtype=torch.float64, device=p.device)
        for a in range(0, flat.numel(), CHUNK):
            d = flat[a:a + CHUNK].float() - start[a:a + CHUNK].to(p.device).float()
            total += d.square().sum(dtype=torch.float64)
        change[n] = float(total.sqrt())
    return state, {"losses": losses, "first_grad": first_grad, "grad_sample": sampled,
                   "change": change}


def reference_readings(ctx: Context, shapes, batches, precision: str) -> Dict:
    from reference.common import Precision
    from reference.train import run as ref_run

    w = weights.draw(shapes, ctx.seed, ctx.device, ctx.cell.config["model"]["n_layers"])
    index = {n: weights.sample_index(n, t.numel(), ctx.seed) for n, t in weights.leaves(w)}
    return ref_run(model.reference(ctx.cell.config), ctx.cell.config["model"], w,
                   batches[:PROGRAM_STEPS], optimizer(ctx), Precision(precision), index)


def run(ctx: Context) -> Outcome:
    mix, conf = ctx.cell.traffic, ctx.cell.config
    cfg, shapes, step, state, batches = build(ctx)
    initial = {n: p.to("cpu", copy=True) for n, p in weights.leaves(state.params)}
    state, prog = first_steps(ctx, step, state, batches, initial)
    del initial
    sync(ctx.device)
    setup_s = time.perf_counter() - ctx.t_start

    call = ctx.spans.wrap(step, "train.step", sync=ctx.device) if ctx.trace else step
    k = len(batches)
    losses = []
    i = PROGRAM_STEPS
    t0 = time.perf_counter()
    while True:
        state, met = call(state, batches[i % k])
        losses.append(met["loss"])
        i += 1
        sync(ctx.device)
        if time.perf_counter() - t0 >= ctx.seconds:
            break
    window_s = time.perf_counter() - t0
    n = len(losses)

    def traced() -> int:
        nonlocal state, i
        for _ in range(PROFILED_STEPS):
            state, _ = call(state, batches[i % k])
            i += 1
        return PROFILED_STEPS

    profile = profiled(ctx, traced)
    mem = peaks(ctx.device)
    failed = sum(not math.isfinite(float(v)) for v in losses)
    keep = batches[:PROGRAM_STEPS]
    del step, state, batches, call, losses
    free(ctx.device)

    ref = reference_readings(ctx, shapes, keep, "float32")
    readings = compare.train_readings(prog, ref)
    fam = families.of(ctx.cell.family)
    record = {
        "kind": "train",
        "setup_s": setup_s,
        "window_s": window_s,
        "steps": n,
        "positions": n * mix["batch"] * fam.positions_per_row(mix),
        "model_flops": n * fam.train_step_flops(conf["model"], mix),
        **mem,
    }
    return Outcome(record=record, checks=compare.checks(readings, ctx.cell.limits["limits"]),
                   attempted=n, failed=failed, profile=profile)

"""A serving cell: a closed loop of clients against the program's engine.

Set-up builds ``ServeEngine`` as ``launch/serve.py`` does, with the mix's
engine settings and the benchmark's weights, and has every client submit
its first request. Each client sends its next request when its last one
finishes, so as many requests are in the system as there are clients.
The engine is driven step by step (``ServeEngine.step``: admission with
one prefill per admitted request, then one batched decode). The warm-up
steps spread the admissions out and count as set-up; the window keeps the
same loop running for the run's seconds.

A request's first token is stamped at the end of the step that admitted
it (its prefill), its last at the end of the step that finished it; TPOT
is (last - first) / (tokens - 1). The engine's step is deterministic, so
the order of work depends on the seed only and the host clock only times
it.

After the window the engine is freed and the reference runs once over a
sample of the requests that finished in it, drawn from the seed with the
longest among them, and reads how far each served token's logit lies
below its best.
"""

from __future__ import annotations

import dataclasses
import time
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np
import torch

from .. import compare, families, flops, model, traffic, weights
from ..runtime import Context, Outcome, free, peaks, profiled, sync
from ..seeds import rng

PROFILED_STEPS = 40


class ClosedLoop:
    def __init__(self, eng, stream, clients: int):
        self.eng = eng
        self.stream = stream
        self.first: Dict[int, float] = {}
        self.last: Dict[int, float] = {}
        self.emitted = 0
        self.occupancy: List[float] = []
        for _ in range(clients):
            self.submit()

    def submit(self) -> None:
        prompt, max_new = next(self.stream)
        self.eng.submit(prompt, max_new=max_new)

    def step(self) -> None:
        eng = self.eng
        waiting = list(eng.waiting)
        done_before = len(eng.finished)
        eng.step()
        t = time.perf_counter()
        admitted = 0
        for r in waiting:
            if r.generated:
                self.first[r.req_id] = t
                admitted += 1
        finished = eng.finished[done_before:]
        decoded = len(eng.running) + len(finished)
        self.emitted += admitted + decoded
        self.occupancy.append(decoded / eng.ecfg.max_batch)
        for r in finished:
            self.last[r.req_id] = t
            self.submit()


def _engine(ctx: Context, cfg, params):
    from repro_torch.serve.engine import EngineConfig, ServeEngine

    e = ctx.cell.traffic["engine"]
    return ServeEngine(cfg, params, EngineConfig(
        max_batch=e["max_batch"], max_len=e["max_len"], n_chunks=e["n_chunks"],
        allocator=e["allocator"], device=ctx.device))


def _instrument(ctx: Context, eng, m: Dict, weight_bytes: int, record: Dict) -> None:
    """Spans around the engine's layers (``--trace 1`` only), and per
    decode step its least time and the model FLOPs of the window."""
    spans = ctx.spans
    fam = families.of(ctx.cell.family)
    eng._admit = spans.wrap(eng._admit, "engine.admit", sync=ctx.device)
    for name in ("add_sequence", "append_tokens", "free_sequence"):
        setattr(eng.kv, name, spans.wrap(getattr(eng.kv, name), f"kv.{name}"))
    decode = spans.wrap(eng.fam.decode_step, "engine.decode", sync=ctx.device)
    prefill = eng.fam.prefill

    def decode_step(cfg, params, cache, tokens, *a, **k):
        ctxs = [len(r.prompt) + len(r.generated) for r in eng.running.values()]
        record["decode_least_s"].append(flops.decode_step_least_s(fam, weight_bytes, m, ctxs))
        record["model_flops"] += sum(fam.decode_token_flops(m, c) for c in ctxs)
        return decode(cfg, params, cache, tokens, *a, **k)

    def prefill_step(cfg, params, batch, cache, *a, **k):
        record["model_flops"] += fam.prefill_flops(m, batch["tokens"].shape[1])
        return prefill(cfg, params, batch, cache, *a, **k)

    eng.fam = dataclasses.replace(eng.fam, decode_step=decode_step, prefill=prefill_step)


def sample(ctx: Context, reqs: List) -> List:
    """Requests for the reference: the one with the most served tokens,
    then others drawn from the seed until ``min_tokens`` served tokens or
    ``max_requests`` requests."""
    s = ctx.cell.traffic["sample"]
    if not reqs:
        return []
    longest = max(reqs, key=lambda r: (len(r.generated), -r.req_id))
    picked, tokens = [longest], len(longest.generated)
    others = [r for r in reqs if r is not longest]
    for i in rng(ctx.seed, "sample").permutation(len(others)):
        if tokens >= s["min_tokens"] or len(picked) >= s["max_requests"]:
            break
        picked.append(others[int(i)])
        tokens += len(others[int(i)].generated)
    return picked


def reference_gaps(ctx: Context, shapes, picked, precisions=("float32",)) -> Dict[str, float]:
    """The widest logit gap over the sample: for ``float32`` the served
    tokens' gap below the reference's best; for a lower precision (the
    control), the gap of the token that precision puts first."""
    from reference.common import Precision, exact_float32

    ref = model.reference(ctx.cell.config)
    m = ctx.cell.config["model"]
    w = weights.draw(shapes, ctx.seed, ctx.device)
    w32 = {}

    def f32(tree, out):
        for k, v in tree.items():
            if isinstance(v, dict):
                out[k] = f32(v, {})
            else:
                out[k] = v.float()
        return out

    f32(w, w32)
    del w
    widest = {p: 0.0 for p in precisions}
    with exact_float32():
        for r in picked:
            p = len(r.prompt)
            toks = np.concatenate([r.prompt, np.asarray(r.generated[:-1], np.int32)])
            toks = torch.as_tensor(toks, device=ctx.device)
            served = torch.as_tensor(r.generated, device=ctx.device).long()
            best = ref.logits(m, w32, toks, Precision("float32"))[p - 1:]
            top = best.max(-1).values
            for prec in precisions:
                if prec == "float32":
                    chosen = served
                else:
                    chosen = ref.logits(m, w32, toks, Precision(prec))[p - 1:].argmax(-1)
                gap = (top - best.gather(1, chosen[:, None])[:, 0]).max()
                widest[prec] = max(widest[prec], float(gap))
    return widest


@dataclass
class Served:
    """What the timed loop leaves for the check: the record the readers
    read, the sample for the reference and the counts of work."""

    record: Dict
    shapes: Dict
    picked: List
    attempted: int
    length_errors: int
    profile: Optional[Dict]


def serve(ctx: Context) -> Served:
    """Set-up, the window and the traced stretch; the program's state is
    freed before this returns."""
    mix, m = ctx.cell.traffic, ctx.cell.config["model"]
    cfg = model.port_config(ctx.cell.config)
    shapes = model.param_shapes(cfg)
    params = weights.draw(shapes, ctx.seed, ctx.device)
    eng = _engine(ctx, cfg, params)
    loop = ClosedLoop(eng, traffic.requests(mix, m["vocab"], ctx.seed), mix["clients"])
    for _ in range(mix["warmup_steps"]):
        loop.step()
    sync(ctx.device)
    setup_s = time.perf_counter() - ctx.t_start

    record = {"kind": "closed_loop", "decode_least_s": [], "model_flops": 0.0}
    if ctx.trace:
        _instrument(ctx, eng, m, weights.nbytes(params), record)
    emitted0, occ0, steps = loop.emitted, len(loop.occupancy), 0
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < ctx.seconds:
        loop.step()
        steps += 1
    sync(ctx.device)
    t1 = time.perf_counter()
    out_tokens = loop.emitted - emitted0
    occupancy = loop.occupancy[occ0:]
    window_spans = {k: list(v) for k, v in ctx.spans.durations.items()}
    least = list(record["decode_least_s"])
    window_flops = record["model_flops"]

    def traced() -> int:
        for _ in range(PROFILED_STEPS):
            loop.step()
        return PROFILED_STEPS

    profile = profiled(ctx, traced)
    mem = peaks(ctx.device)
    report = eng.memory_report()
    done = [r for r in eng.finished if t0 < loop.last[r.req_id] <= t1]
    tpot = [(loop.last[r.req_id] - loop.first[r.req_id]) / (len(r.generated) - 1)
            for r in done]
    length_errors = sum(len(r.generated) != r.max_new for r in done)
    picked = sample(ctx, done)
    del eng, loop, params
    free(ctx.device)

    record.update({
        "setup_s": setup_s,
        "window_s": t1 - t0,
        "steps": steps,
        "output_tokens": out_tokens,
        "tpot_s": tpot,
        "occupancy": occupancy,
        "window_spans": window_spans,
        "decode_least_s": least,
        "model_flops": window_flops,
        "lake_peak_active": report["peak_active"],
        "lake_peak_reserved": report["peak_reserved"],
        "sampled_tokens": sum(len(r.generated) for r in picked),
        **mem,
    })
    return Served(record=record, shapes=shapes, picked=picked, attempted=len(done),
                  length_errors=length_errors, profile=profile)


def judged(ctx: Context, served: Served, logit_gap: float) -> Outcome:
    readings = {"length_errors": float(served.length_errors), "logit_gap": logit_gap}
    return Outcome(record=served.record,
                   checks=compare.checks(readings, ctx.cell.limits["limits"]),
                   attempted=served.attempted, failed=served.length_errors,
                   profile=served.profile)


def run(ctx: Context) -> Outcome:
    served = serve(ctx)
    gaps = reference_gaps(ctx, served.shapes, served.picked) if served.picked else {}
    return judged(ctx, served, gaps.get("float32", float("nan")))

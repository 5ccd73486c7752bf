#!/usr/bin/env python3
"""Read the numbers that decide ``correct`` over many seeds, on the card,
at a cell's own size: the program's (the lower readings), the control's
(the float32 reference's twin in fp8, in the program's place) and a
planted fault's. The limits in ``cells/<workload>.json`` are set from
these readings; the benchmark's own runs never run this.

    python3 chipbench/calibrate.py --workload <name> --seeds 1,2,3 \
        [--control 4,5,6] [--fault half_batch --fault-seeds 7,8,9] [--seconds 8]

A training cell's readings need no window: each seed builds the train
step, runs its first three steps and frees it, then the reference (and
the control) trains the same steps. A serving cell's seed runs the
closed loop for ``--seconds`` after its warm-up, as a run does, and reads
the sample. One JSON line a reading, then a summary line.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
sys.path[:0] = [str(HERE), str(HERE.parent / "src")]


def seeds(text: str):
    return [int(s) for s in text.split(",") if s]


def main(argv=None, root: Path = HERE.parent, device: str = "cuda") -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=seeds, default=[])
    ap.add_argument("--control", type=seeds, default=[])
    ap.add_argument("--fault", default=None)
    ap.add_argument("--fault-seeds", type=seeds, default=[])
    ap.add_argument("--seconds", type=float, default=8.0)
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from harness import compare, env, faults, model, traffic
    from harness.kinds import closed_loop, train
    from harness.runtime import Context, free
    from harness.spec import Spec

    cell = Spec(root).cell(args.workload)
    if device == "cuda":
        env.require_cards(cell.chips)
        print(f"card: {env.card_line()}", flush=True)
    dev = torch.device(device)
    kind = cell.traffic["kind"]
    out = {"program": [], "control": [], "fault": []}

    def emit(role, seed, readings, **extra):
        line = {"role": role, "seed": seed, **readings, **extra}
        out[role].append(line)
        print(json.dumps(line), flush=True)

    for seed in sorted(set(args.seeds) | set(args.control) | set(args.fault_seeds)):
        ctx = Context(cell=cell, seed=seed, seconds=args.seconds, trace=False, device=dev,
                      t_start=time.perf_counter())
        if kind == "train":
            prog, planted = None, None
            if seed in args.seeds:
                prog = _program(ctx, train)
            if seed in args.fault_seeds:
                with faults.planted(args.fault, "train", cell.family):
                    planted = _program(ctx, train)
            cfg_shapes = model.param_shapes(model.port_config(cell.config))
            batches = traffic.train_batches(cell.traffic, cell.family, cell.config["model"],
                                            seed, dev)
            t = time.perf_counter()
            ref = train.reference_readings(ctx, cfg_shapes, batches, "float32")
            ref_s = time.perf_counter() - t
            if prog is not None:
                emit("program", seed, compare.train_readings(prog, ref), reference_s=ref_s,
                     worst=compare.worst_leaves(prog, ref))
            if planted is not None:
                emit("fault", seed, compare.train_readings(planted, ref), fault=args.fault,
                     worst=compare.worst_leaves(planted, ref))
            if seed in args.control:
                ctrl = train.reference_readings(ctx, cfg_shapes, batches, "fp8")
                emit("control", seed, compare.train_readings(ctrl, ref),
                     worst=compare.worst_leaves(ctrl, ref))
            del batches
            free(dev)
        else:
            if seed in args.seeds or seed in args.control:
                served = closed_loop.serve(ctx)
                control = ("fp8",) if seed in args.control else ()
                gaps = closed_loop.reference_gaps(ctx, served.shapes, served.picked,
                                                  ("float32",) + control)
                o = closed_loop.judged(ctx, served, gaps)
                rec = o.record
                readings = {n: v for n, v, _ in o.checks}
                extra = {"attempted": o.attempted, "sampled_tokens": rec["sampled_tokens"],
                         "output_tokens_per_s": rec["output_tokens"] / rec["window_s"],
                         "tpot_p95_ms": float(np.percentile(rec["tpot_s"], 95)) * 1e3,
                         "setup_s": rec["setup_s"]}
                if "undecided_share" in gaps:
                    extra["undecided_share"] = gaps["undecided_share"]
                if seed in args.seeds:
                    emit("program", seed, readings, **extra)
                if seed in args.control:
                    emit("control", seed, {"logit_gap": gaps["fp8"]}, **extra)
                free(dev)
            if seed in args.fault_seeds:
                with faults.planted(args.fault, "closed_loop", cell.family):
                    o = closed_loop.run(ctx)
                emit("fault", seed, {n: v for n, v, _ in o.checks}, fault=args.fault)
                free(dev)

    summary = {}
    for role, lines in out.items():
        for line in lines:
            for k, v in line.items():
                if isinstance(v, float) and k.endswith(("_gap", "_err", "_errors", "_share")):
                    lo, hi = summary.setdefault(role, {}).setdefault(k, [v, v])
                    summary[role][k] = [min(lo, v), max(hi, v)]
    print(json.dumps({"summary": summary, "seconds": time.perf_counter() - T_START}))
    return out


def _program(ctx, train):
    from harness.runtime import free

    cfg, shapes, step, state, batches = train.build(ctx)
    initial = {n: p.to("cpu", copy=True) for n, p in train.weights.leaves(state.params)}
    state, prog = train.first_steps(ctx, step, state, batches, initial)
    del cfg, step, state, batches
    free(ctx.device)
    return prog


if __name__ == "__main__":
    main()

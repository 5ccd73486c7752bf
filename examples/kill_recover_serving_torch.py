"""Run the kill/recover serving scenario on the PyTorch port.

Counterpart of ``kill_recover_serving.py``: a fixed-seed ``ServeEngine``
over a fault-injected device, where a mid-trace capacity shrink plus a
transient ``cuMemCreate`` failure burst exhausts the allocator's recovery
ladder, the ``Supervisor`` restores the last committed checkpoint onto the
engine's device, and ``load_state`` re-stitches the KV working set tight
on the shrunken device before the workload drains. Prints the summary as
JSON; runs on the card unless ``--device cpu``:

    PYTHONPATH=src python examples/kill_recover_serving_torch.py \
        [--backend gmlake] [--device cuda|cpu] [--out some/trace.json]

The recorded allocation trace is written only to an explicit ``--out``,
and never under ``tests/data/``: the checked-in trace there is the JAX
package's recording, which the port is held to.
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.serve.killrecover import KillRecoverConfig, run_scenario  # noqa: E402

PROTECTED = ROOT / "tests" / "data"


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--backend", default="gmlake",
                    choices=("gmlake", "caching", "ellm", "hybrid"))
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--out", default=None, help="write the allocation trace here")
    args = ap.parse_args(argv)
    out_path = Path(args.out).resolve() if args.out else None
    if out_path is not None and out_path.is_relative_to(PROTECTED.resolve()):
        ap.error(f"refusing to write under {PROTECTED}: the checked-in traces are the "
                 "reference's recordings")

    cfg = KillRecoverConfig.for_backend(args.backend, seed=args.seed)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as ckpt_dir:
        out = run_scenario(cfg, ckpt_dir, device=args.device)
    wall = time.perf_counter() - t0
    if not out["drained"] or out["finished"] != cfg.requests:
        raise RuntimeError(f"scenario did not finish: {out['finished']}/{cfg.requests} "
                           f"(drained={out['drained']})")
    trace = out["engine"].recorder.trace
    summary = {
        "backend": args.backend,
        "device": str(out["engine"].device),
        "finished": out["finished"],
        "requests": out["requests"],
        "restarts": [(e["step"], e["error"]) for e in out["events"] if e["kind"] == "restart"],
        "trace_events": len(trace.events),
        "wall_s": round(wall, 3),
        "memory_report": out["memory_report"],
    }
    if out_path is not None:
        rep = out["memory_report"]
        trace.meta.update(
            scenario="kill_recover", backend=args.backend, seed=args.seed,
            requests=cfg.requests, max_new=cfg.max_new, fault_call=cfg.fault_call,
            fail_burst=cfg.fail_burst, shrink_mb=cfg.shrink_mb, restarts=out["restarts"],
            recovery=rep["recovery_events"], injected=rep["injected_faults"],
        )
        out_path.parent.mkdir(parents=True, exist_ok=True)
        trace.save(out_path)
        summary["trace"] = str(out_path)
    print(json.dumps(summary, indent=2, default=str))
    return summary


if __name__ == "__main__":
    main()

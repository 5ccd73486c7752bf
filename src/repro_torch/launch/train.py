"""End-to-end training launcher.

    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-135m \
        [--smoke] [--steps 100] [--batch 8] [--seq 256] [--device cuda]

Counterpart of ``repro.launch.train``: the deterministic data pipeline,
the train step (AdamW, gradient accumulation, recomputation when the
config asks for it), async checkpointing and the fault-tolerant
supervisor, on one device. Runs on the card unless ``--device cpu``; on the
card the result also carries tokens/s and the peak memory allocated and
reserved by PyTorch's caching allocator. ``--smoke`` selects the reduced
config. No mesh or sharding is ported: ``--model-parallel`` must be 1.
"""

from __future__ import annotations

import argparse
import json
import logging
import time
from typing import Callable, Optional, Tuple

import torch

from ..ckpt.checkpoint import CheckpointManager
from ..configs import get_arch
from ..data.pipeline import DataConfig, SyntheticTokens
from ..device import resolve_device
from ..ft.supervisor import Supervisor, SupervisorConfig
from ..models.api import family_of
from ..train import optimizer as opt
from ..train.step import TrainState, init_state, make_train_step

log = logging.getLogger("repro_torch.train")


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true", help="use the reduced config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-dir", default="artifacts/ckpt")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--model-parallel", type=int, default=1)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    return ap.parse_args(argv)


def run(args: argparse.Namespace,
        fail_injector: Optional[Callable[[int], None]] = None,
        ckpt: Optional[CheckpointManager] = None) -> Tuple[dict, TrainState]:
    """Train ``args.steps`` supervised steps; returns (result, final state).
    ``ckpt`` replaces the manager built from ``--ckpt-dir``; ``fail_injector``
    is handed to ``Supervisor.run``."""
    if args.model_parallel != 1:
        raise NotImplementedError(
            "--model-parallel > 1 needs the parallelism port (ROADMAP queue A, parallelism); "
            "this trainer runs on one device")
    device = resolve_device(args.device)
    entry = get_arch(args.arch)
    cfg = entry.smoke if args.smoke else entry.full
    adamw = opt.AdamWConfig(lr=args.lr)
    state = init_state(cfg, adamw, torch.Generator().manual_seed(args.seed), device)
    step_fn = make_train_step(cfg, adamw, microbatches=args.microbatches)
    data = SyntheticTokens(DataConfig(
        vocab=cfg.vocab, seq_len=args.seq, global_batch=args.batch, seed=args.seed,
        patch_dim=cfg.d_model if family_of(cfg).name == "vlm" else None), device)
    ckpt = ckpt or CheckpointManager(args.ckpt_dir)
    sup = Supervisor(step_fn, data.batch_at, ckpt,
                     SupervisorConfig(checkpoint_every=args.ckpt_every), device=device)
    on_card = device.type == "cuda"
    if on_card:
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    t0 = time.time()
    state, history = sup.run(state, start_step=0, n_steps=args.steps,
                             fail_injector=fail_injector)
    if on_card:
        torch.cuda.synchronize(device)
    wall = time.time() - t0

    losses = [h["loss"] for h in history]
    result = {
        "arch": cfg.name,
        "steps": len(history),
        "first_loss": losses[0],
        "last_loss": losses[-1],
        "min_loss": min(losses),
        "wall_s": round(wall, 1),
        "steps_per_s": round(len(history) / wall, 3),
        "events": sup.events,
        "history": history,
    }
    if on_card:
        result.update(
            device=torch.cuda.get_device_name(device),
            tokens_per_s=round(sum(data.seq_len_for(h["step"]) for h in history)
                               * args.batch / wall, 1),
            peak_allocated_bytes=torch.cuda.max_memory_allocated(device),
            peak_reserved_bytes=torch.cuda.max_memory_reserved(device),
        )
    for h in history[:: max(1, args.log_every)]:
        log.info("step %5d loss %.4f", h["step"], h["loss"])
    return result, state


def main(argv=None) -> dict:
    result, _ = run(parse_args(argv))
    print(json.dumps({k: v for k, v in result.items() if k not in ("events", "history")},
                     indent=2))
    return result


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO)
    main()

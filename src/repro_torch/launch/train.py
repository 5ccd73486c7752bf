"""End-to-end training launcher.

    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-135m \
        [--smoke] [--steps 100] [--batch 8] [--seq 256] [--device cuda]

Counterpart of ``repro.launch.train``: the deterministic data pipeline,
the train step (AdamW, gradient accumulation, recomputation when the
config asks for it), async checkpointing and the fault-tolerant
supervisor. Runs on the card unless ``--device cpu``; on the card the
result also carries tokens/s and the peak memory allocated and reserved by
PyTorch's caching allocator. ``--smoke`` selects the reduced config.

Every step goes through ``train.graph.GraphedStep``, the counterpart of the
reference's ``jax.jit(step, donate_argnums=(0,))``: on the card the step is
captured in one CUDA graph per batch signature and replayed (``graphs`` in
the result counts the captures); with ``--device cpu`` the same body runs
eagerly on each call.

With ``--model-parallel`` above 1, or under ``torchrun`` (``WORLD_SIZE``
above 1), the step is sharded as the reference's: a ``(data, model)`` mesh
over every rank (``make_host_mesh``, the model axis clamped to the world:
on one rank ``--model-parallel 2`` gives a (1, 1) mesh), the train rules
without sequence parallelism, the state placed by ``tree_shardings`` with
the arch's ``zero``, and each rank reading its batch rows by
``batch_shardings``. Of the ``ArchEntry`` fields the launcher reads only
``zero``, as the reference's; ``zero_params``, ``seq_parallel``,
``microbatches``, ``opt_dtype`` and ``pure_dp`` are read by the dry run.
The result then adds the mesh, the world, the backend and ``fallbacks``:
the rules' divisibility fallbacks and the named places that gathered a
sharded dim. A single process with ``--model-parallel 1`` runs the plain
step, with no process group.

    torchrun --nproc-per-node 4 -m repro_torch.launch.train --arch smollm-135m \
        --smoke --model-parallel 2 --device cpu
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import time
from typing import Callable, Optional, Tuple

import torch
import torch.distributed as dist

from ..ckpt.checkpoint import CheckpointManager
from ..configs import get_arch
from ..data.pipeline import DataConfig, SyntheticTokens
from ..device import resolve_device
from ..ft.supervisor import Supervisor, SupervisorConfig
from ..models.api import family_of
from ..parallel.sharding import (batch_shardings, make_rules, make_sharder, place_tree,
                                 taken_sites, tree_shardings)
from ..train import optimizer as opt
from ..train.graph import GraphedStep
from ..train.step import TrainState, init_state, make_train_step, state_axes
from .mesh import make_host_mesh

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
    device = resolve_device(args.device)
    entry = get_arch(args.arch)
    cfg = entry.smoke if args.smoke else entry.full
    adamw = opt.AdamWConfig(lr=args.lr)
    fam = family_of(cfg)
    sharded = args.model_parallel > 1 or int(os.environ.get("WORLD_SIZE", "1")) > 1
    mesh = sharder = state_sh = None
    fallbacks = []
    if sharded:
        mesh = make_host_mesh(model=args.model_parallel, device=device)
        if device.type == "cuda":  # this rank's card, set when its group started
            device = torch.device("cuda", torch.cuda.current_device())
        rules = make_rules(mesh, kind="train", seq_parallel=False)
        sharder = make_sharder(mesh, rules)
    state = init_state(cfg, adamw, torch.Generator().manual_seed(args.seed), device)
    data = SyntheticTokens(DataConfig(
        vocab=cfg.vocab, seq_len=args.seq, global_batch=args.batch, seed=args.seed,
        patch_dim=cfg.d_model if fam.name == "vlm" else None,
        frame_dim=cfg.d_model if fam.name == "audio" else None), device)
    batch_at = data.batch_at
    if sharded:
        state_sh = tree_shardings(state, state_axes(cfg), rules, mesh, zero=entry.zero)
        fallbacks = list(tree_shardings.last_fallbacks)
        state = place_tree(state, state_sh)

        def batch_at(step):  # each rank keeps its own rows of the global batch
            batch = data.batch_at(step)
            return place_tree(batch, batch_shardings(batch, rules, mesh))

        taken_sites(clear=True)
    step_fn = GraphedStep(make_train_step(cfg, adamw, sharder, microbatches=args.microbatches),
                          device)
    ckpt = ckpt or CheckpointManager(args.ckpt_dir)
    sup = Supervisor(step_fn, batch_at, ckpt,
                     SupervisorConfig(checkpoint_every=args.ckpt_every), device=device,
                     state_shardings=state_sh)
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
        "signatures": step_fn.signatures,
        "graphs": step_fn.captured,
        "events": sup.events,
        "history": history,
    }
    if sharded:
        result.update(
            mesh={"shape": list(mesh.shape), "names": list(mesh.mesh_dim_names)},
            world=dist.get_world_size(),
            backend=dist.get_backend(),
            fallbacks=fallbacks + [f"site:{s}" for s in taken_sites()],
        )
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
    if not dist.is_initialized() or dist.get_rank() == 0:
        print(json.dumps({k: v for k, v in result.items() if k not in ("events", "history")},
                         indent=2))
    if dist.is_initialized():
        dist.destroy_process_group()
    return result


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO)
    main()

"""Pipeline parallelism: the GPipe microbatch schedule over a mesh axis.

Counterpart of ``repro.parallel.pipeline``. Layers are partitioned into
``n_stages`` contiguous groups, one per rank of the stage axis, and
microbatches flow through the stages: the classic GPipe flush over
``M + S - 1`` ticks (bubble (S-1)/(M+S-1)). Stage ``i`` computes
microbatch ``t - i`` at tick ``t`` and sends its output to stage ``i + 1``
point to point. Where the reference computes every tick on every stage
and masks the idle ones (one SPMD program), each rank here runs only its
busy ticks. The last stage then broadcasts the outputs, so every rank
returns the same ``(M, mb, S, d)`` tensor, as the reference's closing
``psum`` gives.
"""

from __future__ import annotations

from typing import Any, Callable

import torch
import torch.distributed as dist

from ..tree import tree_map


def pipeline_forward(
    stage_fn: Callable[[Any, torch.Tensor], torch.Tensor],
    stage_params: Any,  # tree with a leading (n_stages, ...) axis
    x_microbatches: torch.Tensor,  # (M, mb, S, d) input microbatches
    mesh,
    stage_axis: str = "pod",
) -> torch.Tensor:
    """Run x through n_stages sequential stages; returns (M, mb, S, d) on
    every rank."""
    group = mesh.get_group(stage_axis)
    n_stages = mesh.size(mesh.mesh_dim_names.index(stage_axis))
    stage = mesh.get_local_rank(stage_axis)
    m = x_microbatches.shape[0]
    params = tree_map(lambda p: p[stage], stage_params)
    prev = dist.get_global_rank(group, stage - 1) if stage > 0 else None
    nxt = dist.get_global_rank(group, stage + 1) if stage < n_stages - 1 else None
    outs = torch.zeros_like(x_microbatches)
    for t in range(m + n_stages - 1):
        mb = t - stage  # the microbatch this stage holds at tick t
        if not 0 <= mb < m:
            continue
        if prev is None:
            cur = x_microbatches[mb]
        else:
            cur = torch.empty_like(x_microbatches[0])
            dist.recv(cur, prev, group=group)
        y = stage_fn(params, cur)
        if nxt is None:
            outs[mb] = y
        else:
            dist.send(y.contiguous(), nxt, group=group)
    # only the last stage holds real outputs; broadcast them back
    dist.broadcast(outs, dist.get_global_rank(group, n_stages - 1), group=group)
    return outs


def split_stages(stacked_params: Any, n_stages: int) -> Any:
    """(L, ...) stacked layer params -> (n_stages, L/n_stages, ...)."""

    def re(x):
        n = x.shape[0]
        assert n % n_stages == 0, f"{n} layers not divisible by {n_stages} stages"
        return x.reshape(n_stages, n // n_stages, *x.shape[1:])

    return tree_map(re, stacked_params)

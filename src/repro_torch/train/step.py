"""The train step: loss -> grads -> AdamW, with optional gradient
accumulation over microbatches.

Counterpart of ``repro.train.step``. Gradients come from
``torch.autograd.grad`` on the family's ``loss_fn``. A step updates the
params and moments of the state it is given in place and returns them in a
new ``TrainState``, as the reference's jitted step donates its state: the
state passed in must not be used again. The supervisor re-enters the step
with a state restored from a checkpoint, never with an earlier one.

With a sharder that carries a mesh, the state's leaves are DTensors
(placed by ``tree_shardings`` over ``state_axes``) and so is the batch
(``batch_shardings``). The step then runs under DTensor's implicit
replication, so the plain tensors the model code makes (positions, masks)
act as replicated; each gradient is redistributed to its param's
placements (a data-parallel gradient arrives as a partial sum), and the
metrics are whole tensors.

The step's phases are ``train.forward`` (the family's ``loss_fn``),
``train.backward`` (``torch.autograd.grad``) and ``train.optimizer``
(AdamW and the metrics): spans while tracing is on, and under a CUDA
graph's capture the boundaries ``train/graph.py`` records as events
(``utils/tracing.py``).
"""

from __future__ import annotations

import contextlib
from typing import Any, Callable, Dict, NamedTuple

import torch
from torch.distributed.tensor import DTensor
from torch.distributed.tensor.experimental import implicit_replication

from ..device import DeviceLike, resolve_device
from ..models.api import family_of
from ..parallel.sharding import full, place_as, redistribute
from ..tree import leaves, tree_map, unflatten_like
from ..utils.tracing import phase
from . import optimizer as opt


class TrainState(NamedTuple):
    params: Any
    opt: opt.OptState
    step: torch.Tensor  # int32 scalar


def init_state(cfg, adamw: opt.AdamWConfig, generator: torch.Generator,
               device: DeviceLike = "cuda") -> TrainState:
    """Seeded random params (``generator`` is a CPU generator, so a seed
    gives the same weights on every device), zero moments, step 0."""
    dev = resolve_device(device)
    params = family_of(cfg).init_params(cfg, generator, dev)
    return TrainState(params=params, opt=opt.init(adamw, params),
                      step=torch.zeros((), dtype=torch.int32, device=dev))


def state_axes(cfg) -> TrainState:
    axes = family_of(cfg).param_axes(cfg)
    return TrainState(params=axes, opt=opt.opt_axes(axes), step=())


def _on_mesh(mesh):
    return implicit_replication() if mesh is not None else contextlib.nullcontext()


def _micro(v, microbatches: int, i: int):
    """Rows [i * B/mb, (i + 1) * B/mb) of a batch entry, in its layout."""
    rows = full(v)
    piece = rows.reshape(microbatches, rows.shape[0] // microbatches, *rows.shape[1:])[i]
    return place_as(piece, v) if isinstance(v, DTensor) else piece


def make_train_step(cfg, adamw: opt.AdamWConfig, sharder=None,
                    microbatches: int = 1) -> Callable:
    """Returns ``train_step(state, batch) -> (state, metrics)``."""
    fam = family_of(cfg)
    sharder = sharder or (lambda x, names: x)
    mesh = getattr(sharder, "mesh", None)

    def loss_and_grads(params, batch):
        with torch.enable_grad():
            ps = tree_map(lambda p: p.detach().requires_grad_(True), params)
            with phase("train.forward"):
                loss = fam.loss_fn(cfg, ps, batch, sharder=sharder)
            with phase("train.backward"):
                grads = torch.autograd.grad(loss, leaves(ps))
        grads = [redistribute(g, p.placements) if isinstance(g, DTensor) else g
                 for g, p in zip(grads, leaves(params), strict=True)]
        return full(loss.detach()), unflatten_like(params, grads)

    def train_step(state: TrainState, batch: Dict):
        with _on_mesh(mesh):
            if microbatches == 1:
                loss, grads = loss_and_grads(state.params, batch)
            else:
                gsum = tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                                state.params)
                lsum = torch.zeros((), device=state.step.device)
                for i in range(microbatches):
                    micro = {k: _micro(v, microbatches, i) for k, v in batch.items()}
                    l, g = loss_and_grads(state.params, micro)
                    for a, b in zip(leaves(gsum), leaves(g), strict=True):
                        a.add_(b.float())
                    lsum = lsum + l
                grads = tree_map(lambda g: g / microbatches, gsum)
                loss = lsum / microbatches
            with phase("train.optimizer"):
                new_params, new_opt, metrics = opt.apply(adamw, state.params, grads, state.opt)
                metrics = {k: full(v) for k, v in metrics.items()}
                metrics["loss"] = loss
            return TrainState(new_params, new_opt, state.step + 1), metrics

    return train_step


def make_serve_steps(cfg, sharder=None):
    """Returns (prefill_fn(params, batch, cache), decode_fn(params, cache,
    tokens)), the two serving entry points. With a sharder that carries a
    mesh they run under DTensor's implicit replication, as the train step."""
    fam = family_of(cfg)
    sharder = sharder or (lambda x, names: x)
    mesh = getattr(sharder, "mesh", None)

    def prefill_fn(params, batch, cache):
        with _on_mesh(mesh):
            return fam.prefill(cfg, params, batch, cache, sharder=sharder)

    def decode_fn(params, cache, tokens):
        with _on_mesh(mesh):
            return fam.decode_step(cfg, params, cache, tokens, sharder=sharder)

    return prefill_fn, decode_fn

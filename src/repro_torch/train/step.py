"""The train step: loss -> grads -> AdamW, with optional gradient
accumulation over microbatches.

Counterpart of ``repro.train.step``. Gradients come from
``torch.autograd.grad`` on the family's ``loss_fn``. A step updates the
params and moments of the state it is given in place and returns them in a
new ``TrainState``, as the reference's jitted step donates its state: the
state passed in must not be used again. The supervisor re-enters the step
with a state restored from a checkpoint, never with an earlier one.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple

import torch

from ..device import DeviceLike, resolve_device
from ..models.api import family_of
from ..tree import leaves, tree_map, unflatten_like
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


def make_train_step(cfg, adamw: opt.AdamWConfig, microbatches: int = 1) -> Callable:
    """Returns ``train_step(state, batch) -> (state, metrics)``."""
    fam = family_of(cfg)

    def loss_and_grads(params, batch):
        with torch.enable_grad():
            ps = tree_map(lambda p: p.detach().requires_grad_(True), params)
            loss = fam.loss_fn(cfg, ps, batch)
            grads = torch.autograd.grad(loss, leaves(ps))
        return loss.detach(), unflatten_like(params, list(grads))

    def train_step(state: TrainState, batch: Dict):
        if microbatches == 1:
            loss, grads = loss_and_grads(state.params, batch)
        else:
            # microbatch i is rows [i * B/mb, (i + 1) * B/mb) of every entry
            mb = {k: v.reshape(microbatches, v.shape[0] // microbatches, *v.shape[1:])
                  for k, v in batch.items()}
            gsum = tree_map(lambda p: torch.zeros(p.shape, device=p.device), state.params)
            lsum = torch.zeros((), device=state.step.device)
            for i in range(microbatches):
                l, g = loss_and_grads(state.params, {k: v[i] for k, v in mb.items()})
                for a, b in zip(leaves(gsum), leaves(g), strict=True):
                    a.add_(b.float())
                lsum = lsum + l
            grads = tree_map(lambda g: g / microbatches, gsum)
            loss = lsum / microbatches
        new_params, new_opt, metrics = opt.apply(adamw, state.params, grads, state.opt)
        metrics["loss"] = loss
        return TrainState(new_params, new_opt, state.step + 1), metrics

    return train_step

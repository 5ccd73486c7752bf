"""AdamW over param trees, written as functions (not ``torch.optim``).

Counterpart of ``repro.train.optimizer``, with its math and order of casts:
clip by the global norm, update the moments in float32, bias-correct from
``count``, decay every leaf, cast back to each leaf's dtype. The moment
dtype is configurable (bf16 halves the optimizer's memory).
``torch.optim.AdamW`` differs in its defaults (no clipping, decay applied
before the step), so it is not used. Moments reuse the params' logical axes
(``opt_axes``), so ZeRO is a sharding decision, not another optimizer: on
DTensor leaves every op runs on the local shards, and the global norm
reduces over every shard to one replicated scalar.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, NamedTuple

import torch

from ..tree import leaves, tree_map


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    moment_dtype: torch.dtype = torch.float32


class OptState(NamedTuple):
    mu: Any
    nu: Any
    count: torch.Tensor  # int32 scalar on the params' device


def init(cfg: AdamWConfig, params) -> OptState:
    def zeros(p):
        return torch.zeros(p.shape, dtype=cfg.moment_dtype, device=p.device)

    device = leaves(params)[0].device
    return OptState(mu=tree_map(zeros, params), nu=tree_map(zeros, params),
                    count=torch.zeros((), dtype=torch.int32, device=device))


def opt_axes(params_axes) -> OptState:
    """Logical axes for the optimizer state mirror the params."""
    return OptState(mu=params_axes, nu=params_axes, count=())


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(x.float().square().sum() for x in leaves(tree)))


@torch.no_grad()
def apply(cfg: AdamWConfig, params, grads, state: OptState):
    """One AdamW step; returns (params, new_state, metrics).

    Params and moments are updated in place, leaf by leaf, and the same
    trees are returned: the reference's jitted step donates its state, so
    no second copy of params and moments is held while the new one is
    built. Only ``count`` is a new tensor."""
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
    count = state.count + 1
    b1c = 1.0 - cfg.b1 ** count.float()
    b2c = 1.0 - cfg.b2 ** count.float()
    for p, g, m, v in zip(leaves(params), leaves(grads), leaves(state.mu), leaves(state.nu),
                          strict=True):
        g = g.float() * scale
        m32 = cfg.b1 * m.float() + (1 - cfg.b1) * g
        v32 = cfg.b2 * v.float() + (1 - cfg.b2) * g.square()
        step = (m32 / b1c) / (torch.sqrt(v32 / b2c) + cfg.eps)
        step = step + cfg.weight_decay * p.float()
        p.copy_(p.float() - cfg.lr * step)
        m.copy_(m32)
        v.copy_(v32)
    return params, OptState(state.mu, state.nu, count), {"grad_norm": gnorm}

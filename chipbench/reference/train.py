"""Plain float32 training reference: forward, autograd and AdamW over the
first steps of a run, and the readings the benchmark compares.

AdamW as the configurations state it: clip the gradient to a global norm
of ``grad_clip``, moments in float32 with (b1, b2), bias correction from
the step count, decoupled weight decay on every leaf, ``p -= lr * (m_hat /
(sqrt(v_hat) + eps) + weight_decay * p)``. All of it is computed in
float32; between steps each parameter is kept in the dtype the
configuration states for weights (``dtype``), as the configuration keeps
no float32 master copy. A bfloat16 norm scale of 1 thus stays 1 under
steps of 3e-4, in the reference as in the configuration.

The batch's rows run one at a time and their gradients are summed, each
row's loss weighted 1/rows: every row has the same number of predictions,
so that is the mean over the whole batch.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import torch

from .common import Precision, exact_float32


def _flatten(tree, prefix: str = "") -> List[Tuple[str, torch.Tensor]]:
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out.extend(_flatten(tree[k], f"{prefix}.{k}" if prefix else k))
        return out
    return [(prefix, tree)]


def _rebuild(tree, values: Dict[str, torch.Tensor], prefix: str = ""):
    if isinstance(tree, dict):
        return {k: _rebuild(tree[k], values, f"{prefix}.{k}" if prefix else k) for k in tree}
    return values[prefix]


def run(model, cfg: Dict, weights, batches: Sequence[Dict], hp: Dict, prec: Precision,
        index: Dict[str, torch.Tensor]):
    """Train ``len(batches)`` steps from ``weights`` (any dtype; taken to
    float32) and read: each step's loss, each leaf's first gradient as the
    optimizer gets it (before clipping: its norm, and its elements at the
    flat positions ``index[leaf]``), and each leaf's change over all the
    steps. ``model`` is a reference module with ``loss_rows`` and
    ``loss_of_row``. Returns floats (and samples) keyed by leaf name."""
    named = _flatten(weights)
    params = {n: w.detach().float().clone().requires_grad_(True) for n, w in named}
    tree = _rebuild(weights, params)
    mu = {n: torch.zeros_like(p) for n, p in params.items()}
    nu = {n: torch.zeros_like(p) for n, p in params.items()}
    losses, first_grad, sample = [], {}, {}
    with exact_float32():
        for step, batch in enumerate(batches, start=1):
            rows = model.loss_rows(cfg, batch)
            grads = {n: torch.zeros_like(p) for n, p in params.items()}
            loss = 0.0
            for r in range(rows):
                with torch.enable_grad():
                    lr_ = model.loss_of_row(cfg, tree, batch, r, prec) / rows
                    gs = torch.autograd.grad(lr_, list(params.values()), allow_unused=True)
                for (n, acc), g in zip(grads.items(), gs):
                    if g is not None:
                        acc.add_(g)
                loss += float(lr_.detach())
                del lr_, gs
            losses.append(loss)
            if step == 1:
                first_grad = {n: float(g.norm()) for n, g in grads.items()}
                sample = {n: g.flatten()[index[n].to(g.device)].cpu() for n, g in grads.items()}
            _adamw(hp, params, grads, mu, nu, step, getattr(torch, cfg["dtype"]))
            del grads
    change = {n: float((params[n].detach() - w.float()).norm()) for n, w in named}
    return {"losses": losses, "first_grad": first_grad, "grad_sample": sample,
            "change": change}


@torch.no_grad()
def _adamw(hp: Dict, params, grads, mu, nu, count: int, storage: torch.dtype) -> None:
    gnorm = torch.sqrt(sum(g.square().sum() for g in grads.values()))
    scale = torch.clamp(hp["grad_clip"] / (gnorm + 1e-9), max=1.0)
    b1, b2 = hp["b1"], hp["b2"]
    b1c, b2c = 1.0 - b1 ** count, 1.0 - b2 ** count
    for n, p in params.items():
        g = grads[n] * scale
        mu[n].mul_(b1).add_((1 - b1) * g)
        nu[n].mul_(b2).add_((1 - b2) * g.square())
        step = (mu[n] / b1c) / (torch.sqrt(nu[n] / b2c) + hp["eps"]) + hp["weight_decay"] * p
        p.sub_(hp["lr"] * step)
        p.copy_(p.to(storage))

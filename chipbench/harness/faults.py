"""Faults planted under the timed path, to show that ``correct`` catches
them: each patches the program for the length of a ``with`` block.

Training cells:
* ``unchanged``: the optimizer returns the state it was given (the step
  count still advances);
* ``half_batch``: the loss is the mean over the first half of the batch's
  rows, the rest left out.

Serving cells:
* ``unchanged``: the decode step leaves the KV cache as it found it;
* ``half_batch``: the decode step's second half of rows take the first
  half's logits;
* ``token_altered``: each decode step moves one request's token (a slot in
  turn) to the next id, where it is produced.

One chip holds each cell, so no exchange between chips can be left out.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Iterator

TRAIN = ("unchanged", "half_batch")
SERVE = ("unchanged", "half_batch", "token_altered")


@contextlib.contextmanager
def _patch(obj, name, value) -> Iterator[None]:
    saved = obj[name] if isinstance(obj, dict) else getattr(obj, name)
    if isinstance(obj, dict):
        obj[name] = value
    else:
        setattr(obj, name, value)
    try:
        yield
    finally:
        if isinstance(obj, dict):
            obj[name] = saved
        else:
            setattr(obj, name, saved)


def _family_patch(family: str, **fns):
    from repro_torch.models.api import FAMILIES

    return _patch(FAMILIES, family, dataclasses.replace(FAMILIES[family], **fns))


def planted(fault: str, kind: str, family: str):
    """A context manager that plants ``fault`` for a cell of ``kind``
    (``train`` or ``closed_loop``) whose model is of ``family``."""
    from repro_torch.models import layers
    from repro_torch.models.api import FAMILIES
    from repro_torch.train import optimizer

    fam = FAMILIES[family]
    if kind == "train" and fault == "unchanged":
        def apply(cfg, params, grads, state):
            metrics = {"grad_norm": optimizer.global_norm(grads)}
            return params, optimizer.OptState(state.mu, state.nu, state.count + 1), metrics

        return _patch(optimizer, "apply", apply)
    if kind == "train" and fault == "half_batch":
        def loss_fn(cfg, params, batch, sharder=None, **kw):
            half = {k: v[: v.shape[0] // 2] for k, v in batch.items()}
            return fam.loss_fn(cfg, params, half, sharder=sharder, **kw)

        return _family_patch(family, loss_fn=loss_fn)
    if kind == "closed_loop" and fault == "unchanged":
        return _patch(layers, "write_token", lambda cache, pos, new: None)
    if kind == "closed_loop" and fault == "half_batch":
        def decode_step(cfg, params, cache, tokens, *a, **k):
            logits, cache = fam.decode_step(cfg, params, cache, tokens, *a, **k)
            half = logits.shape[0] // 2
            logits = logits.clone()
            logits[half: 2 * half] = logits[:half]
            return logits, cache

        return _family_patch(family, decode_step=decode_step)
    if kind == "closed_loop" and fault == "token_altered":
        turn = [0]

        def decode_step(cfg, params, cache, tokens, *a, **k):
            logits, cache = fam.decode_step(cfg, params, cache, tokens, *a, **k)
            slot = turn[0] % logits.shape[0]
            turn[0] += 1
            logits = logits.clone()
            nxt = (logits[slot].argmax() + 1) % logits.shape[1]
            logits[slot, nxt] = logits[slot].max() + 1
            return logits, cache

        return _family_patch(family, decode_step=decode_step)
    raise ValueError(f"no fault {fault!r} for a {kind} cell")

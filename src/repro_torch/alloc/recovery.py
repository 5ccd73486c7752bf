"""Staged OOM recovery: the reclamation ladder shared by backends.

A ``DeviceOOM`` used to be terminal. Under fault injection (transient
``cuMemCreate``/``cuMemMap`` failures, mid-run capacity shrinks — see
``chunks.FaultInjector``) that is the wrong answer: most failures are
survivable if the allocator gives something back and tries again. Backends
that declare ``AllocatorCapabilities.recovery`` walk this ladder before
surfacing ``AllocatorOOM``:

  1. backend-specific reclamation rungs, cheapest first — release cached
     segments, evict StitchFree VA, drain deferred unmaps, return pooled
     physical chunks — re-attempting the allocation after each rung;
  2. bounded retry with exponential backoff, each retry's stall charged to
     the ledger under ``recoveryBackoff`` (a real driver retry costs real
     time; the cost model should see it). Retries are what clear transient
     fault bursts, whose per-call draws are independent.

The ladder is *gated*: ``recovery=None`` (the ctor default everywhere)
auto-enables it only when the device is a fault injector, so the
fault-free replay path — including its golden digests and bit-identical
``model_cost`` — is untouched unless a caller opts in explicitly.

Every attempt and outcome is appended to the backend's
``AllocatorEventLog``; nothing here is silent.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, List

from .chunks import DEVICE_SYNC_COST, DeviceOOM, TransientDeviceError
from .metrics import AllocatorEventLog


@dataclass(frozen=True)
class RecoveryConfig:
    """Bounds for the final retry rung of the ladder."""

    max_retries: int = 6
    #: modeled stall charged per bounded retry; doubles each retry
    backoff_cost: float = DEVICE_SYNC_COST


def recovery_enabled(device, recovery) -> bool:
    """Resolve a backend's ``recovery`` ctor option.

    Explicit True/False wins; ``None`` means auto — on exactly when the
    device injects faults (``supports_fault_injection``). Auto keeps the
    fault-free default path bit-identical to the legacy allocator while
    making every fault-injected run recoverable without extra plumbing.
    """
    if recovery is None:
        return bool(getattr(device, "supports_fault_injection", False))
    return bool(recovery)


def run_ladder(
    attempt: Callable[[], object],
    stages: List[tuple],  # (name, fn[, skip_transient])
    *,
    device,
    log: AllocatorEventLog,
    config: RecoveryConfig = RecoveryConfig(),
    what: str = "",
):
    """Attempt an allocation, walking the reclamation ladder on failure.

    ``attempt`` performs the allocation (raising ``DeviceOOM`` /
    ``TransientDeviceError`` on failure, from a state-neutral point);
    ``stages`` are ordered ``(name, fn)`` reclamation callables returning
    the amount reclaimed. A stage may carry a third element,
    ``skip_transient=True``, marking a *structural* rung (e.g. re-planning
    to a shrunken capacity) that must not fire on transient fault bursts —
    those are what the bounded retries below are for. After the rungs are
    exhausted, bounded retries with exponential modeled backoff clear
    transient bursts. Raises the last ``DeviceOOM`` if nothing helps — the
    caller converts that to ``AllocatorOOM`` exactly as on the legacy path.
    """
    try:
        return attempt()
    except DeviceOOM as e:
        err = e
    log.append(
        "oom",
        what=what,
        transient=isinstance(err, TransientDeviceError),
        error=type(err).__name__,
    )
    for stage in stages:
        name, fn = stage[0], stage[1]
        if len(stage) > 2 and stage[2] and isinstance(err, TransientDeviceError):
            log.append("reclaim_skipped", stage=name, what=what)
            continue
        freed = fn()
        log.append("reclaim." + name, freed=int(freed))
        try:
            out = attempt()
            log.append("recovered", stage=name, what=what)
            return out
        except DeviceOOM as e:
            err = e
    cost = config.backoff_cost
    for retry in range(1, config.max_retries + 1):
        device.ledger.charge("recoveryBackoff", cost)
        cost *= 2.0
        log.append("retry", n=retry, what=what)
        try:
            out = attempt()
            log.append("recovered", stage=f"retry{retry}", what=what)
            return out
        except DeviceOOM as e:
            err = e
    log.append("unrecovered", what=what, error=type(err).__name__)
    raise err


__all__ = ["RecoveryConfig", "recovery_enabled", "run_ladder"]

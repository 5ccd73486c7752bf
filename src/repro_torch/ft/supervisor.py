"""Fault-tolerance supervisor: checkpoint/restart, stragglers, elasticity.

Counterpart of ``repro.ft.supervisor`` (a copy with two changes: metrics
become Python floats through ``.item()``, and the state is restored onto a
``device`` where the reference re-shards it to ``state_shardings``).

Designed for fleets where any step can throw (preempted host, ICI link
flap, data corruption). The supervisor wraps the train loop:

  * **checkpoint/restart** — periodic async checkpoints; on failure the
    loop resumes from the last committed step (restart budget bounds crash
    loops),
  * **straggler detection** — per-step wall times feed a rolling median;
    steps slower than ``straggler_factor`` x median raise a
    ``StragglerEvent`` to the policy hook (log / re-shard / evict host).
    The clock is injectable so policies are unit-testable,
  * **restore placement** — the restored state goes to ``device``, or, by
    default, to the devices of the state it replaces.
"""

from __future__ import annotations

import logging
import statistics
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

import torch

from ..ckpt.checkpoint import CheckpointManager
from ..device import DeviceLike

log = logging.getLogger("repro_torch.ft")


class StragglerEvent(RuntimeError):
    def __init__(self, step: int, elapsed: float, median: float):
        super().__init__(
            f"step {step} took {elapsed:.3f}s vs median {median:.3f}s"
        )
        self.step, self.elapsed, self.median = step, elapsed, median


@dataclass
class StragglerDetector:
    """Rolling-median step-time monitor with an injectable clock."""

    factor: float = 3.0
    window: int = 32
    warmup: int = 4
    clock: Callable[[], float] = time.monotonic
    times: List[float] = field(default_factory=list)
    _t0: Optional[float] = None

    def start(self) -> None:
        self._t0 = self.clock()

    def stop(self, step: int) -> Optional[StragglerEvent]:
        assert self._t0 is not None, "stop() without start()"
        elapsed = self.clock() - self._t0
        self._t0 = None
        ev = None
        if len(self.times) >= self.warmup:
            med = statistics.median(self.times)
            if elapsed > self.factor * med:
                ev = StragglerEvent(step, elapsed, med)
        self.times.append(elapsed)
        if len(self.times) > self.window:
            self.times.pop(0)
        return ev


@dataclass
class SupervisorConfig:
    checkpoint_every: int = 100
    max_restarts: int = 3
    straggler_factor: float = 3.0
    #: "log" (record + continue) | "raise" (escalate to restart logic)
    straggler_policy: str = "log"
    #: rolling window / warmup steps for the straggler median (plumbed
    #: into ``StragglerDetector``)
    straggler_window: int = 32
    straggler_warmup: int = 4
    #: after this many consecutive successful steps the restart budget
    #: resets, so one flaky step early in a long run doesn't consume the
    #: budget forever (None = never reset, the legacy behaviour)
    restart_reset_after: Optional[int] = None
    #: exception types that trigger restore-and-retry. ``MemoryError``
    #: covers ``AllocatorOOM``: under capacity loss the right move is to
    #: restore and rebuild tight on the shrunken device, not crash.
    #: ``RuntimeError`` also covers CUDA launch faults,
    #: ``torch.cuda.OutOfMemoryError`` and kernel build failures, so a caller
    #: that expects no restart must check ``Supervisor.events``.
    recoverable: tuple = (RuntimeError, OSError, MemoryError)


class Supervisor:
    """Drives ``step_fn`` with checkpoint/restart + straggler handling.

    ``step_fn(state, batch) -> (state, metrics)`` may update the state it
    is given in place, as a step that donates its state does: restarts
    re-enter it with the restored state, never an earlier one. ``batch_iter(step)`` must be
    deterministic in ``step`` so restarts replay the exact stream.
    """

    def __init__(
        self,
        step_fn: Callable,
        batch_iter: Callable[[int], Any],
        ckpt: CheckpointManager,
        config: Optional[SupervisorConfig] = None,
        clock: Callable[[], float] = time.monotonic,
        device: Optional[DeviceLike] = None,
        state_shardings: Any = None,
    ):
        self.step_fn = step_fn
        self.batch_iter = batch_iter
        self.ckpt = ckpt
        # default built per instance: a shared default SupervisorConfig()
        # instance would leak mutations across every Supervisor
        self.config = SupervisorConfig() if config is None else config
        self.detector = StragglerDetector(
            factor=self.config.straggler_factor,
            window=self.config.straggler_window,
            warmup=self.config.straggler_warmup,
            clock=clock,
        )
        # StragglerEvent must stay catchable even if a custom recoverable
        # tuple drops RuntimeError — the "raise" policy routes through here
        self._recoverable = (StragglerEvent,) + tuple(self.config.recoverable)
        self.device = device
        # a restored sharded state is placed back on these (``Sharding`` tree)
        self.state_shardings = state_shardings
        self.events: List[Dict] = []  # audit log: restarts, stragglers

    def run(self, state: Any, start_step: int, n_steps: int,
            fail_injector: Optional[Callable[[int], None]] = None):
        """Returns (final_state, history). Restores + retries on failure."""
        restarts = 0
        ok_streak = 0  # successful steps since the last restart
        step = start_step
        history: List[Dict] = []
        reset_after = self.config.restart_reset_after
        while step < start_step + n_steps:
            try:
                batch = self.batch_iter(step)
                self.detector.start()
                if fail_injector is not None:
                    fail_injector(step)
                state, metrics = self.step_fn(state, batch)
                ev = self.detector.stop(step)
                if ev is not None:
                    self.events.append({"kind": "straggler", "step": step,
                                        "elapsed": ev.elapsed, "median": ev.median})
                    if self.config.straggler_policy == "raise":
                        raise ev
                history.append({"step": step, **to_float(metrics)})
                step += 1
                ok_streak += 1
                if reset_after is not None and restarts and ok_streak >= reset_after:
                    self.events.append({"kind": "budget_reset", "step": step,
                                        "restarts_forgiven": restarts})
                    restarts = 0
                if step % self.config.checkpoint_every == 0:
                    self.ckpt.save_async(step, state)
            except self._recoverable as e:
                restarts += 1
                ok_streak = 0
                self.events.append({"kind": "restart", "step": step,
                                    "error": repr(e), "restart": restarts})
                if restarts > self.config.max_restarts:
                    raise RuntimeError(
                        f"restart budget exhausted ({restarts - 1}) at step {step}"
                    ) from e
                self.ckpt.wait()
                last = self.ckpt.latest_step()
                if last is None:
                    log.warning("no checkpoint yet; restarting from step %d", start_step)
                    step = start_step
                    del history[:]  # those steps will be re-run
                    continue
                log.warning("restoring step %d after failure at step %d", last, step)
                sharded = ({} if self.state_shardings is None
                           else {"shardings": self.state_shardings})
                state = self.ckpt.restore(state, step=last, device=self.device, **sharded)
                step = last
                # drop rolled-back entries: they re-run from the restored
                # step, and a history with duplicated steps mis-plots
                while history and history[-1]["step"] >= last:
                    history.pop()
        self.ckpt.wait()
        self.ckpt.save(step, state)
        return state, history


def to_float(metrics: Dict) -> Dict:
    """Scalar metrics as Python floats (one ``.item()`` per tensor, which
    waits for the device and so raises a fault of its kernels here);
    anything else is kept as it is."""
    out = {}
    for k, v in metrics.items():
        if isinstance(v, torch.Tensor):
            out[k] = float(v.item()) if v.numel() == 1 else v
            continue
        try:
            out[k] = float(v)
        except (TypeError, ValueError):
            out[k] = v
    return out

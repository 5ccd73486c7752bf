"""The train step captured in a CUDA graph.

Counterpart of the reference's ``jax.jit(make_train_step(...),
donate_argnums=(0,))`` (``repro.launch.train``): the step is recorded once
and replayed, so the host dispatches it once a signature instead of once a
step, and the state is updated where it lies.

``GraphedStep(step_fn, device)`` wraps ``make_train_step(...)``'s result
and keeps its signature, ``(state, batch) -> (state, metrics)``:

* **Static state.** The first state it is given becomes the graph's input
  and is the state it returns on every call. Params and moments already
  update in place; the leaves the step makes anew (``TrainState.step``,
  ``OptState.count``) are copied back into the static ones inside the
  step's body, so a replay advances the state the caller holds. As with
  the step itself, a state passed in must not be used again.
* **One graph per batch signature**: the batch's keys, shapes and dtypes,
  and a DTensor's mesh and placements (``signature``), as ``jax.jit`` keeps
  one executable per input shape; length buckets give one graph each. The
  batch is copied into the signature's static buffers on every call.
* **Warm-up, then capture.** The first call with a new signature runs the
  body eagerly on the side stream captures use: a real step, whose result
  is kept. On the card it runs under
  ``torch.cuda.set_sync_debug_mode("error")``, so any host read in the
  step raises there. The next call with that signature captures the body,
  which executes nothing, and replays it. No copy of the state is taken.
* **Restore.** A state whose leaves are not the static ones (the
  supervisor's restored state, or what an eager step returned) is copied
  into the static leaves once; nothing is captured again.
* **Metrics** are cloned out of the graph's outputs after each replay, so
  they stay the caller's when the next replay overwrites the outputs.
* **Phase events.** Each ``tracing.phase`` boundary of the body (forward,
  backward, optimizer; ``train/step.py``) and its end, after the write-back,
  records a timing event on the capture stream, an event-record node of the
  graph: a replay re-records them, and they allocate nothing. After a
  replay made while tracing is on, the graph hands them to the tracer,
  which reads them as the phases' device times (and the whole replay's, as
  ``graph.replay``) before the next replay of that graph or when it is read
  (``utils/tracing.py``); tracing off, nothing waits for them.

All graphs share one memory pool. That is safe in any order of replay: a
graph reads only the static state and its own static batch, which live
outside the pool, and the one thing of its own it keeps between replays,
its metrics, stays allocated, so no later capture is given that memory.
What a replay frees inside the pool, another graph may overwrite, and
replays run one after another on the caller's stream.

On the CPU, which a caller asks for by passing that device, there is no
graph: each call runs the same body eagerly, through the same static
batch and state, so the CPU exercises the protocol above. On the card a
failed capture or replay raises; nothing falls back to the eager step.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

import torch
from torch.distributed.tensor import DTensor

from ..device import DeviceLike, resolve_device
from ..tree import leaves
from ..utils import tracing


def signature(batch: Dict) -> Tuple:
    """What selects a graph: each entry's key, shape and dtype, and for a
    DTensor its mesh and placements."""
    return tuple((k, tuple(v.shape), v.dtype,
                  (v.device_mesh, tuple(v.placements)) if isinstance(v, DTensor) else None)
                 for k, v in sorted(batch.items()))


def _capture_stream(device: torch.device) -> torch.cuda.Stream:
    """The side stream of every warm-up and capture: PyTorch's own capture
    stream, one for the process. cuBLAS keeps a workspace per stream for
    the life of the process, so a new stream per warm-up would leave one
    behind each time."""
    if torch.cuda.graph.default_capture_stream is None:
        with torch.cuda.device(device):
            torch.cuda.graph.default_capture_stream = torch.cuda.Stream()
    return torch.cuda.graph.default_capture_stream


def _local(t: torch.Tensor) -> torch.Tensor:
    return t.to_local() if isinstance(t, DTensor) else t


class _Graph:
    """One batch signature: its static batch, and once captured, its graph
    and the graph's metrics."""

    def __init__(self, batch: Dict):
        self.batch = {k: torch.empty_like(v) for k, v in batch.items()}
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.metrics: Optional[Dict] = None
        #: (phase, event) at each phase boundary, then (None, event) at the end
        self.marks: List[Tuple[Optional[str], torch.cuda.Event]] = []

    def load(self, batch: Dict) -> Dict:
        for k, v in batch.items():
            _local(self.batch[k]).copy_(_local(v))
        return self.batch

    def mark(self, name: Optional[str]) -> None:
        event = torch.cuda.Event(enable_timing=True, external=True)
        event.record()
        self.marks.append((name, event))

    def resolve(self) -> None:
        """The last replay's phase times, as device ms under their names."""
        marks = self.marks
        marks[-1][1].synchronize()
        for (name, a), (_, b) in zip(marks, marks[1:]):
            tracing.device(name, a.elapsed_time(b))
        tracing.device("graph.replay", marks[0][1].elapsed_time(marks[-1][1]))


class GraphedStep:
    """``step_fn`` captured in a CUDA graph per batch signature on
    ``device`` when it is a card, run eagerly through the same static
    buffers on the CPU (module docstring)."""

    def __init__(self, step_fn: Callable, device: DeviceLike = "cuda"):
        self.step_fn = step_fn
        self.device = resolve_device(device)
        self.on_card = self.device.type == "cuda"
        self.state = None
        self._graphs: Dict[Tuple, _Graph] = {}
        self._pool = None

    @property
    def signatures(self) -> int:
        return len(self._graphs)

    @property
    def captured(self) -> int:
        return sum(g.graph is not None for g in self._graphs.values())

    def load(self, state):
        """Make ``state`` the static state, or copy its leaves into it."""
        if self.state is None:
            self.state = state
        elif state is not self.state:
            for static, leaf in zip(leaves(self.state), leaves(state), strict=True):
                if leaf is static:
                    continue
                if leaf.shape != static.shape or leaf.dtype != static.dtype:
                    raise ValueError(f"state leaf {tuple(leaf.shape)} {leaf.dtype} does not "
                                     f"match the static {tuple(static.shape)} {static.dtype}")
                static.copy_(leaf)
        return self.state

    def __call__(self, state, batch: Dict):
        self.load(state)
        sig = signature(batch)
        g = self._graphs.get(sig)
        if g is None:
            g = _Graph(batch)
            metrics = self._warm_up(g.load(batch))
            self._graphs[sig] = g
        elif not self.on_card:
            metrics = self._body(g.load(batch))
        else:
            static = g.load(batch)
            if g.graph is None:
                g.graph, g.metrics = self._capture(g, static)
            tracing.settle(g)  # the last replay's events, before they are recorded again
            g.graph.replay()
            if g.marks and tracing.on():
                tracing.defer(g, g.resolve)
            metrics = g.metrics
        return self.state, {k: v.clone() for k, v in metrics.items()}

    def _body(self, batch: Dict) -> Dict:
        """One step on the static state; the leaves it makes anew are
        written back into the static ones."""
        new, metrics = self.step_fn(self.state, batch)
        for static, leaf in zip(leaves(self.state), leaves(new), strict=True):
            if leaf is not static:
                static.copy_(leaf)
        return metrics

    def _warm_up(self, batch: Dict) -> Dict:
        if not self.on_card:
            return self._body(batch)
        current = torch.cuda.current_stream(self.device)
        side = _capture_stream(self.device)
        side.wait_stream(current)
        mode = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode("error")
        try:
            with torch.cuda.stream(side):
                metrics = self._body(batch)
        finally:
            torch.cuda.set_sync_debug_mode(mode)
        current.wait_stream(side)
        for v in metrics.values():  # read on the caller's stream before they are freed
            v.record_stream(current)
        return metrics

    def _capture(self, g: _Graph, batch: Dict):
        graph = torch.cuda.CUDAGraph()
        # thread_local: another thread's CUDA calls (NCCL's watchdog) do not
        # invalidate the capture
        with torch.cuda.graph(graph, pool=self._pool, stream=_capture_stream(self.device),
                              capture_error_mode="thread_local"):
            with tracing.boundaries(g.mark):
                metrics = self._body(batch)
            if g.marks:  # the last phase ends after the write-back
                g.mark(None)
        self._pool = graph.pool()
        return graph, metrics

"""The port's own spans and counters.

Tracing is on while an operator has called ``enable()``, or while a
``torch.profiler`` session is active; each profiler session starts a fresh
record, so a profiled stretch reads alone. Off, ``span`` and ``count`` cost
one read of a module global and allocate nothing.

On:

* ``span(name, req=-1)`` times a block on the host clock
  (``time.perf_counter_ns``). It keeps the index of the enclosing span (-1
  at the top) and a request or sequence id (-1 for none): spans of one
  request share it. While a profiler session is active it is also a
  ``torch.profiler`` ``record_function`` range, which the profiler places
  on the same clock as the device's kernels (a user annotation in its
  trace); outside a session no one reads the range, so none is entered.
* ``spanned(name)`` is a decorator: each call is such a span.
* ``count(name, n=1)`` adds to a counter.
* ``device(name, ms)`` adds a device interval measured elsewhere (a CUDA
  graph's phase events, ``train/graph.py``) under a span name. A graph
  hands its unread events to ``defer(key, fn)``; ``settle(key)`` reads them
  before the graph records them again, and ``snapshot()`` or the end of the
  profiler session reads whatever is left.
* ``phase(name)`` is a span that also calls the hook ``boundaries(hook)``
  installs: how the graphed train step records an event at each phase
  boundary while it is captured.

``snapshot()`` returns per name its count (spans closed plus device
intervals added), total, self (duration minus the part its child spans
cover) and device milliseconds; the counters; and the newest ``RING`` raw
spans. Totals are kept apart from the ring, so they stay exact when it
wraps. Nothing is written to a file. ``docs/TRACING_TORCH.md`` lists the
port's span and counter names and what each answers.
"""

from __future__ import annotations

import contextlib
import functools
import sys
import threading
import time
import warnings
from collections import deque
from typing import Callable, Dict, Hashable, Iterator, List, NamedTuple, Optional

import torch
import torch.autograd.profiler as _profiler

#: raw spans kept, newest last
RING = 65536


class Span(NamedTuple):
    index: int  # order of entry within the record
    name: str
    start_ns: int
    end_ns: int
    parent: int  # index of the enclosing span, -1 at the top
    req: int  # request or sequence id, -1 for none


class _Record:
    def __init__(self):
        # name -> [count, total ns, self ns, device ms]
        self.stats: Dict[str, List] = {}
        self.counters: Dict[str, int] = {}
        self.ring: deque = deque(maxlen=RING)
        self.next_index = 0
        self.pending: Dict[Hashable, Callable[[], None]] = {}

    def stat(self, name: str) -> List:
        st = self.stats.get(name)
        if st is None:
            st = self.stats[name] = [0, 0, 0, 0.0]
        return st


_record = _Record()
_enabled = False  # enable() / disable()
_profiling = False  # a torch.profiler session is active
_on = False  # _enabled or _profiling
_hook: Optional[Callable[[str], None]] = None
_local = threading.local()  # each thread's stack of open spans


class _Null:
    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NULL = _Null()


class _Open:
    __slots__ = ("name", "req", "record", "index", "parent", "start", "child_ns", "range")

    def __init__(self, name: str, req: int):
        self.name = name
        self.req = req

    def __enter__(self):
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        rec = self.record = _record
        self.index = rec.next_index
        rec.next_index += 1
        self.parent = stack[-1].index if stack else -1
        self.child_ns = 0
        self.range = None
        if _profiling:  # a range costs some 15 us, and only a profiler reads it
            self.range = torch.profiler.record_function(self.name)
            self.range.__enter__()
        stack.append(self)
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        end = time.perf_counter_ns()
        if self.range is not None:
            self.range.__exit__(*exc)
        stack = _local.stack
        stack.pop()
        dur = end - self.start
        if stack:
            stack[-1].child_ns += dur
        rec = self.record
        if rec is _record:  # a span open when a session began stays out of its record
            st = rec.stat(self.name)
            st[0] += 1
            st[1] += dur
            st[2] += dur - self.child_ns
            rec.ring.append(Span(self.index, self.name, self.start, end, self.parent, self.req))
        return False


def span(name: str, req: int = -1):
    """A context manager timing its block under ``name`` while tracing is
    on; off, a shared object that does nothing."""
    if not _on:
        return _NULL
    return _Open(name, req)


def spanned(name: str) -> Callable[[Callable], Callable]:
    """A decorator: each call of the function is a span named ``name``."""
    def wrap(fn: Callable) -> Callable:
        @functools.wraps(fn)
        def traced(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)

        return traced

    return wrap


def count(name: str, n: int = 1) -> None:
    if _on:
        c = _record.counters
        c[name] = c.get(name, 0) + n


def on() -> bool:
    return _on


def phase(name: str):
    """``span(name)``, and first the hook ``boundaries`` installed, if any."""
    if _hook is not None:
        _hook(name)
    return span(name)


@contextlib.contextmanager
def boundaries(hook: Callable[[str], None]) -> Iterator[None]:
    """Call ``hook(name)`` at the start of every ``phase`` inside the block."""
    global _hook
    saved, _hook = _hook, hook
    try:
        yield
    finally:
        _hook = saved


def device(name: str, ms: float) -> None:
    """Add a device interval of ``ms`` under ``name``. Called by the
    resolvers ``defer`` holds, which exist only for work done while tracing
    was on, so it records whether or not tracing is on now."""
    st = _record.stat(name)
    st[0] += 1
    st[3] += ms


def defer(key: Hashable, fn: Callable[[], None]) -> None:
    """Hold ``fn``, which reads device intervals of ``key``'s last run,
    until ``settle(key)``, ``snapshot()`` or the end of the session."""
    _record.pending[key] = fn


def settle(key: Hashable) -> None:
    """Run ``key``'s held resolver while tracing is on, else drop it; a
    caller does this before it records ``key``'s events again."""
    fn = _record.pending.pop(key, None)
    if fn is not None and _on:
        fn()


def _flush() -> None:
    pending = _record.pending
    while pending:
        pending.pop(next(iter(pending)))()


def snapshot() -> Dict:
    """Per name ``count``, ``total_ms``, ``self_ms`` and ``device_ms``; the
    ``counters``; and the ``spans`` of the ring, oldest first."""
    _flush()
    rec = _record
    return {
        "names": {n: {"count": c, "total_ms": t / 1e6, "self_ms": s / 1e6, "device_ms": d}
                  for n, (c, t, s, d) in rec.stats.items()},
        "counters": dict(rec.counters),
        "spans": list(rec.ring),
    }


def reset() -> None:
    """Start a fresh record (what each profiler session does)."""
    global _record
    _record = _Record()


def enable() -> None:
    global _enabled, _on
    _enabled = _on = True


def disable() -> None:
    global _enabled, _on
    _enabled = False
    _on = _profiling


def _session_start() -> None:
    global _profiling, _on
    reset()
    _profiling = _on = True


def _session_stop() -> None:
    global _profiling, _on
    _flush()
    _profiling = False
    _on = _enabled


def _follow_the_profiler() -> None:
    """Wrap the hooks every ``torch.profiler`` session calls as it starts
    and stops (``torch.autograd.profiler._run_on_profiler_start`` / ``_stop``,
    which set ``_is_profiler_enabled``), once a process. Where they are
    missing, warn: profiler sessions then leave tracing off."""
    start = getattr(_profiler, "_run_on_profiler_start", None)
    stop = getattr(_profiler, "_run_on_profiler_stop", None)
    if start is None or stop is None:
        warnings.warn("torch.autograd.profiler has no _run_on_profiler_start/_stop: "
                      "profiler sessions will not turn tracing on; call enable()",
                      RuntimeWarning, stacklevel=2)
        return
    if getattr(start, "_follows", False):
        return

    # through sys.modules, so a reloaded module still follows the sessions
    def on_start():
        start()
        sys.modules[__name__]._session_start()

    def on_stop():
        stop()
        sys.modules[__name__]._session_stop()

    on_start._follows = True
    _profiler._run_on_profiler_start = on_start
    _profiler._run_on_profiler_stop = on_stop


_follow_the_profiler()

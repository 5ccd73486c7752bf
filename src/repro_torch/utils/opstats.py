"""Per-device step statistics, counted op by op as the step runs.

Counterpart of ``repro.utils.hlo``: the reference walks the compiled
per-device HLO; the port has no HLO, so ``analyze(fn, *args)`` runs ``fn``
eagerly under a dispatch mode and counts every aten op it reaches. On
DTensors the mode steps aside (``NotImplemented``), so DTensor dispatches
and the mode sees the ops it runs on rank 0's **local** shards: per-device
quantities, as the reference's per-device SPMD program gives. The fake
tensors of DTensor's sharding propagation are not counted. The eager step
runs every layer, so no loop multipliers are needed.

  * flops: 2*M*N*K for every matmul-class op (``torch.utils.flop_counter``'s
    formulas, also kept apart as ``dot_flops``), plus 1 per output element
    for the elementwise set that ``repro.utils.hlo`` counts;
  * traffic_bytes: operand + result bytes of every op that is not a view
    or an allocation. The step is eager and unfused, so this is an upper
    bound on HBM traffic, not XLA's post-fusion count;
  * collectives: count and result bytes (per-device received bytes) of
    every collective, by type, under the reference's names;
  * memory: the live bytes of the storages the call allocates, tracked
    through weak references, so that ``temp_peak_bytes`` is the high-water
    mark beyond what was allocated before the call (its arguments).
    ``temp_at_peak`` splits the live bytes at that mark by when they were
    allocated: ``before_backward`` (the forward pass; all of a serving
    step), ``backward`` (inside an autograd graph task: gradients, backward
    temporaries, recomputation) and ``after_backward`` (the optimizer;
    with microbatches, also the forward passes after the first).

The mode works on any device: on meta tensors (the dry run) and on the
card (``launch.dryrun.validate``) it counts the same ops.
"""

from __future__ import annotations

import weakref
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import torch
from torch._subclasses.fake_tensor import FakeTensor
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

#: aten op names (in-place ``_`` stripped) counted at 1 flop per output
#: element: the elementwise set of ``repro.utils.hlo._EW_FLOP_OPS``
EW_FLOP_OPS = frozenset({
    "add", "sub", "subtract", "mul", "multiply", "div", "divide", "maximum", "minimum",
    "pow", "exp", "log", "tanh", "rsqrt", "sqrt", "sigmoid", "neg", "eq", "ne", "lt",
    "le", "gt", "ge", "where", "logical_and", "logical_or", "logical_xor", "bitwise_and",
    "bitwise_or", "bitwise_xor", "abs", "floor", "ceil", "cos", "sin", "atan2",
    "remainder", "fmod", "clamp", "clamp_min", "clamp_max", "expm1",
})

#: collective op names (``_c10d_functional`` and ``c10d``) -> the reference's type
COLLECTIVES = {
    "all_reduce": "all-reduce", "all_reduce_coalesced": "all-reduce",
    "allreduce_": "all-reduce", "allreduce_coalesced_": "all-reduce",
    "all_gather_into_tensor": "all-gather", "all_gather_into_tensor_coalesced": "all-gather",
    "all_gather_into_tensor_out": "all-gather", "_allgather_base_": "all-gather",
    "allgather_": "all-gather", "allgather_into_tensor_coalesced_": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter", "reduce_scatter_": "reduce-scatter",
    "all_to_all_single": "all-to-all", "alltoall_base_": "all-to-all",
    "alltoall_": "all-to-all", "broadcast": "broadcast", "broadcast_": "broadcast",
    "send": "collective-permute", "recv_": "collective-permute",
}

#: ops that move no data: allocation, bookkeeping and waiting
_NO_TRAFFIC = frozenset({
    "empty", "empty_like", "empty_strided", "new_empty", "new_empty_strided", "detach",
    "wait_tensor", "_wrap_tensor_autograd", "lift_fresh", "_local_scalar_dense",
})

_PHASES = ("before_backward", "backward", "after_backward")


@dataclass
class ModuleStats:
    flops: float = 0.0
    traffic_bytes: float = 0.0
    collective_bytes: float = 0.0
    collectives: Dict[str, Dict[str, float]] = field(default_factory=dict)
    #: the matmul-class part of ``flops``
    dot_flops: float = 0.0
    #: high-water mark of the live bytes allocated during the call
    temp_peak_bytes: int = 0
    #: live bytes at that mark, by the phase that allocated them
    temp_at_peak: Dict[str, int] = field(default_factory=dict)
    #: the phase of the op that set the mark
    peak_phase: str = ""


def _tensors(x, out: list) -> list:
    """The tensors in an op's arguments or result (tuples, lists, dicts)."""
    if isinstance(x, torch.Tensor):
        out.append(x)
    elif isinstance(x, (tuple, list)):
        for v in x:
            _tensors(v, out)
    elif isinstance(x, dict):
        for v in x.values():
            _tensors(v, out)
    return out


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class _OpInfo(NamedTuple):
    flop_fn: Optional[Callable]  # matmul-class formula
    elementwise: bool
    collective: Optional[str]
    traffic: bool
    aliases: bool  # a view, or a result that is an input (in place, out=)


def _op_info(func) -> _OpInfo:
    name = func._schema.name.split("::")[-1]
    return _OpInfo(
        flop_fn=flop_registry.get(func._overloadpacket),
        elementwise=name.rstrip("_") in EW_FLOP_OPS,
        collective=COLLECTIVES.get(name),
        traffic=not func.is_view and name not in _NO_TRAFFIC,
        aliases=func.is_view or any(r.alias_info is not None for r in func._schema.returns),
    )


class OpCounter(TorchDispatchMode):
    """Counts what ``ModuleStats`` holds for every op dispatched inside it."""

    def __init__(self):
        super().__init__()
        self.stats = ModuleStats()
        self._ops: Dict[Any, _OpInfo] = {}
        self._live: Dict[int, Tuple[int, str]] = {}
        self._live_bytes = 0
        self._by_phase = dict.fromkeys(_PHASES, 0)
        self._backward_seen = False

    def _phase(self) -> str:
        if torch._C._current_graph_task_id() != -1:
            self._backward_seen = True
            return "backward"
        return "after_backward" if self._backward_seen else "before_backward"

    def _free(self, key: int) -> None:
        nbytes, phase = self._live.pop(key)
        self._live_bytes -= nbytes
        self._by_phase[phase] -= nbytes

    def _track(self, outs, ins) -> None:
        """Start counting the storages of ``outs`` that are new."""
        phase = self._phase()
        for t in outs:
            if any(t is i for i in ins):
                continue
            st = t.untyped_storage()
            key = st._cdata
            if key in self._live:
                continue
            nbytes = st.nbytes()
            self._live[key] = (nbytes, phase)
            self._live_bytes += nbytes
            self._by_phase[phase] += nbytes
            weakref.finalize(st, self._free, key)
        s = self.stats
        if self._live_bytes > s.temp_peak_bytes:
            s.temp_peak_bytes = self._live_bytes
            s.temp_at_peak = dict(self._by_phase)
            s.peak_phase = phase

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented  # let DTensor run its local ops under this mode
        out = func(*args, **kwargs)
        ins = _tensors(kwargs, _tensors(args, []))
        outs = _tensors(out, [])
        if any(isinstance(t, FakeTensor) for t in outs) or \
                any(isinstance(t, FakeTensor) for t in ins):
            return out  # DTensor's sharding propagation, not the step's work
        info = self._ops.get(func)
        if info is None:
            info = self._ops[func] = _op_info(func)
        s = self.stats
        if info.flop_fn is not None:
            n = info.flop_fn(*args, **kwargs, out_val=out)
            s.dot_flops += n
            s.flops += n
        elif info.elementwise:
            s.flops += sum(o.numel() for o in outs)
        if info.collective is not None:
            nbytes = sum(_nbytes(o) for o in outs)
            s.collective_bytes += nbytes
            slot = s.collectives.setdefault(info.collective, {"count": 0.0, "bytes": 0.0})
            slot["count"] += 1
            slot["bytes"] += nbytes
        if info.traffic:
            s.traffic_bytes += sum(_nbytes(t) for t in ins) + sum(_nbytes(t) for t in outs)
        if not info.aliases:
            self._track(outs, ins)
        return out


def device_busy_ms(prof) -> float:
    """Length of the union of the card's kernel and copy intervals in a
    ``torch.profiler`` run, in ms; raises if it recorded none."""
    from torch.autograd import DeviceType

    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type == DeviceType.CUDA)
    if not spans:
        raise RuntimeError("the profiler recorded no device activity")
    total, end = 0.0, float("-inf")
    for s, e in spans:
        if e > end:
            total += e - max(s, end)
            end = e
    return total / 1e3


def analyze(fn: Callable, *args: Any) -> ModuleStats:
    """Run ``fn(*args)`` under an ``OpCounter``; the statistics of the ops
    it ran."""
    with OpCounter() as counter:
        fn(*args)
    return counter.stats

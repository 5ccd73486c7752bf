"""Logical-axis sharding rules (MaxText-style) on a torch ``DeviceMesh``.

Counterpart of ``repro.parallel.sharding``. Every model leaf carries a
tuple of logical dim names (``param_axes`` / ``cache_axes``); rules map
names to mesh axes. Divisibility is checked per leaf: a rule that does not
divide the dimension falls back to replication, and the fallback is
recorded (smollm's 9 heads are not sharded over 2).

Rule sets:
  * train:   batch/data-parallel, TP over heads/ffn/vocab/experts, optional
             Megatron sequence parallelism, optional ZeRO (params+opt over
             'data' on the largest free dim).
  * decode:  batch over data, KV sequence over 'model' (and 'data' too for
             batch=1 long-context cells).

A spec is a plain tuple in ``PartitionSpec``'s shape (one entry per leading
dim: ``None``, an axis name, or a tuple of axis names; trailing ``None``
dropped), so it compares with the reference's directly. ``placements_for``
turns it into DTensor placements. Params and optimizer state live as
``DTensor`` leaves placed by ``tree_shardings``; the model code stays plain
torch and the sharder redistributes activations where the reference
constrains them. Where DTensor has no sharding rule for an op, the model
runs that op on each rank's shards through ``run_local``, which gathers
whatever the op needs whole and records the site (``taken_sites``).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Union

import torch
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from ..tree import tree_map

AxisRule = Union[None, str, Tuple[str, ...]]
Spec = Tuple[AxisRule, ...]


#: tensor-parallel / data-parallel defaults shared by all rule sets
BASE_RULES: Dict[str, AxisRule] = {
    "batch": ("pod", "data"),
    "vocab": "model",
    "heads": "model",
    "kv_heads": "model",
    "ffn": "model",
    "expert": "model",
    "embed_out": "model",  # square projections (rwkv): shard the output dim
    "capacity": ("pod", "data"),  # MoE dispatch-buffer token slots
    # mamba2 / rwkv internals
    "inner": "model",
    "inner_proj": "model",
    "inner_conv": "model",
    "ssm_heads": "model",
    "position": None,
    "embed": None,
    "layers": None,
    "vocab_in": None,
    "enc_seq": None,
    "kv_seq": None,
    "seq": None,
}


@dataclass(frozen=True)
class AbstractMesh:
    """Axis names and sizes only: all the rules and specs read. The
    production meshes (256 and 512 ranks) are checked this way on a host
    that has no such world."""

    axis_names: Tuple[str, ...]
    sizes: Tuple[int, ...]


def axis_sizes(mesh) -> Dict[str, int]:
    """``{axis name: size}`` of a ``DeviceMesh`` or an ``AbstractMesh``."""
    if isinstance(mesh, DeviceMesh):
        return dict(zip(mesh.mesh_dim_names, mesh.shape))
    return dict(zip(mesh.axis_names, mesh.sizes))


def make_rules(
    mesh,
    *,
    kind: str = "train",  # train | prefill | decode
    seq_parallel: bool = False,
    long_context: bool = False,
    pure_dp: bool = False,
) -> Dict[str, AxisRule]:
    rules = dict(BASE_RULES)
    if pure_dp:
        # small models (heads not divisible by the model axis) run pure
        # data-parallel: batch over every mesh axis, no tensor parallelism
        rules = {k: None for k in rules}
        rules["batch"] = ("pod", "data", "model")
        if kind == "decode":
            rules["kv_seq"] = None
        return _filter_rules(rules, mesh)
    if seq_parallel and kind in ("train", "prefill"):
        rules["seq"] = "model"
    if kind == "decode":
        rules["kv_seq"] = ("data", "model") if long_context else "model"
    return _filter_rules(rules, mesh)


def _filter_rules(rules: Dict[str, AxisRule], mesh) -> Dict[str, AxisRule]:
    """Drop axes this mesh does not have (single-pod has no 'pod')."""
    names = set(axis_sizes(mesh))

    def filt(rule: AxisRule) -> AxisRule:
        if rule is None:
            return None
        if isinstance(rule, str):
            return rule if rule in names else None
        kept = tuple(a for a in rule if a in names)
        return kept or None

    return {k: filt(v) for k, v in rules.items()}


def _axes(rule: AxisRule) -> Tuple[str, ...]:
    return (rule,) if isinstance(rule, str) else tuple(rule)


def _axis_size(mesh, rule: AxisRule) -> int:
    if rule is None:
        return 1
    sizes = axis_sizes(mesh)
    return math.prod(sizes[a] for a in _axes(rule))


def spec_for_leaf(
    shape: Sequence[int],
    names: Sequence[Optional[str]],
    rules: Dict[str, AxisRule],
    mesh,
    fallbacks: Optional[List[str]] = None,
) -> Spec:
    """Spec for one leaf; skips non-divisible / duplicate axes."""
    assert len(shape) == len(names), f"shape {shape} vs names {names}"
    used: set = set()
    parts: List[AxisRule] = []
    for dim, name in zip(shape, names):
        rule = rules.get(name) if name else None
        if rule is not None:
            if any(a in used for a in _axes(rule)) or dim % _axis_size(mesh, rule) != 0:
                if fallbacks is not None:
                    fallbacks.append(f"{name}:{dim}")
                rule = None
        if rule is None:
            parts.append(None)
        else:
            used.update(_axes(rule))
            parts.append(rule if isinstance(rule, str) else tuple(rule))
    while parts and parts[-1] is None:
        parts.pop()
    return tuple(parts)


def zero_extend(
    spec: Spec,
    shape: Sequence[int],
    mesh,
    axes: Tuple[str, ...] = ("data",),
    names: Optional[Sequence[Optional[str]]] = None,
) -> Spec:
    """ZeRO: additionally shard one unsharded dim over ``axes``: the
    largest divisible one, the first of equals."""
    sizes = axis_sizes(mesh)
    axes = tuple(a for a in axes if a in sizes)
    if not axes:
        return spec
    used = set()
    for p in spec:
        if p is not None:
            used.update(_axes(p))
    if any(a in used for a in axes):
        return spec
    size = math.prod(sizes[a] for a in axes)
    parts = list(spec) + [None] * (len(shape) - len(spec))
    best, best_dim = -1, -1
    for i, (dim, p) in enumerate(zip(shape, parts)):
        if p is not None or dim % size != 0:
            continue
        if dim > best_dim:
            best, best_dim = i, dim
    if best < 0:
        return spec
    parts[best] = axes[0] if len(axes) == 1 else tuple(axes)
    while parts and parts[-1] is None:
        parts.pop()
    return tuple(parts)


def placements_for(spec: Spec, mesh) -> Tuple[Any, ...]:
    """DTensor placements of a spec: per mesh dim, ``Shard(d)`` for the
    tensor dim it splits or ``Replicate()``. A dim split over several mesh
    axes (``("pod", "data")``) takes a ``Shard`` on each, major axis first,
    which is DTensor's default order as it is JAX's."""
    names = list(axis_sizes(mesh))
    pl: List[Any] = [Replicate()] * len(names)
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        idx = [names.index(a) for a in _axes(entry)]
        if idx != sorted(idx):
            raise NotImplementedError(f"spec entry {entry} is not in mesh order {names}")
        for i in idx:
            pl[i] = Shard(dim)
    return tuple(pl)


class Sharding:
    """Where a leaf lives: a mesh and a spec (``NamedSharding``'s role)."""

    def __init__(self, mesh, spec: Spec):
        self.mesh = mesh
        self.spec = spec

    @property
    def placements(self) -> Tuple[Any, ...]:
        return placements_for(self.spec, self.mesh)

    def shard_shape(self, shape: Sequence[int]) -> Tuple[int, ...]:
        """Each rank's block of a leaf of global ``shape``."""
        out = list(shape)
        for dim, entry in enumerate(self.spec):
            if entry is not None:
                out[dim] //= _axis_size(self.mesh, entry)
        return tuple(out)

    def __repr__(self) -> str:
        return f"Sharding({self.spec})"


def _is_axes(x) -> bool:
    """A leaf of an axes tree: a plain tuple of dim names (``()`` for a scalar)."""
    return (isinstance(x, tuple) and not hasattr(x, "_fields")
            and all(isinstance(e, (str, type(None))) for e in x))


def tree_shardings(
    shapes_tree: Any,  # tree of tensors (meta tensors will do)
    axes_tree: Any,  # matching tree of logical-name tuples
    rules: Dict[str, AxisRule],
    mesh,
    *,
    zero: bool = False,
    zero_axes: Tuple[str, ...] = ("pod", "data"),
) -> Any:
    """``Sharding`` tree for params / caches / optimizer state."""
    fallbacks: List[str] = []
    zaxes = tuple(a for a in zero_axes if a in axis_sizes(mesh))

    def one(names, leaf):
        shape = tuple(leaf.shape)
        spec = spec_for_leaf(shape, names, rules, mesh, fallbacks)
        if zero:
            spec = zero_extend(spec, shape, mesh, zaxes, names=names)
        return Sharding(mesh, spec)

    out = tree_map(one, axes_tree, shapes_tree, is_leaf=_is_axes)
    tree_shardings.last_fallbacks = fallbacks  # introspection for reports
    return out


def batch_shardings(batch_specs: Dict, rules, mesh) -> Dict:
    """Shardings for the input batch (tokens/frames/patches over batch)."""

    def one(leaf):
        names: List[Optional[str]] = ["batch"] + [None] * (len(leaf.shape) - 1)
        return Sharding(mesh, spec_for_leaf(leaf.shape, names, rules, mesh))

    return tree_map(one, batch_specs)


# ---------------------------------------------------------------------------
# placing tensors, and the activation sharder
# ---------------------------------------------------------------------------


def _place(x: torch.Tensor, mesh, placements) -> DTensor:
    coord = mesh.get_coordinate()
    local = x
    for i, p in enumerate(placements):
        if isinstance(p, Shard):
            local = local.chunk(mesh.size(i), dim=p.dim)[coord[i]]
    return DTensor.from_local(local.contiguous(), mesh, placements, run_check=False)


def place(x: torch.Tensor, sharding: Sharding) -> DTensor:
    """A DTensor of global value ``x`` (the same on every rank), each rank
    keeping only its own block: no communication."""
    return _place(x, sharding.mesh, sharding.placements)


def place_as(x: torch.Tensor, like: DTensor) -> DTensor:
    """``place`` on ``like``'s mesh and placements."""
    return _place(x, like.device_mesh, tuple(like.placements))


def place_tree(tree, shardings):
    return tree_map(place, tree, shardings)


def full(x):
    """The whole value of a DTensor (a collective: every rank calls it);
    a plain tensor as it is."""
    return x.full_tensor() if isinstance(x, DTensor) else x


def redistribute(x: DTensor, placements) -> DTensor:
    placements = tuple(placements)
    if tuple(x.placements) == placements:
        return x
    return x.redistribute(x.device_mesh, placements)


class Sharder:
    """Activation-constraint injector passed into the model forward fns.

    On a DTensor it redistributes to the placements the rules give the
    names: a layout constraint, which never changes values. On a plain
    tensor it is the identity. ``mesh`` / ``rules`` / ``zero_params`` are
    read by the code that runs explicit collectives (the a2a MoE dispatch)."""

    def __init__(self, mesh, rules: Dict[str, AxisRule], zero_params: bool = False):
        self.mesh = mesh
        self.rules = rules
        self.zero_params = zero_params

    def __call__(self, x, names):
        if not isinstance(x, DTensor):
            return x
        spec = spec_for_leaf(x.shape, names, self.rules, self.mesh)
        return redistribute(x, placements_for(spec, self.mesh))


def make_sharder(mesh, rules: Dict[str, AxisRule], zero_params: bool = False) -> Sharder:
    return Sharder(mesh, rules, zero_params)


# ---------------------------------------------------------------------------
# ops without a DTensor sharding rule: run them on each rank's shards
# ---------------------------------------------------------------------------

_SITES: Dict[str, int] = {}


def note_site(site: str) -> None:
    _SITES[site] = _SITES.get(site, 0) + 1


def taken_sites(clear: bool = False) -> List[str]:
    """The named places where a sharded dim was gathered (``run_local``,
    the head reshape) since the last clear, sorted."""
    out = sorted(_SITES)
    if clear:
        _SITES.clear()
    return out


def as_dtensor(x, mesh) -> DTensor:
    if isinstance(x, DTensor):
        return x
    return DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim, run_check=False)


def run_local(site: str, fn: Callable, acts: Sequence, keep: Sequence[int],
              params: Optional[Dict[str, Any]] = None):
    """``fn(*acts)``, or ``fn(*acts, params)`` given a dict of params, on
    plain local tensors, for an op DTensor has no rule for. Every activation
    takes the first one's layout restricted to the dims in ``keep`` (batch,
    heads) and to its own rank: those stay sharded, every other dim is
    gathered. Params are gathered whole; their gradients are summed over
    the mesh dims the activations are split on. Tensor outputs come back as
    DTensors in the first activation's layout (replicated where ``keep`` is
    empty). When the first activation is not a DTensor, ``fn`` runs as it
    is. A call that gathers a sharded dim records its site."""
    extra = () if params is None else (params,)
    first = acts[0]
    if not isinstance(first, DTensor):
        return fn(*acts, *extra)
    mesh = first.device_mesh
    keep = {k % first.ndim for k in keep}
    pl = tuple(p if isinstance(p, Shard) and p.dim in keep else Replicate()
               for p in first.placements)

    def layout(t):
        return tuple(p if not isinstance(p, Shard) or p.dim < t.ndim else Replicate()
                     for p in pl)

    dts = [as_dtensor(a, mesh) for a in acts]
    ws = {k: as_dtensor(w, mesh) for k, w in (params or {}).items()}
    if any(isinstance(p, Shard) and p != q and mesh.size(i) > 1
           for a in dts for i, (p, q) in enumerate(zip(a.placements, layout(a)))) or \
            any(isinstance(p, Shard) and mesh.size(i) > 1
                for w in ws.values() for i, p in enumerate(w.placements)):
        note_site(site)
    grad_pl = tuple(Partial() if isinstance(p, Shard) else Replicate() for p in pl)
    local_acts = [redistribute(a, layout(a)).to_local() for a in dts]
    local_params = {k: redistribute(w, [Replicate()] * mesh.ndim)
                    .to_local(grad_placements=grad_pl) for k, w in ws.items()}
    out = fn(*local_acts, *(() if params is None else (local_params,)))

    def wrap(o):
        if isinstance(o, torch.Tensor):
            return DTensor.from_local(o, mesh, layout(o), run_check=False)
        return o

    return tuple(wrap(o) for o in out) if isinstance(out, tuple) else wrap(out)

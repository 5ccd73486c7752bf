"""Expert-parallel MoE dispatch with LOCAL routing + all-to-all.

Counterpart of ``repro.models.moe_a2a``. The global dispatch routes over
the whole token set; production MoE systems route locally and exchange
token blocks with one all-to-all over the expert axis. Per rank
(data-rank r, model-rank m):

  1. local top-k routing over the rank's T_loc tokens (no communication)
  2. local dispatch buffer (Ev, C_loc, d), C_loc = max(int(cf * T_loc * k / E),
     min(T_loc, 16))
  3. all-to-all over 'model': rank m receives every rank's slots for its
     virtual experts -> (Ev / n, n * C_loc, d)
  4. [ZeRO] all-gather this layer's expert weights over 'data'
  5. local expert FFN
  6. reverse all-to-all; virtual-shard partial sums; local weighted combine

The reference runs this inside ``shard_map``; here each rank takes its
block of every DTensor input (``to_local``), runs the steps on plain
tensors with ``torch.distributed`` collectives wrapped in autograd
functions, and wraps the result back (``from_local``), stating each
input's gradient placement: a weight replicated over a mesh dim gets a
partial-sum gradient there. Differentiable end to end. ``aux`` is averaged
over every mesh axis, as the reference's ``pmean``.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from ..parallel.sharding import as_dtensor, axis_sizes, full, placements_for, redistribute
from . import moe as M


def _all_to_all(x, group):
    # contiguous in and out: ``empty_like`` of a permuted cotangent would
    # keep its strides, and the collective writes a flat buffer
    x = x.contiguous()
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=group)
    return out


class _AllToAll(torch.autograd.Function):
    """``all_to_all_single`` of equal blocks along dim 0: block j goes to
    rank j, received blocks stack in rank order. It is its own transpose."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_to_all(x, group)

    @staticmethod
    def backward(ctx, g):
        return _all_to_all(g, ctx.group), None


class _AllGather(torch.autograd.Function):
    """Tiled all-gather along ``dim``; the cotangent of a block is the sum
    of every rank's cotangent for it (all-reduce, then this rank's slice)."""

    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, x, group=group)
        return torch.cat(parts, dim)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        n = dist.get_world_size(ctx.group)
        return g.chunk(n, ctx.dim)[dist.get_rank(ctx.group)].contiguous(), None, None


class _MeanOverMesh(torch.autograd.Function):
    """The mean of a per-rank scalar over every rank of ``mesh``."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.n = mesh.size()
        y = x.clone()
        for i in range(mesh.ndim):
            dist.all_reduce(y, group=mesh.get_group(i))
        return y / ctx.n

    @staticmethod
    def backward(ctx, g):
        return g / ctx.n, None


class _ScaleGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, c: float):
        ctx.c = c
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g * ctx.c, None


def moe_apply_a2a(
    cfg,
    p: Dict,
    x,  # (B, S, d)
    mesh,
    *,
    batch_axes=("pod", "data"),
    seq_axis: Optional[str] = "model",
    expert_axis: str = "model",
    zero_axis: Optional[str] = None,  # weights additionally sharded here
):
    """All-to-all MoE FFN on ``mesh``. Returns (out (B, S, d), aux scalar):
    DTensors when ``x`` is one, else whole tensors."""
    b, s, d = x.shape
    sizes = axis_sizes(mesh)
    batch_axes = tuple(a for a in batch_axes if a in sizes)
    seq_axis = seq_axis if (seq_axis in sizes and s % sizes[seq_axis] == 0) else None
    n_shards = sizes[expert_axis]
    assert cfg.n_virtual % n_shards == 0, (cfg.n_virtual, n_shards)

    x_pl = placements_for((batch_axes or None, seq_axis, None), mesh)
    # mesh dims where every rank holds the same tokens: each copy's
    # gradient is scaled down so the copies sum to one
    dup = [i for i, pl in enumerate(x_pl) if not isinstance(pl, Shard)]
    n_dup = 1
    for i in dup:
        n_dup *= mesh.size(i)
    w_tail = {"wi": (None, zero_axis), "wg": (None, zero_axis), "wo": (zero_axis, None)}

    def local_weight(key):
        w = redistribute(as_dtensor(p[key], mesh), placements_for((expert_axis,) + w_tail[key],
                                                                   mesh))
        return w.to_local(grad_placements=[pl if isinstance(pl, Shard) else Partial()
                                           for pl in w.placements])

    xd = redistribute(as_dtensor(x, mesh), x_pl)
    xl = xd.to_local(grad_placements=[Partial() if i in dup else pl
                                      for i, pl in enumerate(x_pl)])
    router = redistribute(as_dtensor(p["router"], mesh), [Replicate()] * mesh.ndim)
    router = router.to_local(grad_placements=[Partial()] * mesh.ndim).float()
    wi, wo = local_weight("wi"), local_weight("wo")
    wg = local_weight("wg") if cfg.gated else None

    bl, sl, _ = xl.shape
    r, dest, buf = M.dispatch(cfg, router, xl.reshape(bl * sl, d))  # (Ev, C_loc, d)
    ev, cap = buf.shape[0], buf.shape[1]
    group = mesh.get_group(expert_axis)
    # all-to-all: split the virtual experts across the expert axis, gather
    # every rank's slots for the local ones
    buf = _AllToAll.apply(buf.reshape(n_shards, ev // n_shards, cap, d), group)
    buf = buf.permute(1, 0, 2, 3).reshape(ev // n_shards, n_shards * cap, d)
    if zero_axis is not None:
        zgroup = mesh.get_group(zero_axis)
        wi = _AllGather.apply(wi, 2, zgroup)
        wo = _AllGather.apply(wo, 1, zgroup)
        if wg is not None:
            wg = _AllGather.apply(wg, 2, zgroup)
    y = M.experts(cfg, buf, wi, wo, wg)
    y = y.reshape(ev // n_shards, n_shards, cap, d).permute(1, 0, 2, 3)
    y = _AllToAll.apply(y.contiguous(), group).reshape(ev, cap, d)  # (Ev, C_loc, d)
    out, aux = M.combine(cfg, y, r, dest)
    aux = _MeanOverMesh.apply(aux, mesh)  # replicated scalar
    out = out.reshape(bl, sl, d)
    if n_dup > 1:
        out = _ScaleGrad.apply(out, 1.0 / n_dup)
    out = DTensor.from_local(out, mesh, x_pl, run_check=False)
    aux = DTensor.from_local(aux, mesh, [Replicate()] * mesh.ndim, run_check=False)
    if isinstance(x, DTensor):
        return out, aux
    return full(out), full(aux)

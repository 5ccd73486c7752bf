"""Mixture-of-Experts transformer (dbrx-132b: 16e top-4, grok-1-314b: 8e top-2).

Counterpart of ``repro.models.moe``: token-choice top-k routing with a
capacity and sort-based dispatch into fixed ``(E, C, d)`` buffers, the
expert FFNs as batched matmuls over every slot, and the attention stack
of the dense transformer. With ``a2a_dispatch`` and a sharder that
carries a mesh, ``moe_apply`` takes the local-routing all-to-all dispatch
of ``moe_a2a``; without a mesh the dispatch is global, as the reference's.
On DTensors the global dispatch routes every token on every rank (its
sort, search and scatter have no DTensor rule: sites "moe dispatch" and
"moe combine") and runs the expert matmuls on the sharder's layout.

Two choices keep the result the same on every device and run: top-k
breaks ties toward the lower expert index, as ``jax.lax.top_k`` does
(``torch.topk`` promises no order), and the combine un-permutes the
weighted expert outputs into ``(T, k, d)`` and sums over k, where an
``index_add_`` on CUDA would add in an order that changes from run to run.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, NamedTuple

import torch
from torch.utils.checkpoint import checkpoint

from ..device import DeviceLike, resolve_device
from ..parallel.sharding import run_local
from . import layers as L
from . import transformer as T
from .transformer import Sharder, TransformerConfig, _id_sharder


@dataclass(frozen=True)
class MoEConfig(TransformerConfig):
    n_experts: int = 8
    top_k: int = 2
    capacity_factor: float = 1.25
    aux_loss_weight: float = 0.01
    #: expert tensor-parallel split ("virtual experts"): each expert's FFN is
    #: split into ``expert_shards`` parts along d_ff, giving
    #: n_experts * expert_shards units
    expert_shards: int = 1
    #: local routing + all-to-all dispatch (``moe_a2a``); needs a mesh
    a2a_dispatch: bool = False

    @property
    def n_virtual(self) -> int:
        return self.n_experts * self.expert_shards

    @property
    def ff_shard(self) -> int:
        assert self.d_ff % self.expert_shards == 0
        return self.d_ff // self.expert_shards

    @property
    def n_params(self) -> int:
        d, h, kv, dh, f, v = (
            self.d_model, self.n_heads, self.n_kv, self.dh, self.d_ff, self.vocab,
        )
        per_layer = d * (h * dh) + 2 * d * (kv * dh) + (h * dh) * d
        per_layer += self.n_experts * d * f * (3 if self.gated else 2)
        per_layer += d * self.n_experts + 2 * d
        return self.n_layers * per_layer + v * d + d

    @property
    def n_active_params(self) -> int:
        """Parameters touched per token."""
        d, h, kv, dh, f, v = (
            self.d_model, self.n_heads, self.n_kv, self.dh, self.d_ff, self.vocab,
        )
        per_layer = d * (h * dh) + 2 * d * (kv * dh) + (h * dh) * d
        per_layer += self.top_k * d * f * (3 if self.gated else 2)
        per_layer += d * self.n_experts
        return self.n_layers * per_layer + v * d


# ---------------------------------------------------------------------------
# params
# ---------------------------------------------------------------------------


def init_params(cfg: MoEConfig, generator: torch.Generator, device: DeviceLike = "cuda") -> Dict:
    """Random weights from ``generator`` on ``device``: the dense tree with
    the MLP replaced by a float32 router and the experts in the virtual
    expert layout ``(L, E * expert_shards, d, d_ff / expert_shards)``."""
    dev = resolve_device(device)
    n, d, f = cfg.n_layers, cfg.d_model, cfg.ff_shard

    def w(shape, in_axis, dtype=cfg.dtype):
        return L.dense_init(generator, shape, in_axis=in_axis, dtype=dtype)

    moe = {
        "router": w((n, d, cfg.n_experts), 1, torch.float32),
        "wi": L.sliced_init(generator, (n, cfg.n_virtual, d, f), 2, cfg.dtype, dev),
        "wo": L.sliced_init(generator, (n, cfg.n_virtual, f, d), 2, cfg.dtype, dev),
    }
    if cfg.gated:
        moe["wg"] = L.sliced_init(generator, (n, cfg.n_virtual, d, f), 2, cfg.dtype, dev)
    return T._to_device(T.init_tree(cfg, w, moe), dev)


params_from_jax_numpy = T.params_from_jax_numpy  # keeps the float32 router


def param_axes(cfg: MoEConfig) -> Dict:
    axes = T.param_axes(cfg)
    moe = {
        "router": ("layers", "embed", None),
        "wi": ("layers", "expert", "embed", "ffn"),
        "wo": ("layers", "expert", "ffn", "embed"),
    }
    if cfg.gated:
        moe["wg"] = ("layers", "expert", "embed", "ffn")
    axes["layers"]["mlp"] = moe
    return axes


# ---------------------------------------------------------------------------
# MoE FFN: token-choice top-k with capacity
# ---------------------------------------------------------------------------


class Routing(NamedTuple):
    probs: torch.Tensor  # (T, E) float32 router softmax
    topv: torch.Tensor  # (T, k) renormalised weights of the chosen experts
    topi: torch.Tensor  # (T, k) chosen experts, best first
    order: torch.Tensor  # (T*k,) slots (token * k + choice) sorted by expert, stable
    sorted_e: torch.Tensor  # (T*k,) expert of each sorted slot
    rank: torch.Tensor  # (T*k,) position of each sorted slot within its expert
    capacity: int

    @property
    def kept(self) -> torch.Tensor:
        """(T*k,) whether each sorted slot fits its expert's capacity."""
        return self.rank < self.capacity


def top_k(probs: torch.Tensor, k: int):
    """``jax.lax.top_k``: the k largest, best first, ties toward the lower
    index (a stable descending sort keeps equal values in index order)."""
    v, i = torch.sort(probs, dim=-1, descending=True, stable=True)
    return v[..., :k], i[..., :k]


def route(cfg: MoEConfig, router: torch.Tensor, xf: torch.Tensor) -> Routing:
    """Route tokens ``xf`` (T, d) with a float32 router (d, E)."""
    n_tok = xf.shape[0]
    e, k = cfg.n_experts, cfg.top_k
    probs = torch.softmax(xf.float() @ router, dim=-1)
    topv, topi = top_k(probs, k)
    topv = topv / topv.sum(-1, keepdim=True)
    # capacity floor: decode-sized batches never drop a token
    capacity = max(int(cfg.capacity_factor * n_tok * k / e), min(n_tok, 16))
    flat_e = topi.reshape(-1)
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    rank = (torch.arange(n_tok * k, device=xf.device)
            - torch.searchsorted(sorted_e, sorted_e, side="left"))
    return Routing(probs, topv, topi, order, sorted_e, rank, capacity)


def dispatch(cfg: MoEConfig, router: torch.Tensor, xf: torch.Tensor):
    """Route ``xf`` (T, d) and scatter it into the expert buffers: returns
    (routing, dest, buf (Ev, C, d)). ``dest`` is each sorted slot's row in
    the flat buffer; a slot past its expert's capacity goes to a spare last
    row, which is dropped."""
    e, k, d = cfg.n_experts, cfg.top_k, xf.shape[1]
    r = route(cfg, router, xf)
    cap = r.capacity
    dest = torch.where(r.kept, r.sorted_e * cap + r.rank, e * cap)
    buf = xf.new_zeros((e * cap + 1, d)).index_put((dest,), xf[r.order // k])
    buf = buf[:-1].view(e, cap, d)
    if cfg.expert_shards > 1:
        # virtual experts: every token buffer feeds its expert's FFN shards
        buf = buf.repeat_interleave(cfg.expert_shards, dim=0)  # (Ev, C, d)
    return r, dest, buf


def experts(cfg: MoEConfig, buf, wi, wo, wg=None):
    """The expert FFNs over every slot: (Ev, C, d) -> (Ev, C, d)."""
    h = torch.bmm(buf, wi)
    if cfg.gated:
        h = L.ACTIVATIONS[cfg.act](torch.bmm(buf, wg)) * h
    else:
        h = L.ACTIVATIONS[cfg.act](h)
    return torch.bmm(h, wo)


def combine(cfg: MoEConfig, y, r: Routing, dest):
    """Expert outputs y (Ev, C, d) back to tokens: (out (T, d), aux)."""
    e, k = cfg.n_experts, cfg.top_k
    cap, d = r.capacity, y.shape[-1]
    n_tok = r.topi.shape[0]
    if cfg.expert_shards > 1:
        # partial outputs of the ff shards sum back to real experts
        y = y.view(e, cfg.expert_shards, cap, d).sum(1)
    # each sorted slot's expert output (0 where dropped), weighted, back at
    # its (token, choice) position, then summed over the choices
    y = torch.cat([y.reshape(e * cap, d), y.new_zeros((1, d))])
    w = r.topv.reshape(-1)[r.order].to(y.dtype)
    weighted = y[dest] * w[:, None]
    out = torch.empty_like(weighted).index_put((r.order,), weighted)
    out = out.view(n_tok, k, d).sum(1)
    # load-balancing auxiliary loss (Switch/GShard style)
    # one_hot checks its range by reading the ids back to the host off the
    # card; a comparison with the expert ids gives the same counts on every
    # device and reads nothing
    hits = r.topi[..., None] == torch.arange(e, device=r.topi.device)
    dispatch_frac = hits.float().sum(1).mean(0)
    prob_frac = r.probs.mean(0)
    aux = e * torch.sum(dispatch_frac / k * prob_frac)
    return out, aux


def moe_apply(cfg: MoEConfig, p: Dict, x: torch.Tensor, sharder: Sharder = _id_sharder):
    """x (B, S, d) -> (out (B, S, d), aux_loss scalar)."""
    mesh = getattr(sharder, "mesh", None)
    if cfg.a2a_dispatch and mesh is not None:
        from .moe_a2a import moe_apply_a2a

        zero = "data" if getattr(sharder, "zero_params", False) else None
        return moe_apply_a2a(cfg, p, x, mesh, zero_axis=zero)
    # ZeRO-3 (zero_params) stores expert weights data-sharded: constrain the
    # layer's slice to its tensor-parallel layout here, once per layer
    p = dict(p)
    for key in ("wi", "wg"):
        if key in p:
            p[key] = sharder(p[key], ("expert", "embed", "ffn"))
    p["wo"] = sharder(p["wo"], ("expert", "ffn", "embed"))
    b, s, d = x.shape
    routed = {}

    def dispatch_all(x_, w):
        routed["r"], routed["dest"], buf_ = dispatch(cfg, w["router"], x_.reshape(b * s, d))
        return buf_

    buf = run_local("moe dispatch", dispatch_all, (x,), keep=(), params={"router": p["router"]})
    buf = sharder(buf, ("expert", "capacity", "embed"))
    y = experts(cfg, buf, p["wi"], p["wo"], p.get("wg"))
    y = sharder(y, ("expert", "capacity", "embed"))
    out, aux = run_local("moe combine", lambda y_: combine(cfg, y_, routed["r"], routed["dest"]),
                         (y,), keep=())
    return out.view(b, s, d), aux


# ---------------------------------------------------------------------------
# forward / loss / serving
# ---------------------------------------------------------------------------


def _block(cfg, lp, x, positions, prefix_len, sharder: Sharder = _id_sharder):
    a, kv = T._attn_block(cfg, lp["attn"], T._apply_norm(cfg, lp["ln1"], x), positions,
                          prefix_len, sharder)
    x = x + a
    x = sharder(x, ("batch", "seq", "embed"))
    m, aux = moe_apply(cfg, lp["mlp"], T._apply_norm(cfg, lp["ln2"], x), sharder)
    m = sharder(m, ("batch", "seq", "embed"))
    return x + m, kv, aux


def forward(cfg: MoEConfig, params: Dict, x: torch.Tensor, positions: torch.Tensor,
            prefix_len=None, sharder: Sharder = _id_sharder, collect_kv: bool = False):
    """x (B, S, d) -> (final-normed hidden, mean aux loss over layers,
    stacked (k, v) when ``collect_kv``); remat as the dense forward."""
    remat = cfg.remat and torch.is_grad_enabled()
    aux_sum = torch.zeros((), device=x.device)
    ks, vs = [], []
    for lp in T._layers(params["layers"], cfg.n_layers):
        if remat:
            x, (k, v), aux = checkpoint(_block, cfg, lp, x, positions, prefix_len, sharder,
                                        use_reentrant=False)
        else:
            x, (k, v), aux = _block(cfg, lp, x, positions, prefix_len, sharder)
        aux_sum = aux_sum + aux
        if collect_kv:
            ks.append(k)
            vs.append(v)
    h = T._apply_norm(cfg, params["final_norm"], x)
    kvs = (torch.stack(ks), torch.stack(vs)) if collect_kv else None
    return h, aux_sum / cfg.n_layers, kvs


def loss_fn(cfg: MoEConfig, params, batch, sharder: Sharder = _id_sharder) -> torch.Tensor:
    tokens = batch["tokens"]
    b, s = tokens.shape
    x = T.embed_tokens(cfg, params, tokens)
    x = sharder(x, ("batch", "seq", "embed"))
    h, aux, _ = forward(cfg, params, x, T._positions(b, s, tokens.device), sharder=sharder)
    logits = T.logits_from_hidden(cfg, params, h[:, :-1])
    return (L.softmax_xent(logits, tokens[:, 1:], batch.get("loss_mask"))
            + cfg.aux_loss_weight * aux)


init_cache = T.init_cache


@torch.no_grad()
def prefill(cfg, params, batch, cache, sharder: Sharder = _id_sharder):
    tokens = batch["tokens"]
    b, s = tokens.shape
    x = T.embed_tokens(cfg, params, tokens)
    h, _aux, kvs = forward(cfg, params, x, T._positions(b, s, tokens.device), sharder=sharder,
                           collect_kv=True)
    return T.logits_from_hidden(cfg, params, h[:, -1:]), T.fill_cache(cache, kvs, s)


@torch.no_grad()
def decode_step(cfg, params, cache, tokens, sharder: Sharder = _id_sharder):
    """One token per sequence; as the reference's, the MoE layers run with
    the identity sharder."""
    return T.decode_layers(cfg, params, cache, tokens,
                           lambda lp, h: moe_apply(cfg, lp["mlp"], h)[0])

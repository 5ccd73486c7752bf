"""Mixture-of-Experts transformer (dbrx-132b: 16e top-4, grok-1-314b: 8e top-2).

Counterpart of ``repro.models.moe``: token-choice top-k routing with a
capacity and sort-based dispatch into fixed ``(E, C, d)`` buffers, the
expert FFNs as batched matmuls over every slot, and the attention stack
of the dense transformer. Only the single-device dispatch is ported; the
all-to-all dispatch (``a2a_dispatch``) waits for the parallelism port, and
the reference also ignores it without a mesh.

Two choices keep the result the same on every device and run: top-k
breaks ties toward the lower expert index, as ``jax.lax.top_k`` does
(``torch.topk`` promises no order), and the combine un-permutes the
weighted expert outputs into ``(T, k, d)`` and sums over k, where an
``index_add_`` on CUDA would add in an order that changes from run to run.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Dict, NamedTuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from ..device import DeviceLike, resolve_device
from . import layers as L
from . import transformer as T
from .transformer import TransformerConfig


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
    #: local routing + all-to-all dispatch; needs a mesh (parallelism port)
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

#: host threads that draw expert slices at once
_INIT_WORKERS = 8


def _expert_init(cfg: MoEConfig, generator: torch.Generator, shape, dev) -> torch.Tensor:
    """Stacked expert weights ``(L, Ev, a, b)`` with fan-in ``a``, in
    ``cfg.dtype`` on ``dev``. Each (layer, expert) slice is drawn by its own
    CPU generator, seeded in order from ``generator``, so a seed gives the
    same weights on every device; slices are drawn by a few host threads at
    once and copied straight into the preallocated stacked tensor, so the
    host holds a few slices at a time, not the whole leaf in float32."""
    n_l, n_e = shape[:2]
    seeds = torch.randint(2**62, (n_l * n_e,), generator=generator).tolist()
    out = torch.empty(shape, dtype=cfg.dtype, device=dev)

    def draw(i):
        g = torch.Generator().manual_seed(seeds[i])
        return L.dense_init(g, shape[2:], in_axis=0, dtype=cfg.dtype)

    with ThreadPoolExecutor(_INIT_WORKERS) as pool:
        for i, w in enumerate(pool.map(draw, range(n_l * n_e))):
            out[i // n_e, i % n_e] = w
    return out


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
        "wi": _expert_init(cfg, generator, (n, cfg.n_virtual, d, f), dev),
        "wo": _expert_init(cfg, generator, (n, cfg.n_virtual, f, d), dev),
    }
    if cfg.gated:
        moe["wg"] = _expert_init(cfg, generator, (n, cfg.n_virtual, d, f), dev)
    return T._to_device(T.init_tree(cfg, w, moe), dev)


def params_from_jax_numpy(cfg: MoEConfig, tree: Dict, device: DeviceLike = "cuda") -> Dict:
    """The dense converter, with the router kept in float32 as the
    reference keeps it whatever ``cfg.dtype`` is."""
    params = T.params_from_jax_numpy(cfg, tree, device)
    router = np.array(tree["layers"]["mlp"]["router"], dtype=np.float32)
    params["layers"]["mlp"]["router"] = torch.from_numpy(router).to(resolve_device(device))
    return params


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


def moe_apply(cfg: MoEConfig, p: Dict, x: torch.Tensor):
    """x (B, S, d) -> (out (B, S, d), aux_loss scalar), the reference's
    ``moe_apply`` without a mesh."""
    b, s, d = x.shape
    n_tok = b * s
    e, k = cfg.n_experts, cfg.top_k
    xf = x.reshape(n_tok, d)
    r = route(cfg, p["router"], xf)
    cap = r.capacity
    # dispatch into (E, C, d); a slot past its expert's capacity goes to a
    # spare last row, which is dropped
    dest = torch.where(r.kept, r.sorted_e * cap + r.rank, e * cap)
    buf = xf.new_zeros((e * cap + 1, d)).index_put((dest,), xf[r.order // k])
    buf = buf[:-1].view(e, cap, d)
    if cfg.expert_shards > 1:
        # virtual experts: every token buffer feeds its expert's FFN shards
        buf = buf.repeat_interleave(cfg.expert_shards, dim=0)  # (Ev, C, d)
    h = torch.bmm(buf, p["wi"])
    if cfg.gated:
        h = L.ACTIVATIONS[cfg.act](torch.bmm(buf, p["wg"])) * h
    else:
        h = L.ACTIVATIONS[cfg.act](h)
    y = torch.bmm(h, p["wo"])
    if cfg.expert_shards > 1:
        # partial outputs of the ff shards sum back to real experts
        y = y.view(e, cfg.expert_shards, cap, d).sum(1)
    # combine: each sorted slot's expert output (0 where dropped), weighted,
    # back at its (token, choice) position, then summed over the choices
    y = torch.cat([y.reshape(e * cap, d), y.new_zeros((1, d))])
    w = r.topv.reshape(-1)[r.order].to(y.dtype)
    weighted = y[dest] * w[:, None]
    out = torch.empty_like(weighted).index_put((r.order,), weighted)
    out = out.view(n_tok, k, d).sum(1)
    # load-balancing auxiliary loss (Switch/GShard style)
    dispatch_frac = torch.nn.functional.one_hot(r.topi, e).float().sum(1).mean(0)
    prob_frac = r.probs.mean(0)
    aux = e * torch.sum(dispatch_frac / k * prob_frac)
    return out.view(b, s, d), aux


# ---------------------------------------------------------------------------
# forward / loss / serving
# ---------------------------------------------------------------------------


def _block(cfg, lp, x, positions, prefix_len):
    a, kv = T._attn_block(cfg, lp["attn"], T._apply_norm(cfg, lp["ln1"], x), positions,
                          prefix_len)
    x = x + a
    m, aux = moe_apply(cfg, lp["mlp"], T._apply_norm(cfg, lp["ln2"], x))
    return x + m, kv, aux


def forward(cfg: MoEConfig, params: Dict, x: torch.Tensor, positions: torch.Tensor,
            prefix_len=None, collect_kv: bool = False):
    """x (B, S, d) -> (final-normed hidden, mean aux loss over layers,
    stacked (k, v) when ``collect_kv``); remat as the dense forward."""
    remat = cfg.remat and torch.is_grad_enabled()
    aux_sum = torch.zeros((), device=x.device)
    ks, vs = [], []
    for lp in T._layers(params["layers"], cfg.n_layers):
        if remat:
            x, (k, v), aux = checkpoint(_block, cfg, lp, x, positions, prefix_len,
                                        use_reentrant=False)
        else:
            x, (k, v), aux = _block(cfg, lp, x, positions, prefix_len)
        aux_sum = aux_sum + aux
        if collect_kv:
            ks.append(k)
            vs.append(v)
    h = T._apply_norm(cfg, params["final_norm"], x)
    kvs = (torch.stack(ks), torch.stack(vs)) if collect_kv else None
    return h, aux_sum / cfg.n_layers, kvs


def loss_fn(cfg: MoEConfig, params, batch) -> torch.Tensor:
    tokens = batch["tokens"]
    b, s = tokens.shape
    x = T.embed_tokens(cfg, params, tokens)
    h, aux, _ = forward(cfg, params, x, T._positions(b, s, tokens.device))
    logits = T.logits_from_hidden(cfg, params, h[:, :-1])
    return (L.softmax_xent(logits, tokens[:, 1:], batch.get("loss_mask"))
            + cfg.aux_loss_weight * aux)


init_cache = T.init_cache


@torch.no_grad()
def prefill(cfg, params, batch, cache):
    tokens = batch["tokens"]
    b, s = tokens.shape
    x = T.embed_tokens(cfg, params, tokens)
    h, _aux, kvs = forward(cfg, params, x, T._positions(b, s, tokens.device), collect_kv=True)
    return T.logits_from_hidden(cfg, params, h[:, -1:]), T.fill_cache(cache, kvs, s)


@torch.no_grad()
def decode_step(cfg, params, cache, tokens):
    return T.decode_layers(cfg, params, cache, tokens,
                           lambda lp, h: moe_apply(cfg, lp["mlp"], h)[0])

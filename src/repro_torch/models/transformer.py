"""Dense decoder-only transformer LM (GQA + RoPE, optional SWA / prefix-LM).

Counterpart of ``repro.models.transformer``. Params
are a nested dict of tensors in the JAX package's tree layout, per-layer
weights stacked on a leading ``(n_layers, ...)`` axis, so a JAX param tree
converts leaf for leaf (``params_from_jax_numpy``). Layers run in a Python
loop. Caches are updated in place where the reference threads them
functionally.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from ..device import DeviceLike, resolve_device
from . import layers as L


@dataclass(frozen=True)
class TransformerConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None
    norm: str = "rmsnorm"  # rmsnorm | layernorm
    act: str = "gelu"
    gated: bool = False
    rope_theta: float = 10_000.0
    window: Optional[int] = None  # sliding-window attention
    tie_embeddings: bool = True
    embed_scale: bool = False  # gemma-style sqrt(d) embedding multiplier
    prefix_lm: bool = False  # bidirectional prefix (paligemma)
    dtype: torch.dtype = torch.bfloat16
    remat: bool = True  # recompute each layer's activations in the backward pass

    @property
    def dh(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def n_params(self) -> int:
        d, h, kv, dh, f, v = (
            self.d_model, self.n_heads, self.n_kv, self.dh, self.d_ff, self.vocab,
        )
        per_layer = d * (h * dh) + 2 * d * (kv * dh) + (h * dh) * d
        per_layer += d * f * (3 if self.gated else 2) + 2 * d
        total = self.n_layers * per_layer + v * d + d
        if not self.tie_embeddings:
            total += d * v
        return total


# ---------------------------------------------------------------------------
# params
# ---------------------------------------------------------------------------


def _norm_init(cfg, shape):
    p = {"scale": torch.ones(shape, dtype=cfg.dtype)}
    if cfg.norm == "layernorm":
        p["bias"] = torch.zeros(shape, dtype=cfg.dtype)
    return p


def _apply_norm(cfg, p, x):
    if cfg.norm == "layernorm":
        return L.layernorm(x, p["scale"], p["bias"])
    return L.rmsnorm(x, p["scale"])


def _to_device(tree, device):
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    return tree.to(device)


def init_params(cfg: TransformerConfig, generator: torch.Generator,
                device: DeviceLike = "cuda") -> Dict:
    """Random weights from ``generator`` (a CPU generator: the same seed
    gives the same weights on every device), moved to ``device``."""
    dev = resolve_device(device)
    d, f, n = cfg.d_model, cfg.d_ff, cfg.n_layers

    def w(shape, in_axis):
        return L.dense_init(generator, shape, in_axis=in_axis, dtype=cfg.dtype)

    mlp = {"wi": w((n, d, f), 1), "wo": w((n, f, d), 1)}
    if cfg.gated:
        mlp["wg"] = w((n, d, f), 1)
    return _to_device(init_tree(cfg, w, mlp), dev)


def init_tree(cfg: TransformerConfig, w, mlp: Dict) -> Dict:
    """The param tree around the feed-forward leaves ``mlp``: embedding,
    norms, attention and the untied head, drawn by ``w(shape, in_axis)`` in
    that order."""
    d, h, kv, dh, n = cfg.d_model, cfg.n_heads, cfg.n_kv, cfg.dh, cfg.n_layers
    params = {
        "embed": w((cfg.vocab, d), 1),
        "layers": {
            "ln1": _norm_init(cfg, (n, d)),
            "attn": {
                "wq": w((n, d, h * dh), 1),
                "wk": w((n, d, kv * dh), 1),
                "wv": w((n, d, kv * dh), 1),
                "wo": w((n, h * dh, d), 1),
            },
            "ln2": _norm_init(cfg, (n, d)),
            "mlp": mlp,
        },
        "final_norm": _norm_init(cfg, (d,)),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = w((d, cfg.vocab), 0)
    return params


def params_from_jax_numpy(cfg: TransformerConfig, tree: Dict,
                          device: DeviceLike = "cuda") -> Dict:
    """The port's params from a JAX param tree whose leaves are numpy arrays
    (``jax.tree.map(np.asarray, params)``); same nesting, stacked leaves."""
    dev = resolve_device(device)

    def conv(x):
        if isinstance(x, dict):
            return {k: conv(v) for k, v in x.items()}
        # through float32: numpy has no bfloat16, and ml_dtypes arrays do
        # not convert to torch directly
        return torch.from_numpy(np.array(x, dtype=np.float32)).to(device=dev, dtype=cfg.dtype)

    return conv(tree)


def _layers(params: Dict, n: int) -> List[Dict]:
    """Each layer's slice of the stacked per-layer weights, taken by one
    ``unbind`` per leaf: its backward stacks the layers' gradients once,
    where indexing layer by layer would build a full-size gradient of the
    stacked leaf for every layer (the reference's scan writes each layer's
    slice in place)."""
    per_leaf = {k: _layers(v, n) if isinstance(v, dict) else v.unbind(0)
                for k, v in params.items()}
    return [{k: v[i] for k, v in per_leaf.items()} for i in range(n)]


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------


def _qkv(cfg, p, x, positions):
    b, s, _ = x.shape
    h, kv, dh = cfg.n_heads, cfg.n_kv, cfg.dh
    q = (x @ p["wq"]).reshape(b, s, h, dh)
    k = (x @ p["wk"]).reshape(b, s, kv, dh)
    v = (x @ p["wv"]).reshape(b, s, kv, dh)
    q = L.apply_rope(q, positions, cfg.rope_theta)
    k = L.apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _attn_block(cfg, p, x, positions, prefix_len):
    """Self-attention of normed input x (B, S, d) -> (out (B, S, d), (k, v));
    shared by the dense and MoE blocks."""
    b, s, _ = x.shape
    q, k, v = _qkv(cfg, p, x, positions)
    o = L.flash_attention(q, k, v, causal=True, window=cfg.window, prefix_len=prefix_len)
    return o.reshape(b, s, -1) @ p["wo"], (k, v)


def _block(cfg, lp, x, positions, prefix_len):
    a, kv = _attn_block(cfg, lp["attn"], _apply_norm(cfg, lp["ln1"], x), positions, prefix_len)
    x = x + a
    m = L.mlp_apply(lp["mlp"], _apply_norm(cfg, lp["ln2"], x), cfg.act, cfg.gated)
    return x + m, kv


def forward(cfg: TransformerConfig, params: Dict, x: torch.Tensor, positions: torch.Tensor,
            prefix_len=None, collect_kv: bool = False):
    """x (B, S, d) embedded input -> final-normed hidden (B, S, d), and the
    per-layer (k, v) stacked to (L, B, S, KVH, Dh) when ``collect_kv``.

    With ``cfg.remat`` and gradients enabled, each layer runs under
    ``torch.utils.checkpoint``: only its input is kept for the backward
    pass, which recomputes the rest (the reference's ``jax.checkpoint``).
    Serving runs under ``torch.no_grad`` and never takes that path."""
    remat = cfg.remat and torch.is_grad_enabled()
    ks, vs = [], []
    for lp in _layers(params["layers"], cfg.n_layers):
        if remat:
            x, (k, v) = checkpoint(_block, cfg, lp, x, positions, prefix_len,
                                   use_reentrant=False)
        else:
            x, (k, v) = _block(cfg, lp, x, positions, prefix_len)
        if collect_kv:
            ks.append(k)
            vs.append(v)
    h = _apply_norm(cfg, params["final_norm"], x)
    kvs = (torch.stack(ks), torch.stack(vs)) if collect_kv else None
    return h, kvs


def embed_tokens(cfg, params, tokens):
    x = params["embed"][tokens.long()]
    if cfg.embed_scale:
        x = x * torch.tensor(cfg.d_model, dtype=x.dtype).sqrt()
    return x


def logits_from_hidden(cfg, params, h):
    w = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return h @ w


def _positions(b: int, s: int, device) -> torch.Tensor:
    return torch.arange(s, device=device).expand(b, s)


def loss_fn(cfg: TransformerConfig, params, batch) -> torch.Tensor:
    tokens = batch["tokens"]  # (B, S)
    b, s = tokens.shape
    x = embed_tokens(cfg, params, tokens)
    h, _ = forward(cfg, params, x, _positions(b, s, tokens.device),
                   prefix_len=batch.get("prefix_len"))
    logits = logits_from_hidden(cfg, params, h[:, :-1])
    return L.softmax_xent(logits, tokens[:, 1:], batch.get("loss_mask"))


# ---------------------------------------------------------------------------
# serving: prefill + dense-cache decode
# ---------------------------------------------------------------------------


def init_cache(cfg: TransformerConfig, batch: int, max_len: int,
               device: DeviceLike = "cuda") -> Dict:
    dev = resolve_device(device)
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv, cfg.dh)
    return {
        "k": torch.zeros(shape, dtype=cfg.dtype, device=dev),
        "v": torch.zeros(shape, dtype=cfg.dtype, device=dev),
        "length": torch.zeros((batch,), dtype=torch.int32, device=dev),
    }


@torch.no_grad()
def prefill(cfg, params, batch, cache):
    """Run the prompt through the model, fill the cache (in place), return
    the last position's logits (B, 1, V) and the cache. No gradients: the
    serving path never takes the remat wrapper."""
    tokens = batch["tokens"]  # (B, S_prompt)
    b, s = tokens.shape
    x = embed_tokens(cfg, params, tokens)
    h, kvs = forward(cfg, params, x, _positions(b, s, tokens.device),
                     prefix_len=batch.get("prefix_len"), collect_kv=True)
    return logits_from_hidden(cfg, params, h[:, -1:]), fill_cache(cache, kvs, s)


def fill_cache(cache, kvs, s: int):
    """Write a prompt's stacked (k, v) (L, B, S, KVH, Dh) at positions
    0..s-1 of the cache, in place, and set every length to ``s``."""
    k, v = kvs
    cache["k"][:, :, :s] = k
    cache["v"][:, :, :s] = v
    cache["length"].fill_(s)
    return cache


@torch.no_grad()
def decode_step(cfg, params, cache, tokens):
    """One token per sequence through the dense KV cache (updated in place).
    tokens: (B,) -> logits (B, V), cache."""
    return decode_layers(cfg, params, cache, tokens,
                         lambda lp, h: L.mlp_apply(lp["mlp"], h, cfg.act, cfg.gated))


def decode_layers(cfg, params, cache, tokens, ffn):
    """The decode step with ``ffn(layer params, normed h) -> (B, 1, d)`` as
    each layer's feed-forward half (the dense MLP, or the MoE layer)."""
    b = tokens.shape[0]
    lengths = cache["length"]  # (B,)
    x = embed_tokens(cfg, params, tokens[:, None])  # (B, 1, d)
    positions = lengths.long()[:, None]
    rows = torch.arange(b, device=tokens.device)
    for i, lp in enumerate(_layers(params["layers"], cfg.n_layers)):
        q, k, v = _qkv(cfg, lp["attn"], _apply_norm(cfg, lp["ln1"], x), positions)
        kc, vc = cache["k"][i], cache["v"][i]
        # write the new token into the cache at each sequence's length
        kc[rows, positions[:, 0]] = k[:, 0].to(kc.dtype)
        vc[rows, positions[:, 0]] = v[:, 0].to(vc.dtype)
        o = L.decode_attention_dense(q, kc, vc, lengths + 1, window=cfg.window)
        x = x + o.reshape(b, 1, -1) @ lp["attn"]["wo"]
        x = x + ffn(lp, _apply_norm(cfg, lp["ln2"], x))
    h = _apply_norm(cfg, params["final_norm"], x)
    cache["length"] = lengths + 1
    return logits_from_hidden(cfg, params, h)[:, 0], cache

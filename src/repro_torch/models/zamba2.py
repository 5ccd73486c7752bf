"""Zamba2: a Mamba2 backbone with one SHARED attention + MLP block interleaved.

Counterpart of ``repro.models.zamba2`` (arXiv:2411.15242, simplified as
there): ``n_layers`` mamba2 mixers; after every ``attn_every``-th mixer the
single shared transformer block (one set of weights, applied ``n_apps``
times) runs over the hidden state, each application with its own KV cache.
Layers are grouped so KV is kept only at the shared block's applications.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from ..device import DeviceLike, resolve_device
from ..parallel.sharding import run_local
from . import layers as L
from . import mamba2 as M2
from . import transformer as T
from .transformer import Sharder, _id_sharder


@dataclass(frozen=True)
class Zamba2Config:
    name: str
    n_layers: int = 38
    d_model: int = 2048
    n_heads: int = 32
    n_kv: int = 32
    d_ff: int = 8192
    vocab: int = 32000
    d_state: int = 64
    attn_every: int = 6
    head_dim: Optional[int] = None
    rope_theta: float = 10_000.0
    act: str = "silu"
    gated: bool = True
    chunk: int = 64
    dtype: torch.dtype = torch.bfloat16
    remat: bool = True

    @property
    def dh(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def mamba(self) -> M2.Mamba2Config:
        return M2.Mamba2Config(d_model=self.d_model, d_state=self.d_state, chunk=self.chunk)

    @property
    def n_apps(self) -> int:
        return self.n_layers // self.attn_every

    @property
    def groups(self) -> List[Tuple[int, int, bool]]:
        """(start_layer, n_mamba_layers, has_attn) blocks."""
        out = []
        l = 0
        for _ in range(self.n_apps):
            out.append((l, self.attn_every, True))
            l += self.attn_every
        if l < self.n_layers:
            out.append((l, self.n_layers - l, False))
        return out

    @property
    def n_params(self) -> int:
        m = self.mamba
        per_mamba = (
            self.d_model * (2 * m.d_inner + 2 * m.d_state + m.n_heads)
            + m.d_conv * m.conv_channels + m.conv_channels
            + 3 * m.n_heads + m.d_inner + m.d_inner * self.d_model
        )
        shared = (
            self.d_model * (self.n_heads + 2 * self.n_kv) * self.dh
            + self.n_heads * self.dh * self.d_model
            + self.d_model * self.d_ff * (3 if self.gated else 2)
            + 4 * self.d_model
        )
        return (self.n_layers * per_mamba + shared
                + self.vocab * self.d_model + 2 * self.d_model)


# ---------------------------------------------------------------------------
# params
# ---------------------------------------------------------------------------


def init_params(cfg: Zamba2Config, generator: torch.Generator,
                device: DeviceLike = "cuda") -> Dict:
    """Random weights from ``generator`` (a CPU generator) on ``device``, in
    the reference's tree; drawn in its key order (shared attention, shared
    MLP, embedding, mixers)."""
    dev = resolve_device(device)
    d, h, kv, dh, dt = cfg.d_model, cfg.n_heads, cfg.n_kv, cfg.dh, cfg.dtype

    def w(shape, in_axis=0):
        return L.dense_init(generator, shape, in_axis=in_axis, dtype=dt).to(dev)

    attn = {"wq": w((d, h * dh)), "wk": w((d, kv * dh)), "wv": w((d, kv * dh)),
            "wo": w((h * dh, d))}
    mlp = {k: v.to(dev) for k, v in L.mlp_init(generator, d, cfg.d_ff, cfg.gated, dt).items()}
    embed = w((cfg.vocab, d), 1)

    def ones(shape):
        return torch.ones(shape, dtype=dt, device=dev)

    return {
        "embed": embed,
        "mamba": M2.block_init(cfg.mamba, generator, cfg.n_layers, dt, dev),
        "mamba_ln": ones((cfg.n_layers, d)),
        "shared": {"ln1": ones((d,)), "attn": attn, "ln2": ones((d,)), "mlp": mlp},
        "final_norm": ones((d,)),
    }


#: keeps ``A_log``, ``D`` and ``dt_bias`` float32 in a bf16 model
params_from_jax_numpy = T.params_from_jax_numpy


def param_axes(cfg: Zamba2Config) -> Dict:
    return {
        "embed": ("vocab", "embed"),
        "mamba": M2.block_axes(cfg.mamba),
        "mamba_ln": ("layers", "embed"),
        "shared": {
            "ln1": ("embed",),
            "attn": {
                "wq": ("embed", "heads"),
                "wk": ("embed", "kv_heads"),
                "wv": ("embed", "kv_heads"),
                "wo": ("heads", "embed"),
            },
            "ln2": ("embed",),
            "mlp": L.mlp_axes(cfg.gated),
        },
        "final_norm": ("embed",),
    }


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------


def _shared_attn(cfg, sp, x, positions, sharder: Sharder = _id_sharder):
    b, s, _ = x.shape
    h, kv, dh = cfg.n_heads, cfg.n_kv, cfg.dh
    xin = L.rmsnorm(x, sp["ln1"])
    q = L.split_heads(xin @ sp["attn"]["wq"], h, dh)
    k = L.split_heads(xin @ sp["attn"]["wk"], kv, dh)
    v = L.split_heads(xin @ sp["attn"]["wv"], kv, dh)
    q = sharder(q, ("batch", None, "heads", None))
    q = L.apply_rope(q, positions, cfg.rope_theta)
    k = L.apply_rope(k, positions, cfg.rope_theta)
    o = L.flash_attention(q, k, v, causal=True)
    x = x + L.merge_heads(o) @ sp["attn"]["wo"]
    m = L.mlp_apply(sp["mlp"], L.rmsnorm(x, sp["ln2"]), cfg.act, cfg.gated)
    return x + sharder(m, ("batch", "seq", "embed")), (k, v)


def _mamba_layer(cfg, lp, ln, x, sharder: Sharder = _id_sharder):
    """One residual mixer layer. On DTensors the mixer (its projections'
    splits, the causal conv, the chunked scan) runs on each rank's batch
    rows with its weights gathered (site "mamba2 block")."""
    y = run_local("mamba2 block", lambda x_, p: M2.apply_block(cfg.mamba, p, x_),
                  (L.rmsnorm(x, ln),), keep=(0,), params=lp)
    return sharder(x + y, ("batch", "seq", "embed"))


def _mamba_group(cfg, layers, lns, x, lo: int, n: int, sharder: Sharder = _id_sharder):
    """Layers ``lo .. lo + n - 1``; each under ``torch.utils.checkpoint``
    with ``cfg.remat`` and gradients enabled (the reference's
    ``jax.checkpoint`` around its scan body)."""
    remat = cfg.remat and torch.is_grad_enabled()
    for li in range(lo, lo + n):
        if remat:
            x = checkpoint(_mamba_layer, cfg, layers[li], lns[li], x, sharder,
                           use_reentrant=False)
        else:
            x = _mamba_layer(cfg, layers[li], lns[li], x, sharder)
    return x


def forward(cfg: Zamba2Config, params: Dict, x: torch.Tensor, positions: torch.Tensor,
            sharder: Sharder = _id_sharder, collect_kv: bool = False):
    """x (B, S, d) embedded -> final-normed hidden, and the shared block's
    (k, v) per application stacked to (A, B, S, KVH, Dh) when ``collect_kv``."""
    layers = T._layers(params["mamba"], cfg.n_layers)
    lns = params["mamba_ln"].unbind(0)
    kvs = []
    for lo, n, has_attn in cfg.groups:
        x = _mamba_group(cfg, layers, lns, x, lo, n, sharder)
        if has_attn:
            x, kv = _shared_attn(cfg, params["shared"], x, positions, sharder)
            kvs.append(kv)
    x = L.rmsnorm(x, params["final_norm"])
    if collect_kv:
        return x, (torch.stack([k for k, _ in kvs]), torch.stack([v for _, v in kvs]))
    return x, None


def loss_fn(cfg: Zamba2Config, params, batch, sharder: Sharder = _id_sharder) -> torch.Tensor:
    tokens = batch["tokens"]
    b, s = tokens.shape
    x = L.embed(params["embed"], tokens)
    x = sharder(x, ("batch", "seq", "embed"))
    h, _ = forward(cfg, params, x, T._positions(b, s, tokens.device), sharder)
    logits = h[:, :-1] @ params["embed"].T
    return L.softmax_xent(logits, tokens[:, 1:], batch.get("loss_mask"))


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------


def cache_axes(cfg: Zamba2Config) -> Dict:
    return {
        "k": (None, "batch", "kv_seq", "kv_heads", None),
        "v": (None, "batch", "kv_seq", "kv_heads", None),
        "ssm": ("layers", "batch", "ssm_heads", None, None),
        "conv": ("layers", "batch", None, "inner_conv"),
        "length": ("batch",),
    }


def init_cache(cfg: Zamba2Config, batch: int, max_len: int,
               device: DeviceLike = "cuda") -> Dict:
    dev = resolve_device(device)
    m = cfg.mamba
    kv_shape = (cfg.n_apps, batch, max_len, cfg.n_kv, cfg.dh)
    return {
        "k": torch.zeros(kv_shape, dtype=cfg.dtype, device=dev),
        "v": torch.zeros(kv_shape, dtype=cfg.dtype, device=dev),
        "ssm": torch.zeros((cfg.n_layers, batch, m.n_heads, m.head_p, cfg.d_state), device=dev),
        "conv": torch.zeros((cfg.n_layers, batch, m.d_conv - 1, m.conv_channels),
                            dtype=cfg.dtype, device=dev),
        "length": torch.zeros((batch,), dtype=torch.int32, device=dev),
    }


@torch.no_grad()
def prefill(cfg, params, batch, cache, sharder: Sharder = _id_sharder):
    """The prompt through the chunked mixers, keeping each layer's final SSM
    and conv state, and the shared block's K/V per application; fills the
    cache in place and returns the last position's logits (B, 1, V)."""
    tokens = batch["tokens"]
    b, s = tokens.shape
    positions = T._positions(b, s, tokens.device)
    x = L.embed(params["embed"], tokens)
    layers = T._layers(params["mamba"], cfg.n_layers)
    app = 0
    for lo, n, has_attn in cfg.groups:
        for li in range(lo, lo + n):
            xin = L.rmsnorm(x, params["mamba_ln"][li])
            y, hstate, cstate = M2.apply_block_with_state(cfg.mamba, layers[li], xin)
            cache["ssm"][li] = hstate
            cache["conv"][li] = cstate.to(cfg.dtype)
            x = x + y
        if has_attn:
            x, (k, v) = _shared_attn(cfg, params["shared"], x, positions, sharder)
            cache["k"][app, :, :s] = k
            cache["v"][app, :, :s] = v
            app += 1
    h = L.rmsnorm(x, params["final_norm"])
    cache["length"].fill_(s)
    return h[:, -1:] @ params["embed"].T, cache


@torch.no_grad()
def decode_step(cfg, params, cache, tokens, sharder: Sharder = _id_sharder):
    """One token per sequence; the cache is updated in place (``sharder``
    is accepted and unused, as in the reference).
    tokens (B,) -> logits (B, V), cache."""
    lengths = cache["length"]
    x = L.embed(params["embed"], tokens)  # (B, d)
    layers = T._layers(params["mamba"], cfg.n_layers)
    app = 0
    for lo, n, has_attn in cfg.groups:
        for li in range(lo, lo + n):
            y, st = M2.decode_block(cfg.mamba, layers[li],
                                    {"ssm": cache["ssm"][li], "conv": cache["conv"][li]},
                                    L.rmsnorm(x, params["mamba_ln"][li]))
            x = x + y
            cache["ssm"][li] = st["ssm"]
            cache["conv"][li] = st["conv"].to(cache["conv"].dtype)
        if has_attn:
            x = _shared_attn_decode(cfg, params["shared"], x, cache, app, lengths)
            app += 1
    h = L.rmsnorm(x, params["final_norm"])
    cache["length"] = lengths + 1
    return h @ params["embed"].T, cache


def _shared_attn_decode(cfg, sp, x, cache, app: int, lengths):
    b = x.shape[0]
    h, kv, dh = cfg.n_heads, cfg.n_kv, cfg.dh
    xin = L.rmsnorm(x, sp["ln1"])[:, None]  # (B, 1, d)
    q = (xin @ sp["attn"]["wq"]).reshape(b, 1, h, dh)
    k = (xin @ sp["attn"]["wk"]).reshape(b, 1, kv, dh)
    v = (xin @ sp["attn"]["wv"]).reshape(b, 1, kv, dh)
    pos = lengths.long()[:, None]
    q = L.apply_rope(q, pos, cfg.rope_theta)
    k = L.apply_rope(k, pos, cfg.rope_theta)
    kc, vc = cache["k"][app], cache["v"][app]
    L.write_token(kc, pos[:, 0], k[:, 0])
    L.write_token(vc, pos[:, 0], v[:, 0])
    o = L.decode_attention_dense(q, kc, vc, lengths + 1)
    x = x + (o.reshape(b, 1, h * dh) @ sp["attn"]["wo"])[:, 0]
    return x + L.mlp_apply(sp["mlp"], L.rmsnorm(x, sp["ln2"]), cfg.act, cfg.gated)

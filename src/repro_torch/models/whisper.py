"""Whisper-style encoder-decoder (audio backbone; the conv front end is a stub).

Counterpart of ``repro.models.whisper``. As there, a batch carries
precomputed frame embeddings ``frames`` (B, S_frames, d_model) in place of
the conv1d + GELU downsampling front end. The encoder is a bidirectional
self-attention stack; the decoder is causal self-attention plus
cross-attention to the encoder memory, with learned positions and the
embedding tied as the logits head. Decode keeps a growing self-KV cache and
a static cross-KV cache. GELU is the tanh approximation, ``jax.nn.gelu``'s
default; layernorms have eps 1e-5 and a bias.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

import torch
from torch.utils.checkpoint import checkpoint

from ..device import DeviceLike, resolve_device
from . import layers as L
from . import transformer as T
from .transformer import Sharder, _id_sharder


@dataclass(frozen=True)
class WhisperConfig:
    name: str
    n_layers: int = 24  # per stack (24 enc + 24 dec)
    d_model: int = 1024
    n_heads: int = 16
    n_kv: int = 16
    d_ff: int = 4096
    vocab: int = 51865
    max_positions: int = 65536  # learned decoder positions
    act: str = "gelu"
    dtype: torch.dtype = torch.bfloat16
    remat: bool = True

    @property
    def dh(self) -> int:
        return self.d_model // self.n_heads

    @property
    def n_params(self) -> int:
        d, h, kv, dh, f = self.d_model, self.n_heads, self.n_kv, self.dh, self.d_ff
        attn = d * (h + 2 * kv) * dh + h * dh * d
        enc_layer = attn + 2 * d * f + 4 * d
        dec_layer = 2 * attn + 2 * d * f + 6 * d
        return (
            self.n_layers * (enc_layer + dec_layer)
            + self.vocab * d + self.max_positions * d + 4 * d
        )


# ---------------------------------------------------------------------------
# params
# ---------------------------------------------------------------------------


def init_params(cfg: WhisperConfig, generator: torch.Generator,
                device: DeviceLike = "cuda") -> Dict:
    """Random weights from ``generator`` (a CPU generator) on ``device``, in
    the reference's tree and its draw order (encoder, then decoder); the
    stacked per-layer matrices are drawn layer by layer by ``L.sliced_init``."""
    dev = resolve_device(device)
    nl, d, f, dt = cfg.n_layers, cfg.d_model, cfg.d_ff, cfg.dtype
    h, kv, dh = cfg.n_heads, cfg.n_kv, cfg.dh

    def stacked(a, b):
        return L.sliced_init(generator, (nl, a, b), 1, dt, dev)

    def attn():
        return {"wq": stacked(d, h * dh), "wk": stacked(d, kv * dh), "wv": stacked(d, kv * dh),
                "wo": stacked(h * dh, d)}

    def mlp():
        return {"wi": stacked(d, f), "wo": stacked(f, d)}

    def ln(shape=(nl, d)):
        return {"scale": torch.ones(shape, dtype=dt, device=dev),
                "bias": torch.zeros(shape, dtype=dt, device=dev)}

    encoder = {"ln1": ln(), "attn": attn(), "ln2": ln(), "mlp": mlp(), "ln_post": ln((d,))}
    embed = L.dense_init(generator, (cfg.vocab, d), in_axis=1, dtype=dt).to(dev)
    pos = (torch.randn((cfg.max_positions, d), generator=generator) * 0.01).to(dt).to(dev)
    decoder = {"embed": embed, "pos": pos, "ln1": ln(), "self_attn": attn(), "ln_x": ln(),
               "cross_attn": attn(), "ln2": ln(), "mlp": mlp(), "ln_post": ln((d,))}
    return {"encoder": encoder, "decoder": decoder}


params_from_jax_numpy = T.params_from_jax_numpy


# ---------------------------------------------------------------------------
# attention and MLP
# ---------------------------------------------------------------------------


def param_axes(cfg: WhisperConfig) -> Dict:
    ln = {"scale": ("layers", "embed"), "bias": ("layers", "embed")}
    ln1 = {"scale": ("embed",), "bias": ("embed",)}
    attn = {
        "wq": ("layers", "embed", "heads"),
        "wk": ("layers", "embed", "kv_heads"),
        "wv": ("layers", "embed", "kv_heads"),
        "wo": ("layers", "heads", "embed"),
    }
    mlp = {"wi": ("layers", "embed", "ffn"), "wo": ("layers", "ffn", "embed")}
    return {
        "encoder": {"ln1": ln, "attn": attn, "ln2": ln, "mlp": mlp, "ln_post": ln1},
        "decoder": {
            "embed": ("vocab", "embed"),
            "pos": ("position", "embed"),
            "ln1": ln, "self_attn": attn, "ln_x": ln, "cross_attn": attn,
            "ln2": ln, "mlp": mlp, "ln_post": ln1,
        },
    }


def _ln(p, x):
    return L.layernorm(x, p["scale"], p["bias"])


def _proj_qkv(cfg, p, xq, xkv):
    b, sq, _ = xq.shape
    skv = xkv.shape[1]
    h, kv, dh = cfg.n_heads, cfg.n_kv, cfg.dh
    q = L.split_heads(xq @ p["wq"], h, dh)
    k = L.split_heads(xkv @ p["wk"], kv, dh)
    v = L.split_heads(xkv @ p["wv"], kv, dh)
    return q, k, v


def _attn(cfg, p, xq, xkv, causal: bool):
    q, k, v = _proj_qkv(cfg, p, xq, xkv)
    o = L.flash_attention(q, k, v, causal=causal)
    b, s = o.shape[:2]
    return L.merge_heads(o) @ p["wo"], (k, v)


def _mlp(cfg, p, x):
    return L.ACTIVATIONS[cfg.act](x @ p["wi"]) @ p["wo"]


# ---------------------------------------------------------------------------
# encoder / decoder stacks
# ---------------------------------------------------------------------------


def _sinusoid(s: int, d: int, dtype, device):
    """Sinusoidal positions (s, d), computed in float32, then cast."""
    pos = torch.arange(s, device=device, dtype=torch.float32)[:, None]
    dim = torch.arange(d // 2, device=device, dtype=torch.float32)[None, :]
    ang = pos / torch.pow(10000.0, 2 * dim / d)  # a host scalar: no copy to the card
    return torch.cat([torch.sin(ang), torch.cos(ang)], -1).to(dtype)


def _enc_layer(cfg, lp, h, sharder: Sharder = _id_sharder):
    xin = _ln(lp["ln1"], h)
    a, _ = _attn(cfg, lp["attn"], xin, xin, causal=False)
    h = h + a
    return sharder(h + _mlp(cfg, lp["mlp"], _ln(lp["ln2"], h)), ("batch", "seq", "embed"))


def _dec_layer(cfg, lp, h, memory, sharder: Sharder = _id_sharder):
    xin = _ln(lp["ln1"], h)
    a, kv = _attn(cfg, lp["self_attn"], xin, xin, causal=True)
    h = h + a
    c, ckv = _attn(cfg, lp["cross_attn"], _ln(lp["ln_x"], h), memory, causal=False)
    h = h + c
    return sharder(h + _mlp(cfg, lp["mlp"], _ln(lp["ln2"], h)), ("batch", "seq", "embed")), kv, ckv


def _stack(p, keys, n):
    return T._layers({k: p[k] for k in keys}, n)


def encode(cfg: WhisperConfig, params, frames: torch.Tensor,
           sharder: Sharder = _id_sharder) -> torch.Tensor:
    """frames (B, S, d) (the conv front end's stub output) -> memory (B, S, d);
    each layer under ``torch.utils.checkpoint`` with ``cfg.remat`` and
    gradients on."""
    p = params["encoder"]
    x = frames.to(cfg.dtype) + _sinusoid(frames.shape[1], cfg.d_model, cfg.dtype, frames.device)
    remat = cfg.remat and torch.is_grad_enabled()
    for lp in _stack(p, ("ln1", "attn", "ln2", "mlp"), cfg.n_layers):
        x = checkpoint(_enc_layer, cfg, lp, x, sharder, use_reentrant=False) if remat else \
            _enc_layer(cfg, lp, x, sharder)
    return _ln(p["ln_post"], x)


def decode_train(cfg: WhisperConfig, params, tokens: torch.Tensor, memory: torch.Tensor,
                 sharder: Sharder = _id_sharder, collect_kv: bool = False):
    """Teacher-forced decoder over ``tokens`` (B, S) -> logits (B, S, V) and,
    with ``collect_kv``, ((k, v), (xk, xv)) stacked over layers to
    (L, B, S, KVH, Dh) and (L, B, S_frames, KVH, Dh)."""
    p = params["decoder"]
    s = tokens.shape[1]
    x = L.embed(p["embed"], tokens) + p["pos"][:s]
    remat = cfg.remat and torch.is_grad_enabled()
    kvs, ckvs = [], []
    for lp in _stack(p, ("ln1", "self_attn", "ln_x", "cross_attn", "ln2", "mlp"), cfg.n_layers):
        if remat:
            x, kv, ckv = checkpoint(_dec_layer, cfg, lp, x, memory, sharder,
                                    use_reentrant=False)
        else:
            x, kv, ckv = _dec_layer(cfg, lp, x, memory, sharder)
        if collect_kv:
            kvs.append(kv)
            ckvs.append(ckv)
    logits = _ln(p["ln_post"], x) @ p["embed"].T
    if not collect_kv:
        return logits, None

    def stacked(pairs):
        return torch.stack([a for a, _ in pairs]), torch.stack([b for _, b in pairs])

    return logits, (stacked(kvs), stacked(ckvs))


def loss_fn(cfg: WhisperConfig, params, batch, sharder: Sharder = _id_sharder) -> torch.Tensor:
    memory = encode(cfg, params, batch["frames"], sharder)
    logits, _ = decode_train(cfg, params, batch["tokens"][:, :-1], memory, sharder)
    return L.softmax_xent(logits, batch["tokens"][:, 1:], batch.get("loss_mask"))


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------


def cache_axes(cfg: WhisperConfig) -> Dict:
    return {
        "k": ("layers", "batch", "kv_seq", "kv_heads", None),
        "v": ("layers", "batch", "kv_seq", "kv_heads", None),
        "xk": ("layers", "batch", "enc_seq", "kv_heads", None),
        "xv": ("layers", "batch", "enc_seq", "kv_heads", None),
        "length": ("batch",),
    }


def init_cache(cfg: WhisperConfig, batch: int, max_len: int, enc_len: int,
               device: DeviceLike = "cuda") -> Dict:
    dev = resolve_device(device)
    nl, kv, dh = cfg.n_layers, cfg.n_kv, cfg.dh

    def zeros(s):
        return torch.zeros((nl, batch, s, kv, dh), dtype=cfg.dtype, device=dev)

    return {"k": zeros(max_len), "v": zeros(max_len), "xk": zeros(enc_len),
            "xv": zeros(enc_len), "length": torch.zeros((batch,), dtype=torch.int32, device=dev)}


@torch.no_grad()
def prefill(cfg, params, batch, cache, sharder: Sharder = _id_sharder):
    """Encode the frames and run the decoder prompt; fills the self-KV cache
    in place, sets the static cross-KV and returns the last position's
    logits (B, 1, V)."""
    memory = encode(cfg, params, batch["frames"], sharder)
    tokens = batch["tokens"]
    s = tokens.shape[1]
    logits, ((k, v), (xk, xv)) = decode_train(cfg, params, tokens, memory, sharder,
                                              collect_kv=True)
    cache["k"][:, :, :s] = k
    cache["v"][:, :, :s] = v
    cache["xk"], cache["xv"] = xk.to(cfg.dtype), xv.to(cfg.dtype)
    cache["length"].fill_(s)
    return logits[:, -1:], cache


@torch.no_grad()
def decode_step(cfg, params, cache, tokens, sharder: Sharder = _id_sharder):
    """One token per sequence; the self-KV cache is updated in place.
    tokens (B,) -> logits (B, V), cache."""
    p = params["decoder"]
    b = tokens.shape[0]
    lengths = cache["length"]
    pos = lengths.long()
    x = (p["embed"][tokens.long()] + p["pos"][pos])[:, None]  # (B, 1, d)
    h, dh = cfg.n_heads, cfg.dh
    enc_len = torch.full((b,), cache["xk"].shape[2], dtype=torch.int32, device=tokens.device)
    layers = _stack(p, ("ln1", "self_attn", "ln_x", "cross_attn", "ln2", "mlp"), cfg.n_layers)
    for i, lp in enumerate(layers):
        xin = _ln(lp["ln1"], x)
        q, k, v = _proj_qkv(cfg, lp["self_attn"], xin, xin)
        kc, vc = cache["k"][i], cache["v"][i]
        L.write_token(kc, pos, k[:, 0])
        L.write_token(vc, pos, v[:, 0])
        o = L.decode_attention_dense(q, kc, vc, lengths + 1)
        x = x + o.reshape(b, 1, h * dh) @ lp["self_attn"]["wo"]
        # cross-attention over the static encoder memory
        xq = (_ln(lp["ln_x"], x) @ lp["cross_attn"]["wq"]).reshape(b, 1, h, dh)
        xo = L.decode_attention_dense(xq, cache["xk"][i], cache["xv"][i], enc_len)
        x = x + xo.reshape(b, 1, h * dh) @ lp["cross_attn"]["wo"]
        x = x + _mlp(cfg, lp["mlp"], _ln(lp["ln2"], x))
    logits = _ln(p["ln_post"], x) @ p["embed"].T
    cache["length"] = lengths + 1
    return logits[:, 0], cache

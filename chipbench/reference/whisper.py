"""Plain float32 reference of the Whisper encoder-decoder, from frame
embeddings on (the convolutional front end is outside the model, as in
the program: a batch carries frame embeddings of width d).

Encoder: frames plus sinusoidal positions, then pre-norm blocks of
bidirectional self-attention and a GELU (tanh) MLP, and a final layernorm.
Decoder: token embedding plus learned positions, then pre-norm blocks of
causal self-attention, cross-attention to the encoder's output and the
MLP, a final layernorm and logits through the tied embedding. Layernorms
have eps 1e-5 and a bias; attention scales by 1/sqrt(head dim).

Departures from the published Whisper, kept because the benchmark holds
the program to its own configuration: no biases on the projections or the
MLP, and the sinusoid's frequencies are 10000^(-2i/d) for i < d/2 (sines,
then cosines), where the paper's code divides log(10000) by d/2 - 1.

Weights are the benchmark's tree, read by name (``encoder.*``,
``decoder.*``). Each clip runs alone, each layer recomputed in the
backward pass.
"""

from __future__ import annotations

from typing import Dict

import torch
from torch.utils.checkpoint import checkpoint

from .common import ACT, Precision, attention, cross_entropy, layernorm


def _ln(p, i, x):
    if i is None:
        return layernorm(x, p["scale"], p["bias"])
    return layernorm(x, p["scale"][i], p["bias"][i])


def sinusoid(s: int, d: int, device) -> torch.Tensor:
    pos = torch.arange(s, dtype=torch.float32, device=device)[:, None]
    dim = torch.arange(d // 2, dtype=torch.float32, device=device)[None, :]
    ang = pos / torch.pow(10000.0, 2 * dim / d)
    return torch.cat([torch.sin(ang), torch.cos(ang)], -1)


def _attn(cfg, prec, p, i, xq, xkv, causal):
    h = cfg["n_heads"]
    dh = cfg["d_model"] // h
    kvh = cfg["n_kv"]
    q = prec.mm(xq, p["wq"][i]).view(xq.shape[0], h, dh)
    k = prec.mm(xkv, p["wk"][i]).view(xkv.shape[0], kvh, dh)
    v = prec.mm(xkv, p["wv"][i]).view(xkv.shape[0], kvh, dh)
    return prec.mm(attention(prec, q, k, v, causal=causal), p["wo"][i])


def _mlp(cfg, prec, p, i, x):
    return prec.mm(ACT[cfg["act"]](prec.mm(x, p["wi"][i])), p["wo"][i])


def _enc_layer(cfg, prec, p, i, x):
    xin = _ln(p["ln1"], i, x)
    x = x + _attn(cfg, prec, p["attn"], i, xin, xin, causal=False)
    return x + _mlp(cfg, prec, p["mlp"], i, _ln(p["ln2"], i, x))


def _dec_layer(cfg, prec, p, i, x, memory):
    xin = _ln(p["ln1"], i, x)
    x = x + _attn(cfg, prec, p["self_attn"], i, xin, xin, causal=True)
    x = x + _attn(cfg, prec, p["cross_attn"], i, _ln(p["ln_x"], i, x), memory, causal=False)
    return x + _mlp(cfg, prec, p["mlp"], i, _ln(p["ln2"], i, x))


def encode(cfg, params, frames, prec: Precision, remat: bool = False):
    """frames (S, d) -> memory (S, d)."""
    p = params["encoder"]
    x = frames.float() + sinusoid(frames.shape[0], cfg["d_model"], frames.device)
    for i in range(cfg["n_layers"]):
        x = (checkpoint(_enc_layer, cfg, prec, p, i, x, use_reentrant=False) if remat
             else _enc_layer(cfg, prec, p, i, x))
    return _ln(p["ln_post"], None, x)


def decode(cfg, params, tokens, memory, prec: Precision, remat: bool = False):
    """Teacher-forced decoder over tokens (T,) -> logits (T, V)."""
    p = params["decoder"]
    x = p["embed"][tokens.long()] + p["pos"][: tokens.shape[0]]
    for i in range(cfg["n_layers"]):
        x = (checkpoint(_dec_layer, cfg, prec, p, i, x, memory, use_reentrant=False) if remat
             else _dec_layer(cfg, prec, p, i, x, memory))
    return prec.mm(_ln(p["ln_post"], None, x), p["embed"].T)


def loss_rows(cfg, batch: Dict) -> int:
    return batch["tokens"].shape[0]


def loss_of_row(cfg, params, batch: Dict, r: int, prec: Precision) -> torch.Tensor:
    """Mean next-token cross-entropy of clip ``r``: the decoder reads
    tokens[:-1] and predicts tokens[1:]."""
    tokens = batch["tokens"][r]
    memory = encode(cfg, params, batch["frames"][r], prec, remat=True)
    return cross_entropy(decode(cfg, params, tokens[:-1], memory, prec, remat=True), tokens[1:])

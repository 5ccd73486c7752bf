"""Plain float32 reference of the dense decoder-only LM (StarCoder2's block).

Pre-norm blocks: x + attn(norm1(x)), then x + mlp(norm2(x)); grouped-query
causal attention with rotary embeddings (rotate-half pairing, base
``rope_theta``) and softmax scale 1/sqrt(head dim); a GELU (tanh) MLP, or a
gated one when ``gated``; a final norm and logits through the tied
embedding. Layernorm has eps 1e-5 and a bias, RMSNorm eps 1e-6.

Departures from the published StarCoder2, kept because the benchmark holds
the program to its own configuration: no biases on the projections, and
the embedding is tied to the head.

Weights are the benchmark's tree, read by name: ``embed`` (V, d),
``layers.{ln1,ln2}.{scale,bias}`` (L, d), ``layers.attn.{wq,wk,wv,wo}`` and
``layers.mlp.{wi,wo[,wg]}`` stacked over layers, ``final_norm``. Each
sequence runs alone, layer by layer, each layer recomputed in the backward
pass, so the full width fits one card at 4096 positions.
"""

from __future__ import annotations

from typing import Dict

import torch
from torch.utils.checkpoint import checkpoint

from .common import ACT, Precision, attention, cross_entropy, layernorm, rmsnorm, rope


def _norm(cfg, p, x):
    if cfg["norm"] == "layernorm":
        return layernorm(x, p["scale"], p["bias"])
    return rmsnorm(x, p["scale"])


def _layer(cfg, prec: Precision, lp, i: int, x):
    h, kv = cfg["n_heads"], cfg["n_kv"]
    dh = cfg.get("head_dim") or cfg["d_model"] // h
    s = x.shape[0]
    a = lp["attn"]
    xin = _norm(cfg, {k: v[i] for k, v in lp["ln1"].items()}, x)
    q = rope(prec.mm(xin, a["wq"][i]).view(s, h, dh), cfg["rope_theta"])
    k = rope(prec.mm(xin, a["wk"][i]).view(s, kv, dh), cfg["rope_theta"])
    v = prec.mm(xin, a["wv"][i]).view(s, kv, dh)
    x = x + prec.mm(attention(prec, q, k, v, causal=True), a["wo"][i])
    m = lp["mlp"]
    xin = _norm(cfg, {k: v[i] for k, v in lp["ln2"].items()}, x)
    act = ACT[cfg["act"]]
    if cfg["gated"]:
        hid = act(prec.mm(xin, m["wg"][i])) * prec.mm(xin, m["wi"][i])
    else:
        hid = act(prec.mm(xin, m["wi"][i]))
    return x + prec.mm(hid, m["wo"][i])


def hidden(cfg, params, tokens, prec: Precision, remat: bool = False):
    """Final-normed hidden states (S, d) of one sequence ``tokens`` (S,)."""
    x = params["embed"][tokens.long()]
    for i in range(cfg["n_layers"]):
        if remat:
            x = checkpoint(_layer, cfg, prec, params["layers"], i, x, use_reentrant=False)
        else:
            x = _layer(cfg, prec, params["layers"], i, x)
    return _norm(cfg, params["final_norm"], x)


def head(cfg, params, h, prec: Precision):
    w = params["embed"].T if cfg.get("tie_embeddings", True) else params["lm_head"]
    return prec.mm(h, w)


@torch.no_grad()
def logits(cfg, params, tokens, prec: Precision) -> torch.Tensor:
    """Logits (S, V) at every position of one sequence."""
    return head(cfg, params, hidden(cfg, params, tokens, prec), prec)


def row_loss(cfg, params, tokens, prec: Precision) -> torch.Tensor:
    """Mean next-token cross-entropy of one sequence (S,), over S - 1
    predictions, with layers recomputed in the backward pass."""
    h = hidden(cfg, params, tokens, prec, remat=True)
    return cross_entropy(head(cfg, params, h[:-1], prec), tokens[1:])


def loss_rows(cfg, batch: Dict) -> int:
    return batch["tokens"].shape[0]


def loss_of_row(cfg, params, batch: Dict, r: int, prec: Precision) -> torch.Tensor:
    return row_loss(cfg, params, batch["tokens"][r], prec)

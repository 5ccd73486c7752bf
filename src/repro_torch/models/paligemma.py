"""PaliGemma-style VLM: gemma backbone + image-patch prefix (SigLIP stub).

Counterpart of ``repro.models.paligemma``. The modality frontend is a
stub, as in the reference: a batch carries precomputed patch embeddings
``patch_embeds`` (B, n_patches, d_model). The text backbone is the dense
transformer, gemma-flavoured (rmsnorm, gated gelu, embedding scaling, MQA
kv=1), run as a prefix-LM: bidirectional attention over the patch prefix,
causal over the text.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from . import layers as L
from . import transformer as T
from .transformer import Sharder, _id_sharder


@dataclass(frozen=True)
class PaliGemmaConfig(T.TransformerConfig):
    n_patches: int = 256


def make_config(name: str, **kw) -> PaliGemmaConfig:
    defaults = dict(
        norm="rmsnorm", act="gelu", gated=True, tie_embeddings=True,
        embed_scale=True, prefix_lm=True,
    )
    defaults.update(kw)
    return PaliGemmaConfig(name=name, **defaults)


init_params = T.init_params
param_axes = T.param_axes
init_cache = T.init_cache
cache_axes = T.cache_axes


def _embed_multimodal(cfg, params, batch) -> torch.Tensor:
    """concat(patch prefix, text embeddings) -> (B, P + S_text, d)."""
    patches = batch["patch_embeds"].to(cfg.dtype)  # (B, P, d)
    text = T.embed_tokens(cfg, params, batch["tokens"])  # (B, S_text, d)
    return torch.cat([patches, text], dim=1)


def loss_fn(cfg: PaliGemmaConfig, params, batch, sharder: Sharder = _id_sharder) -> torch.Tensor:
    """Next-token loss on the text suffix only: positions p .. s-2 predict
    tokens[1:] (tokens[0] is given)."""
    x = _embed_multimodal(cfg, params, batch)
    b, s, _ = x.shape
    p = batch["patch_embeds"].shape[1]
    x = sharder(x, ("batch", None, "embed"))
    h, _ = T.forward(cfg, params, x, T._positions(b, s, x.device), prefix_len=p,
                     sharder=sharder)
    logits = T.logits_from_hidden(cfg, params, h[:, p:-1])
    return L.softmax_xent(logits, batch["tokens"][:, 1:], batch.get("loss_mask"))


@torch.no_grad()
def prefill(cfg, params, batch, cache, sharder: Sharder = _id_sharder):
    """Multimodal prompt (patch_embeds + tokens) -> last logits, cache."""
    x = _embed_multimodal(cfg, params, batch)
    b, s, _ = x.shape
    p = batch["patch_embeds"].shape[1]
    h, kvs = T.forward(cfg, params, x, T._positions(b, s, x.device), prefix_len=p,
                       sharder=sharder, collect_kv=True)
    return T.logits_from_hidden(cfg, params, h[:, -1:]), T.fill_cache(cache, kvs, s)


decode_step = T.decode_step  # past the prefix, decode is plain causal

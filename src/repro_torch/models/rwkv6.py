"""RWKV6 "Finch": a linear-attention RNN with data-dependent per-channel decay.

Counterpart of ``repro.models.rwkv6``. Each layer is a time-mix (the WKV6
recurrence) and a channel-mix (token-shift MLP). The WKV6 state is
S (H, Dk, Dv); per step

    S_t = Diag(w_t) S_{t-1} + k_t v_t^T          (w_t in (0,1), data-dependent)
    y_t = r_t · (S_{t-1} + Diag(u) k_t v_t^T)

Training and prefill use the chunked parallel form (cumulative log-decay
within a chunk, the state carried across chunks in a Python loop where the
reference scans); decode is the O(1) recurrence. Every exp() argument of
the chunked form is a difference of a cumsum of log w <= 0, bounded by
``chunk * DECAY_EXP_CAP`` where it is negated, so it stays finite in float32.

The family is attention-free, so the stitched KV cache does not apply; its
recurrent state can live in an offload arena (``core/offload.py``). The
decay parameters ``w0`` and ``u`` and the ``wkv`` state stay float32 in a
bf16 model.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..device import DeviceLike, resolve_device
from ..parallel.sharding import run_local
from . import layers as L
from . import transformer as T
from .transformer import Sharder, _id_sharder


@dataclass(frozen=True)
class RWKV6Config:
    name: str
    n_layers: int = 32
    d_model: int = 4096
    d_ff: int = 14336
    vocab: int = 65536
    head_size: int = 64
    decay_lora: int = 64
    #: the WKV6 chunk: the factored within-chunk form carries exp(-cumsum(log
    #: w)), whose exponent is bounded by chunk * e^DECAY_EXP_CAP = 16 * 5 = 80
    #: < 88 (float32 overflow), so 16 is the largest safe chunk
    chunk: int = 16
    dtype: torch.dtype = torch.bfloat16
    remat: bool = True

    @property
    def n_heads(self) -> int:
        return self.d_model // self.head_size

    @property
    def n_params(self) -> int:
        d, f = self.d_model, self.d_ff
        tm = 4 * d * d + 2 * d * self.decay_lora + 6 * d + self.n_heads * self.head_size
        cm = 2 * d * f + d * d + 2 * d
        per_layer = tm + cm + 4 * d
        return self.n_layers * per_layer + 2 * self.vocab * d + 2 * d


# ---------------------------------------------------------------------------
# params
# ---------------------------------------------------------------------------


def init_params(cfg: RWKV6Config, generator: torch.Generator,
                device: DeviceLike = "cuda") -> Dict:
    """Random weights from ``generator`` (a CPU generator) on ``device``, in
    the reference's tree and its draw order. The stacked per-layer matrices
    (up to 32 x 4096 x 14336 at full width) are drawn layer by layer by
    ``L.sliced_init``, straight into their tensors on ``device``."""
    dev = resolve_device(device)
    d, f, r, nl, dt = cfg.d_model, cfg.d_ff, cfg.decay_lora, cfg.n_layers, cfg.dtype

    def stacked(a, b):
        return L.sliced_init(generator, (nl, a, b), 1, dt, dev)

    def full(value, dtype=dt):
        return torch.full((nl, d), value, dtype=dtype, device=dev)

    tm = {
        # token-shift mixing coefficients per projection
        "mu_r": full(0.5), "mu_k": full(0.5), "mu_v": full(0.5), "mu_w": full(0.5),
        "mu_g": full(0.5),
        "wr": stacked(d, d), "wk": stacked(d, d), "wv": stacked(d, d), "wg": stacked(d, d),
        "wo": stacked(d, d),
        # data-dependent decay: w = exp(-exp(w0 + tanh(x A) B))
        "w0": full(-1.0, torch.float32),
        "wA": stacked(d, r),
        "wB": (torch.randn((nl, r, d), generator=generator) * 0.01).to(dt).to(dev),
        "u": (torch.randn((nl, d), generator=generator) * 0.1).to(dev),  # bonus
        "ln_x": full(1.0),  # per-head norm scale
    }
    cm = {"mu_k": full(0.5), "mu_r": full(0.5), "wk": stacked(d, f), "wv": stacked(f, d),
          "wr": stacked(d, d)}
    ones = torch.ones((d,), dtype=dt, device=dev)
    return {
        "embed": L.dense_init(generator, (cfg.vocab, d), in_axis=1, dtype=dt).to(dev),
        "ln_in": ones,  # rwkv has an input norm
        "layers": {"ln1": full(1.0), "tm": tm, "ln2": full(1.0), "cm": cm},
        "final_norm": ones.clone(),
        "lm_head": L.dense_init(generator, (d, cfg.vocab), dtype=dt).to(dev),
    }


params_from_jax_numpy = T.params_from_jax_numpy  # keeps ``w0`` and ``u`` float32


# ---------------------------------------------------------------------------
# time-mix (WKV6)
# ---------------------------------------------------------------------------

#: cap on exp(w0 + lora): the per-step decay w >= exp(-e^1.609) = exp(-5);
#: stronger decays are < 6.7e-3 a step (influence < e^-80 over one 16-chunk)
#: and indistinguishable from zero, and the cap keeps exp(-cum) finite
DECAY_EXP_CAP = 1.609  # ln(5)


def _shift(x):
    """Token shift: x_{t-1}, zeros at t = 0. x (B, S, d)."""
    return F.pad(x, (0, 0, 1, 0))[:, :-1]


def _mix(x, x_prev, mu):
    return x + (x_prev - x) * mu


def _log_decay(p, xw):
    """log w = -exp(min(w0 + tanh(xw A) B, cap)), float32."""
    lora = torch.tanh(xw @ p["wA"]) @ p["wB"]
    return -torch.exp(torch.clamp(p["w0"] + lora.float(), max=DECAY_EXP_CAP))


def _wkv6_chunked(cfg: RWKV6Config, r, k, v, logw, u):
    """Chunked WKV6.

    r, k, v (B,S,H,D), logw (B,S,H,D) (log decay, <= 0), u (H,D).
    Returns y (B,S,H,D) and the final state (B,H,D,D), float32. The chunk
    halves until it divides S, as the reference's does.
    """
    b, s, h, dd = r.shape
    q = cfg.chunk
    while s % q:
        q //= 2
    c = s // q
    rc, kc, vc, wc = (t.reshape(b, c, q, h, dd) for t in (r, k, v, logw))
    tri = torch.tril(torch.ones((q, q), dtype=torch.bool, device=r.device), diagonal=-1)
    state = torch.zeros((b, h, dd, dd), device=r.device)
    ys = []
    for i in range(c):
        rq, kq, vq, wq = (t[:, i].float() for t in (rc, kc, vc, wc))  # (B,Q,H,D)
        cum = torch.cumsum(wq, dim=1)  # inclusive cumsum of log w
        # intra: A[t,s] = sum_d r_t exp(cum_{t-1} - cum_s) k_s (s < t),
        #        A[t,t] = sum_d r_t u k_t
        rt = rq * torch.exp(cum - wq)  # decay-weighted queries (cum up to t-1)
        ks_ = kq * torch.exp(-cum)  # decay-unweighted keys
        a = torch.einsum("bthd,bshd->bhts", rt, ks_)
        a = torch.where(tri[None, None], a, 0.0)
        diag = (rq * u * kq).sum(-1)  # (B,Q,H)
        y = torch.einsum("bhts,bshd->bthd", a, vq)
        y = y + diag[..., None] * vq  # bonus u: the current token's own kv
        # inter: y += (r_t * exp(cum_{t-1})) . S
        y = y + torch.einsum("bthd,bhde->bthe", rt, state)
        # S' = Diag(exp(cum_Q)) S + sum_s exp(cum_Q - cum_s) k_s v_s^T
        total = cum[:, -1]  # (B,H,D)
        state = torch.exp(total)[..., None] * state + torch.einsum(
            "bshd,bshe->bhde", kq * torch.exp(total[:, None] - cum), vq)
        ys.append(y)
    return torch.stack(ys, 1).reshape(b, s, h, dd), state


def _head_norm(cfg, y, scale):
    """Per-head rmsnorm over the head dim (the reference's stand-in for
    GroupNorm); cast to the scale's dtype before scaling."""
    b, s, h, dd = y.shape
    var = y.square().mean(dim=-1, keepdim=True)
    y = (y * torch.rsqrt(var + 1e-6)).reshape(b, s, h * dd)
    return y.to(scale.dtype) * scale


def param_axes(cfg: RWKV6Config) -> Dict:
    vec = ("layers", "embed")
    mat = ("layers", "embed", "embed_out")
    tm = {
        "mu_r": vec, "mu_k": vec, "mu_v": vec, "mu_w": vec, "mu_g": vec,
        "wr": mat, "wk": mat, "wv": mat, "wg": mat, "wo": mat,
        "w0": vec, "wA": ("layers", "embed", None), "wB": ("layers", None, "embed"),
        "u": vec, "ln_x": vec,
    }
    cm = {
        "mu_k": vec, "mu_r": vec,
        "wk": ("layers", "embed", "ffn"), "wv": ("layers", "ffn", "embed"),
        "wr": mat,
    }
    return {
        "embed": ("vocab", "embed"),
        "ln_in": ("embed",),
        "layers": {"ln1": vec, "tm": tm, "ln2": vec, "cm": cm},
        "final_norm": ("embed",),
        "lm_head": ("embed", "vocab"),
    }


def time_mix_with_state(cfg: RWKV6Config, p: Dict, x: torch.Tensor,
                        sharder: Sharder = _id_sharder):
    """Time-mix over a sequence x (B, S, d) -> (out (B, S, d), final WKV
    state (B, H, D, D) float32)."""
    b, s, _ = x.shape
    h, dd = cfg.n_heads, cfg.head_size
    xp = _shift(x)
    r = _mix(x, xp, p["mu_r"]) @ p["wr"]
    k = _mix(x, xp, p["mu_k"]) @ p["wk"]
    v = _mix(x, xp, p["mu_v"]) @ p["wv"]
    g = _mix(x, xp, p["mu_g"]) @ p["wg"]
    logw = _log_decay(p, _mix(x, xp, p["mu_w"]))
    rs = sharder(r.reshape(b, s, h, dd), ("batch", None, "heads", None))
    y, state = _wkv6_chunked(cfg, rs, k.reshape(b, s, h, dd),
                             v.reshape(b, s, h, dd), logw.reshape(b, s, h, dd),
                             p["u"].reshape(h, dd))
    y = _head_norm(cfg, y, p["ln_x"]) * F.silu(g)
    return y.to(x.dtype) @ p["wo"], state


def time_mix(cfg: RWKV6Config, p: Dict, x: torch.Tensor,
             sharder: Sharder = _id_sharder) -> torch.Tensor:
    return time_mix_with_state(cfg, p, x, sharder)[0]


def channel_mix(cfg: RWKV6Config, p: Dict, x: torch.Tensor) -> torch.Tensor:
    xp = _shift(x)
    kv = F.relu(_mix(x, xp, p["mu_k"]) @ p["wk"]).square() @ p["wv"]
    return torch.sigmoid(_mix(x, xp, p["mu_r"]) @ p["wr"]) * kv


# ---------------------------------------------------------------------------
# model
# ---------------------------------------------------------------------------


def _layer(cfg, lp, h, sharder: Sharder = _id_sharder):
    """One layer. On DTensors each mix runs on each rank's batch rows with
    its weights gathered: the token shift, the WKV6 scan and the head norm
    have no DTensor rule (sites "rwkv6 time-mix", "rwkv6 channel-mix")."""
    h = h + run_local("rwkv6 time-mix", lambda x, p: time_mix(cfg, p, x, sharder),
                      (L.rmsnorm(h, lp["ln1"]),), keep=(0,), params=lp["tm"])
    h = h + run_local("rwkv6 channel-mix", lambda x, p: channel_mix(cfg, p, x),
                      (L.rmsnorm(h, lp["ln2"]),), keep=(0,), params=lp["cm"])
    return sharder(h, ("batch", "seq", "embed"))


def forward(cfg: RWKV6Config, params: Dict, x: torch.Tensor,
            sharder: Sharder = _id_sharder) -> torch.Tensor:
    """x (B, S, d) input-normed embeddings -> final-normed hidden; each layer
    under ``torch.utils.checkpoint`` with ``cfg.remat`` and gradients on."""
    remat = cfg.remat and torch.is_grad_enabled()
    for lp in T._layers(params["layers"], cfg.n_layers):
        x = (checkpoint(_layer, cfg, lp, x, sharder, use_reentrant=False) if remat
             else _layer(cfg, lp, x, sharder))
    return L.rmsnorm(x, params["final_norm"])


def _embed(params, tokens):
    return L.rmsnorm(L.embed(params["embed"], tokens), params["ln_in"])


def loss_fn(cfg: RWKV6Config, params, batch, sharder: Sharder = _id_sharder) -> torch.Tensor:
    tokens = batch["tokens"]
    x = sharder(_embed(params, tokens), ("batch", "seq", "embed"))
    h = forward(cfg, params, x, sharder)
    logits = h[:, :-1] @ params["lm_head"]
    return L.softmax_xent(logits, tokens[:, 1:], batch.get("loss_mask"))


# ---------------------------------------------------------------------------
# serving: recurrent state only, no KV cache
# ---------------------------------------------------------------------------


def cache_axes(cfg: RWKV6Config) -> Dict:
    return {
        "wkv": ("layers", "batch", "heads", None, None),
        "x_tm": ("layers", "batch", "embed"),
        "x_cm": ("layers", "batch", "embed"),
        "length": ("batch",),
    }


def init_cache(cfg: RWKV6Config, batch: int, max_len: int = 0,
               device: DeviceLike = "cuda") -> Dict:
    """The recurrent state: O(1) in the sequence length (``max_len`` is
    ignored, as in the reference)."""
    dev = resolve_device(device)
    h, dd, nl = cfg.n_heads, cfg.head_size, cfg.n_layers
    return {
        "wkv": torch.zeros((nl, batch, h, dd, dd), device=dev),
        "x_tm": torch.zeros((nl, batch, cfg.d_model), dtype=cfg.dtype, device=dev),
        "x_cm": torch.zeros((nl, batch, cfg.d_model), dtype=cfg.dtype, device=dev),
        "length": torch.zeros((batch,), dtype=torch.int32, device=dev),
    }


def _tm_step(cfg, p, x, x_prev, S):
    """Single-token time-mix. x (B, d), S (B, H, D, D) -> (out, new S)."""
    b = x.shape[0]
    h, dd = cfg.n_heads, cfg.head_size
    r = (_mix(x, x_prev, p["mu_r"]) @ p["wr"]).reshape(b, h, dd)
    k = (_mix(x, x_prev, p["mu_k"]) @ p["wk"]).reshape(b, h, dd)
    v = (_mix(x, x_prev, p["mu_v"]) @ p["wv"]).reshape(b, h, dd)
    g = _mix(x, x_prev, p["mu_g"]) @ p["wg"]
    w = torch.exp(_log_decay(p, _mix(x, x_prev, p["mu_w"]))).reshape(b, h, dd)
    u = p["u"].reshape(h, dd)
    rf, kf, vf = r.float(), k.float(), v.float()
    kv = torch.einsum("bhd,bhe->bhde", kf, vf)
    y = torch.einsum("bhd,bhde->bhe", rf, S + u[None, :, :, None] * kv)
    S = w[..., None] * S + kv
    var = y.square().mean(dim=-1, keepdim=True)
    y = (y * torch.rsqrt(var + 1e-6)).reshape(b, h * dd).to(x.dtype)
    y = y * p["ln_x"] * F.silu(g)
    return y @ p["wo"], S


def _cm_step(cfg, p, x, x_prev):
    kv = F.relu(_mix(x, x_prev, p["mu_k"]) @ p["wk"]).square() @ p["wv"]
    return torch.sigmoid(_mix(x, x_prev, p["mu_r"]) @ p["wr"]) * kv


@torch.no_grad()
def decode_step(cfg, params, cache, tokens, sharder: Sharder = _id_sharder):
    """One token per sequence; the state is updated in place.
    tokens (B,) -> logits (B, V), cache."""
    h = _embed(params, tokens)  # (B, d)
    for i, lp in enumerate(T._layers(params["layers"], cfg.n_layers)):
        xin = L.rmsnorm(h, lp["ln1"])
        y, S = _tm_step(cfg, lp["tm"], xin, cache["x_tm"][i], cache["wkv"][i])
        h = h + y
        xin2 = L.rmsnorm(h, lp["ln2"])
        h = h + _cm_step(cfg, lp["cm"], xin2, cache["x_cm"][i])
        cache["wkv"][i], cache["x_tm"][i], cache["x_cm"][i] = S, xin, xin2
    h = L.rmsnorm(h, params["final_norm"])
    cache["length"] = cache["length"] + 1
    return h @ params["lm_head"], cache


@torch.no_grad()
def prefill(cfg, params, batch, cache, sharder: Sharder = _id_sharder):
    """The prompt through the chunked form; the final recurrent states go
    into the cache in place. Returns the last position's logits (B, 1, V)."""
    tokens = batch["tokens"]
    s = tokens.shape[1]
    h = _embed(params, tokens)
    for i, lp in enumerate(T._layers(params["layers"], cfg.n_layers)):
        xin = L.rmsnorm(h, lp["ln1"])
        y, S = time_mix_with_state(cfg, lp["tm"], xin)
        h = h + y
        xin2 = L.rmsnorm(h, lp["ln2"])
        h = h + channel_mix(cfg, lp["cm"], xin2)
        cache["wkv"][i], cache["x_tm"][i], cache["x_cm"][i] = S, xin[:, -1], xin2[:, -1]
    h = L.rmsnorm(h, params["final_norm"])
    cache["length"].fill_(s)
    return h[:, -1:] @ params["lm_head"], cache

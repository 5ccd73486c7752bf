"""Mamba2 mixer (SSD, state-space duality, in its chunked parallel form).

Counterpart of ``repro.models.mamba2``. The sequence is processed in
chunks: within a chunk the quadratic "attention-like" dual form, across
chunks a carried state, in a Python loop where the reference scans. A
single-token recurrence serves decode. Used inside zamba2.

Shapes: B batch, S seq, H heads, P head dim, N state dim, Q chunk length.
The scan runs in float32 whatever the model's dtype; ``A_log``, ``D`` and
``dt_bias`` stay float32 in a bf16 model, as in the reference.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

import torch
import torch.nn.functional as F

from . import layers as L


@dataclass(frozen=True)
class Mamba2Config:
    d_model: int
    d_state: int = 64
    head_p: int = 64
    expand: int = 2
    d_conv: int = 4
    chunk: int = 64

    @property
    def d_inner(self) -> int:
        return self.expand * self.d_model

    @property
    def n_heads(self) -> int:
        return self.d_inner // self.head_p

    @property
    def conv_channels(self) -> int:
        return self.d_inner + 2 * self.d_state


def block_init(cfg: Mamba2Config, generator: torch.Generator, n_layers: int, dtype,
               device) -> Dict:
    """Stacked ``(n_layers, ...)`` params of one mamba2 mixer on ``device``,
    each projection's layers drawn by ``L.sliced_init``."""
    d, di, n, h = cfg.d_model, cfg.d_inner, cfg.d_state, cfg.n_heads
    proj_out = 2 * di + 2 * n + h  # z, x, B, C, dt
    conv_w = torch.randn((n_layers, cfg.d_conv, cfg.conv_channels), generator=generator) * 0.1
    return {
        "in_proj": L.sliced_init(generator, (n_layers, d, proj_out), 1, dtype, device),
        "conv_w": conv_w.to(dtype).to(device),
        "conv_b": torch.zeros((n_layers, cfg.conv_channels), dtype=dtype, device=device),
        "A_log": torch.zeros((n_layers, h), device=device),  # A = -exp(A_log) = -1
        "D": torch.ones((n_layers, h), device=device),
        "dt_bias": torch.full((n_layers, h), -1.0, device=device),
        "norm": torch.ones((n_layers, di), dtype=dtype, device=device),
        "out_proj": L.sliced_init(generator, (n_layers, di, d), 1, dtype, device),
    }


def _split_proj(cfg: Mamba2Config, zxbcdt):
    di, n = cfg.d_inner, cfg.d_state
    return zxbcdt[..., :di], zxbcdt[..., di:2 * di + 2 * n], zxbcdt[..., 2 * di + 2 * n:]


def _causal_conv(cfg: Mamba2Config, w, b, xbc):
    """Depthwise causal conv by explicit shifts (kernel <= 4), then silu."""
    s = xbc.shape[1]
    out = torch.zeros_like(xbc)
    for i in range(cfg.d_conv):
        shift = cfg.d_conv - 1 - i
        out = out + F.pad(xbc, (0, 0, shift, 0))[:, :s] * w[i]
    return F.silu(out + b)


def _ssd_chunked(cfg: Mamba2Config, x, dt, A, Bm, Cm):
    """Chunked SSD scan.

    x (B,S,H,P), dt (B,S,H), A (H,) negative, Bm/Cm (B,S,N), all float32.
    Returns y (B,S,H,P) and the final state (B,H,P,N). The chunk halves
    until it divides S, as the reference's does (an odd S runs chunks of 1).
    """
    b, s, h, p = x.shape
    n = Bm.shape[-1]
    q = cfg.chunk
    while s % q:
        q //= 2
    c = s // q
    xc, dtc = x.reshape(b, c, q, h, p), dt.reshape(b, c, q, h)
    bc, cc = Bm.reshape(b, c, q, n), Cm.reshape(b, c, q, n)
    tri = torch.tril(torch.ones((q, q), dtype=torch.bool, device=x.device))
    hstate = torch.zeros((b, h, p, n), device=x.device)
    ys = []
    for i in range(c):
        xq, dtq, bq, cq = xc[:, i], dtc[:, i], bc[:, i], cc[:, i]
        cum = torch.cumsum(dtq * A, dim=1)  # (B,Q,H) inclusive log decay, <= 0
        # intra-chunk: lmat[t, s] = exp(cum_t - cum_s) for s <= t
        diff = cum[:, :, None, :] - cum[:, None, :, :]  # (B,Q,Q,H)
        lmat = torch.where(tri[None, :, :, None], torch.exp(diff), 0.0)
        g = torch.einsum("btn,bsn->bts", cq, bq)
        xdt = xq * dtq[..., None]
        # two-operand contractions only: without opt_einsum, torch contracts
        # a three-operand einsum left to right and would build (B,Q,H,P,N)
        y_intra = torch.einsum("btsh,bshp->bthp", g[..., None] * lmat, xdt)
        # inter-chunk: the carried state's contribution
        y_inter = torch.exp(cum)[..., None] * torch.einsum("btn,bhpn->bthp", cq, hstate)
        total = cum[:, -1]  # (B,H)
        suffix = torch.exp(total[:, None] - cum)  # (B,Q,H)
        hstate = torch.exp(total)[..., None, None] * hstate + torch.einsum(
            "bshp,bsn->bhpn", xdt * suffix[..., None], bq)
        ys.append(y_intra + y_inter)
    return torch.stack(ys, 1).reshape(b, s, h, p), hstate


def apply_block_with_state(cfg: Mamba2Config, p: Dict, x: torch.Tensor):
    """The mixer over a sequence x (B, S, d_model) -> (out (B, S, d_model),
    final SSM state (B, H, P, N) float32, conv state: the last ``d_conv - 1``
    raw conv inputs (B, d_conv - 1, conv_channels))."""
    b, s, _ = x.shape
    h, pp, n, di = cfg.n_heads, cfg.head_p, cfg.d_state, cfg.d_inner
    z, xbc_raw, dt = _split_proj(cfg, x @ p["in_proj"])
    xbc = _causal_conv(cfg, p["conv_w"], p["conv_b"], xbc_raw)
    xi = xbc[..., :di].reshape(b, s, h, pp)
    bm, cm = xbc[..., di:di + n], xbc[..., di + n:]
    dt = F.softplus(dt.float() + p["dt_bias"])  # (B,S,H)
    a = -torch.exp(p["A_log"])  # (H,)
    y, hstate = _ssd_chunked(cfg, xi.float(), dt, a, bm.float(), cm.float())
    y = y + p["D"][None, None, :, None] * xi.float()
    y = y.reshape(b, s, di).to(x.dtype)
    y = L.rmsnorm(y * F.silu(z), p["norm"])
    return y @ p["out_proj"], hstate, xbc_raw[:, -(cfg.d_conv - 1):]


def block_axes(cfg: Mamba2Config) -> Dict:
    return {
        "in_proj": ("layers", "embed", "inner_proj"),
        "conv_w": ("layers", None, "inner_conv"),
        "conv_b": ("layers", "inner_conv"),
        "A_log": ("layers", "ssm_heads"),
        "D": ("layers", "ssm_heads"),
        "dt_bias": ("layers", "ssm_heads"),
        "norm": ("layers", "inner"),
        "out_proj": ("layers", "inner", "embed"),
    }


def apply_block(cfg: Mamba2Config, p: Dict, x: torch.Tensor) -> torch.Tensor:
    """The mixer over a sequence. x (B, S, d_model)."""
    return apply_block_with_state(cfg, p, x)[0]


# ---------------------------------------------------------------------------
# decode (single-token recurrence)
# ---------------------------------------------------------------------------


def init_state(cfg: Mamba2Config, batch: int, dtype, device) -> Dict:
    return {
        "ssm": torch.zeros((batch, cfg.n_heads, cfg.head_p, cfg.d_state), device=device),
        "conv": torch.zeros((batch, cfg.d_conv - 1, cfg.conv_channels), dtype=dtype,
                            device=device),
    }


def state_axes(cfg: Mamba2Config) -> Dict:
    return {"ssm": ("batch", "ssm_heads", None, None), "conv": ("batch", None, "inner_conv")}


def decode_block(cfg: Mamba2Config, p: Dict, state: Dict, x: torch.Tensor):
    """One token. x (B, d_model) -> (out (B, d_model), new state)."""
    b = x.shape[0]
    h, pp, n, di = cfg.n_heads, cfg.head_p, cfg.d_state, cfg.d_inner
    z, xbc, dt = _split_proj(cfg, x @ p["in_proj"])
    window = torch.cat([state["conv"], xbc[:, None]], dim=1)  # (B, K, Ch)
    conv_out = F.silu(torch.einsum("bkc,kc->bc", window, p["conv_w"]) + p["conv_b"])
    xi = conv_out[..., :di].reshape(b, h, pp).float()
    bm, cm = conv_out[..., di:di + n].float(), conv_out[..., di + n:].float()
    dt = F.softplus(dt.float() + p["dt_bias"])  # (B,H)
    a = torch.exp(dt * -torch.exp(p["A_log"]))  # (B,H)
    ssm = (a[..., None, None] * state["ssm"]
           + torch.einsum("bhp,bn->bhpn", xi * dt[..., None], bm))
    y = torch.einsum("bhpn,bn->bhp", ssm, cm) + p["D"][None, :, None] * xi
    y = y.reshape(b, di).to(x.dtype)
    y = L.rmsnorm(y * F.silu(z), p["norm"])
    return y @ p["out_proj"], {"ssm": ssm, "conv": window[:, 1:]}

"""Pieces shared by the plain references: matmuls at a stated precision,
norms, activations, rotary embeddings and attention, all in float32.

Plain PyTorch only. Nothing here imports the program under test, and
nothing imports JAX. TF32 must be off while a reference runs
(``exact_float32``), or a float32 matmul on the card would round its inputs
to 10 mantissa bits.
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F

#: largest finite values of float8 e4m3 (the OCP "fn" variant) and e5m2
E4M3_MAX = 448.0
E5M2_MAX = 57344.0


@contextlib.contextmanager
def exact_float32():
    """TF32 off for matmuls and convolutions inside, restored after."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def _to_fp8(x: torch.Tensor, dtype, top: float) -> torch.Tensor:
    """``x`` rounded to an 8-bit float under one per-tensor scale (its
    largest magnitude to the format's largest value), back in float32."""
    scale = x.abs().amax().clamp(min=1e-30) / top
    return (x / scale).to(dtype).to(torch.float32) * scale


class _Fp8Matmul(torch.autograd.Function):
    """``a @ b`` as an fp8 recipe computes it: forward operands in e4m3, the
    incoming gradient in e5m2, each under a per-tensor scale; products
    summed in float32."""

    @staticmethod
    def forward(ctx, a, b):
        qa, qb = _to_fp8(a, torch.float8_e4m3fn, E4M3_MAX), _to_fp8(b, torch.float8_e4m3fn, E4M3_MAX)
        ctx.save_for_backward(qa, qb)
        return qa @ qb

    @staticmethod
    def backward(ctx, g):
        qa, qb = ctx.saved_tensors
        qg = _to_fp8(g, torch.float8_e5m2, E5M2_MAX)
        return qg @ qb.transpose(-1, -2), qa.transpose(-1, -2) @ qg


class Precision:
    """How a reference multiplies: ``"float32"`` exactly, or ``"fp8"`` (the
    control: the step below the configurations' bfloat16), every matmul of
    the forward and backward pass on fp8 operands (``_Fp8Matmul``)."""

    def __init__(self, name: str = "float32"):
        if name not in ("float32", "fp8"):
            raise ValueError(f"unknown precision {name!r}")
        self.name = name

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        if self.name == "fp8":
            return _Fp8Matmul.apply(a, b)
        return a @ b


def layernorm(x, scale, bias, eps: float = 1e-5):
    mu = x.mean(-1, keepdim=True)
    var = (x - mu).square().mean(-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * scale + bias


def rmsnorm(x, scale, eps: float = 1e-6):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * scale


def gelu_tanh(x):
    return F.gelu(x, approximate="tanh")


ACT = {"gelu": gelu_tanh, "silu": F.silu}


def rope(x, theta: float):
    """Rotary embedding of ``x`` (S, H, D) at positions 0..S-1, the
    rotate-half pairing (dims i and i + D/2), as GPT-NeoX and StarCoder2."""
    s, _, d = x.shape
    half = d // 2
    freqs = theta ** (-torch.arange(half, dtype=torch.float32, device=x.device) / half)
    ang = torch.arange(s, dtype=torch.float32, device=x.device)[:, None] * freqs
    cos, sin = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)


def attention(prec: Precision, q, k, v, causal: bool):
    """Softmax attention of one sequence: q (Sq, H, D), k and v (Skv, KVH, D),
    query head h reading kv head h // (H / KVH). Returns (Sq, H * D)."""
    sq, h, d = q.shape
    skv, kvh, _ = k.shape
    rep = h // kvh
    k = k.repeat_interleave(rep, dim=1)
    v = v.repeat_interleave(rep, dim=1)
    scores = prec.mm(q.transpose(0, 1), k.permute(1, 2, 0)) / math.sqrt(d)  # (H, Sq, Skv)
    if causal:
        mask = torch.ones(sq, skv, dtype=torch.bool, device=q.device).tril(skv - sq)
        scores = scores.masked_fill(~mask, float("-inf"))
    p = torch.softmax(scores, dim=-1)
    return prec.mm(p, v.transpose(0, 1)).transpose(0, 1).reshape(sq, h * d)


def cross_entropy(logits, targets):
    """Mean over positions of -log softmax(logits)[target]."""
    return F.cross_entropy(logits, targets.long())

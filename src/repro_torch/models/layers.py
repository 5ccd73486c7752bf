"""Shared neural-net layers (plain functions over tensors and param dicts).

Counterpart of the dense subset of ``repro.models.layers``, in the JAX
package's layouts: activations ``(B, S, H, D)``, per-layer weights stacked
on a leading ``layers`` axis. Precision follows the reference: norms and
softmax statistics in float32, products of low-precision inputs summed in
float32.
"""

from __future__ import annotations

import contextlib
import functools
import math
from concurrent.futures import ThreadPoolExecutor
from typing import Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from ..parallel.sharding import as_dtensor, note_site, redistribute, run_local
from ..utils.tracing import count

NEG_INF = -1e30


# ---------------------------------------------------------------------------
# initialisers / norms / activations
# ---------------------------------------------------------------------------


_META_INIT = False


@contextlib.contextmanager
def meta_init():
    """Inside, ``dense_init`` and ``sliced_init`` draw nothing and return
    meta tensors: a full config's param tree as shapes and dtypes only."""
    global _META_INIT
    prev, _META_INIT = _META_INIT, True
    try:
        yield
    finally:
        _META_INIT = prev


def dense_init(generator: torch.Generator, shape, in_axis: int = 0,
               dtype=torch.float32) -> torch.Tensor:
    """Normal(0, 1/fan_in) weights drawn on the CPU from ``generator`` (so a
    seed gives the same weights whatever device they are moved to)."""
    if _META_INIT:
        return torch.empty(shape, dtype=dtype, device="meta")
    fan_in = shape[in_axis]
    w = torch.randn(shape, generator=generator, dtype=torch.float32)
    return (w * (1.0 / math.sqrt(fan_in))).to(dtype)


#: host threads that draw the slices of one stacked leaf at once
_INIT_WORKERS = 8


def sliced_init(generator: torch.Generator, shape, n_lead: int, dtype,
                device) -> torch.Tensor:
    """``dense_init`` of a leaf stacked on its ``n_lead`` leading axes (fan-in
    on the first axis after them), in ``dtype`` on ``device``. Each slice is
    drawn by its own CPU generator, seeded in order from ``generator``, so a
    seed gives the same weights on every device; slices are drawn by a few
    host threads at once and copied straight into the preallocated stacked
    tensor, so the host holds a few slices at a time, not the whole leaf in
    float32."""
    if _META_INIT:
        return torch.empty(shape, dtype=dtype, device="meta")
    lead = shape[:n_lead]
    n = math.prod(lead)
    seeds = torch.randint(2**62, (n,), generator=generator).tolist()
    out = torch.empty(shape, dtype=dtype, device=device)
    flat = out.view(n, *shape[n_lead:])

    def draw(i):
        g = torch.Generator().manual_seed(seeds[i])
        return dense_init(g, shape[n_lead:], in_axis=0, dtype=dtype)

    with ThreadPoolExecutor(_INIT_WORKERS) as pool:
        for i, w in enumerate(pool.map(draw, range(n))):
            flat[i] = w
    return out


def rmsnorm(x, scale, eps: float = 1e-6):
    var = x.float().square().mean(dim=-1, keepdim=True)
    return (x * torch.rsqrt(var + eps)).to(x.dtype) * scale


def layernorm(x, scale, bias, eps: float = 1e-5):
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, keepdim=True, unbiased=False)
    return ((xf - mu) * torch.rsqrt(var + eps)).to(x.dtype) * scale + bias


ACTIVATIONS: dict = {
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
    "silu": F.silu,
    "relu": F.relu,
    "sqrelu": lambda x: F.relu(x).square(),
}


# ---------------------------------------------------------------------------
# embedding lookup
# ---------------------------------------------------------------------------


class _SumOverGroups(torch.autograd.Function):
    """Each rank's partial summed over ``groups``; the cotangent of the sum
    is the same on every rank, so it passes through."""

    @staticmethod
    def forward(ctx, x, groups):
        y = x.clone()
        for g in groups:
            dist.all_reduce(y, group=g)
        return y

    @staticmethod
    def backward(ctx, g):
        return g, None


def embed(w, tokens):
    """``w[tokens]``: rows of an embedding table (V, d).

    On a DTensor table whose rows are split (the rules' ``vocab``), each rank
    looks up the ids that fall in its rows, zeros for the others, and the
    rows are summed over the split: the vocab-parallel embedding, exact
    since one rank holds each row. The tokens keep their batch split. Any
    other split of the table (ZeRO's, or a mesh dim that also splits the
    tokens) is gathered first (site "embedding")."""
    if not isinstance(w, DTensor):
        return w[tokens.long()]
    mesh = w.device_mesh
    tok = as_dtensor(tokens, mesh)
    rows_dims = [i for i, p in enumerate(w.placements)
                 if p == Shard(0) and not isinstance(tok.placements[i], Shard)]
    w_pl = tuple(Shard(0) if i in rows_dims else Replicate() for i in range(mesh.ndim))
    tok_pl = tuple(Replicate() if i in rows_dims or not isinstance(p, Shard) else p
                   for i, p in enumerate(tok.placements))
    if any(isinstance(p, Shard) and p != q and mesh.size(i) > 1
           for i, (p, q) in enumerate(zip(w.placements, w_pl))):
        note_site("embedding")
    grad_pl = [Shard(0) if i in rows_dims else Partial() if isinstance(tok_pl[i], Shard)
               else Replicate() for i in range(mesh.ndim)]
    wl = redistribute(w, w_pl).to_local(grad_placements=grad_pl)
    tl = redistribute(tok, tok_pl).to_local()
    n_rows, block = wl.shape[0], 0
    for i in rows_dims:  # DTensor splits over mesh dims in order, major first
        block = block * mesh.size(i) + mesh.get_local_rank(i)
    ids = tl.long() - block * n_rows
    inside = (ids >= 0) & (ids < n_rows)
    out = wl[ids.clamp(0, n_rows - 1)] * inside[..., None].to(wl.dtype)
    if rows_dims:
        out = _SumOverGroups.apply(out, [mesh.get_group(i) for i in rows_dims])
    return DTensor.from_local(out, mesh, tok_pl, run_check=False)


# ---------------------------------------------------------------------------
# rotary position embeddings
# ---------------------------------------------------------------------------


def rope_angles(positions, head_dim: int, theta: float = 10000.0):
    """positions (...,) -> cos/sin (..., head_dim//2)."""
    half = head_dim // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32, device=positions.device)
                      / half)
    ang = positions.float()[..., None] * freqs
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x, positions, theta: float = 10000.0):
    """x (..., S, H, D); positions broadcastable to (..., S)."""
    cos, sin = rope_angles(positions, x.shape[-1], theta)  # (..., S, D/2)
    cos, sin = cos[..., None, :], sin[..., None, :]  # head axis
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------


def split_heads(x, heads: int, dh: int):
    """(B, S, heads * dh) -> (B, S, heads, dh). A DTensor whose last dim is
    split over mesh dims that do not divide ``heads`` would be cut inside a
    head: it is gathered on that dim first (site "heads reshape")."""
    b, s, _ = x.shape
    if isinstance(x, DTensor):
        last = x.ndim - 1
        n = math.prod(x.device_mesh.size(i) for i, p in enumerate(x.placements)
                      if isinstance(p, Shard) and p.dim == last)
        if heads % n:
            note_site("heads reshape")
            x = redistribute(x, [Replicate() if isinstance(p, Shard) and p.dim == last else p
                                 for p in x.placements])
    return x.reshape(b, s, heads, dh)


def merge_heads(x):
    """(B, S, heads, dh) -> (B, S, heads * dh). On a DTensor the gradient
    of the merged dim is laid out as the merged activation was before it
    is split into heads again: a projection sharded over more ranks than
    there are heads hands back a gradient cut inside a head, which the
    head split cannot take (paligemma's 8 heads on a 16-wide model axis)."""
    b, s = x.shape[:2]
    y = x.reshape(b, s, -1)
    if isinstance(y, DTensor) and y.requires_grad:
        pl = tuple(y.placements)
        y.register_hook(lambda g: redistribute(g, pl))
    return y


def _expand_kv(k, n_heads: int):
    """(B, S, KVH, D) -> (B, S, H, D) by repeating each kv head."""
    n_kv = k.shape[2]
    if n_kv == n_heads:
        return k
    return k.repeat_interleave(n_heads // n_kv, dim=2)


MAX_Q_BLOCKS = 16


def _block_layout(sq: int, skv: int, kv_block: int):
    """(q blocks, q block size, kv block size, kv blocks): the reference's
    static tiling of the score matrix."""
    n_q_blocks = max(1, min(MAX_Q_BLOCKS, sq // max(kv_block, 1)))
    while sq % n_q_blocks:
        n_q_blocks -= 1
    q_block = sq // n_q_blocks
    kvb = min(kv_block, skv)
    while skv % kvb:
        kvb -= 1
    return n_q_blocks, q_block, kvb, skv // kvb


def _kv_range(qi, q_block, kvb, n_kv_blocks, causal, window, prefix_len, q_offset) -> range:
    """The kv blocks q block ``qi`` can reach. A prefix-LM mask lets prefix
    rows attend forward, so a prefix turns block skipping off."""
    has_prefix = prefix_len is not None
    q_end = q_offset + (qi + 1) * q_block
    if causal and not has_prefix:
        hi = min(n_kv_blocks, -(-q_end // kvb))
    else:
        hi = n_kv_blocks
    if window is not None and not has_prefix:
        lo = max(0, (q_offset + qi * q_block - window) // kvb)
    else:
        lo = 0
    return range(lo, hi)


def _mask_bias(q_pos, kv_pos, causal, window, prefix_len):
    """Additive mask (0 visible, NEG_INF masked): (1,1,q,k), or (B,1,q,k)
    for a per-sequence prefix."""
    vis = torch.ones((q_pos.shape[0], kv_pos.shape[0]), dtype=torch.bool, device=q_pos.device)
    if causal:
        vis = kv_pos[None, :] <= q_pos[:, None]
    if window is not None:
        vis = vis & (kv_pos[None, :] > (q_pos[:, None] - window))
    if prefix_len is not None:
        if isinstance(prefix_len, torch.Tensor) and prefix_len.dim():  # (B,) per sequence
            vis = vis[None] | (kv_pos[None, None, :] < prefix_len[:, None, None])
            return torch.zeros(vis.shape, device=vis.device).masked_fill_(~vis, NEG_INF)[:, None]
        vis = vis | (kv_pos[None, :] < prefix_len)
    return torch.zeros(vis.shape, device=vis.device).masked_fill_(~vis, NEG_INF)[None, None]


def _flash_fwd_blocks(q, kf, vf, prefix_len, causal, window, q_offset, kv_block, scale):
    """Forward pass over (q block, kv block) tiles with an online softmax.
    Returns o (q's dtype) and the per-row statistics m, l (B, H, Sq)."""
    b, sq, h, d = q.shape
    skv = kf.shape[1]
    n_q, q_block, kvb, n_kv = _block_layout(sq, skv, kv_block)
    outs, ms, ls = [], [], []
    for qi in range(n_q):
        qs = q[:, qi * q_block:(qi + 1) * q_block] * scale
        q_pos = q_offset + qi * q_block + torch.arange(q_block, device=q.device)
        m = torch.full((b, h, q_block), NEG_INF, device=q.device)
        l = torch.zeros((b, h, q_block), device=q.device)
        acc = torch.zeros((b, q_block, h, d), device=q.device)
        reach = _kv_range(qi, q_block, kvb, n_kv, causal, window, prefix_len, q_offset)
        count("attn.fwd_tiles", len(reach))
        for j in reach:
            kj, vj = kf[:, j * kvb:(j + 1) * kvb], vf[:, j * kvb:(j + 1) * kvb]
            kv_pos = j * kvb + torch.arange(kvb, device=q.device)
            s = torch.einsum("bqhd,bkhd->bhqk", qs.float(), kj.float())
            s = s + _mask_bias(q_pos, kv_pos, causal, window, prefix_len)
            m_new = torch.maximum(m, s.amax(-1))
            alpha = torch.exp(m - m_new)
            p = torch.exp(s - m_new[..., None])
            l = alpha * l + p.sum(-1)
            pv = torch.einsum("bhqk,bkhd->bqhd", p.to(kj.dtype).float(), vj.float())
            acc = alpha.transpose(1, 2)[..., None] * acc + pv
            m = m_new
        lsafe = torch.where(l > 0, l, torch.ones_like(l))
        outs.append((acc / lsafe.transpose(1, 2)[..., None]).to(q.dtype))
        ms.append(m)
        ls.append(lsafe)
    return torch.cat(outs, 1), torch.cat(ms, -1), torch.cat(ls, -1)


def _flash_bwd_blocks(q, kf, vf, prefix_len, o, m, l, do, causal, window, q_offset,
                      kv_block, scale):
    """FlashAttention-2 style backward: p is recomputed tile by tile from
    (q, k, m, l), so no (Sq, Skv) residual is kept. Returns f32 dq and the
    expanded-head dk, dv."""
    b, sq, h, d = q.shape
    skv = kf.shape[1]
    n_q, q_block, kvb, n_kv = _block_layout(sq, skv, kv_block)
    dof = do.float()
    delta = torch.einsum("bqhd,bqhd->bhq", dof, o.float())  # rowsum(do * o)
    dq = torch.zeros((b, sq, h, d), device=q.device)
    dk = torch.zeros((b, skv, h, d), device=q.device)
    dv = torch.zeros((b, skv, h, d), device=q.device)
    for qi in range(n_q):
        sl = slice(qi * q_block, (qi + 1) * q_block)
        qs = (q[:, sl] * scale).float()
        doq, mi, li, di = dof[:, sl], m[..., sl], l[..., sl], delta[..., sl]
        q_pos = q_offset + qi * q_block + torch.arange(q_block, device=q.device)
        dqi = torch.zeros((b, q_block, h, d), device=q.device)
        for j in _kv_range(qi, q_block, kvb, n_kv, causal, window, prefix_len, q_offset):
            span = slice(j * kvb, (j + 1) * kvb)
            kj, vj = kf[:, span].float(), vf[:, span].float()
            kv_pos = j * kvb + torch.arange(kvb, device=q.device)
            s = torch.einsum("bqhd,bkhd->bhqk", qs, kj)
            s = s + _mask_bias(q_pos, kv_pos, causal, window, prefix_len)
            p = torch.exp(s - mi[..., None]) / li[..., None]
            dv[:, span] += torch.einsum("bhqk,bqhd->bkhd", p, doq)
            dp = torch.einsum("bqhd,bkhd->bhqk", doq, vj)
            ds = p * (dp - di[..., None])
            dqi = dqi + torch.einsum("bhqk,bkhd->bqhd", ds, kj)
            dk[:, span] += torch.einsum("bhqk,bqhd->bkhd", ds, qs)
        dq[:, sl] = dqi * scale
    return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    """Blocked attention whose backward recomputes scores: the residuals are
    q, the expanded k and v, o and the per-row (m, l) only."""

    @staticmethod
    def forward(ctx, q, k, v, prefix_len, causal, window, q_offset, kv_block, scale):
        h = q.shape[2]
        kf, vf = _expand_kv(k, h), _expand_kv(v, h)
        o, m, l = _flash_fwd_blocks(q, kf, vf, prefix_len, causal, window, q_offset,
                                    kv_block, scale)
        ctx.save_for_backward(q, kf, vf, o, m, l)
        ctx.opts = (prefix_len, causal, window, q_offset, kv_block, scale, k.shape[2])
        return o

    @staticmethod
    def backward(ctx, do):
        q, kf, vf, o, m, l = ctx.saved_tensors
        prefix_len, causal, window, q_offset, kv_block, scale, n_kv = ctx.opts
        dq, dkf, dvf = _flash_bwd_blocks(q, kf, vf, prefix_len, o, m, l, do, causal, window,
                                         q_offset, kv_block, scale)
        b, skv, h, d = dkf.shape
        if n_kv != h:  # fold the expanded heads' cotangents back onto the kv heads
            dkf = dkf.reshape(b, skv, n_kv, h // n_kv, d).sum(3)
            dvf = dvf.reshape(b, skv, n_kv, h // n_kv, d).sum(3)
        # prefix_len and the static options get no cotangent
        return (dq.to(q.dtype), dkf.to(q.dtype), dvf.to(q.dtype),
                None, None, None, None, None, None)


def flash_attention(
    q: torch.Tensor,  # (B, Sq, H, D)
    k: torch.Tensor,  # (B, Skv, KVH, D)
    v: torch.Tensor,  # (B, Skv, KVH, D)
    *,
    causal: bool = True,
    window: Optional[int] = None,  # sliding-window size (SWA)
    prefix_len=None,  # int or (B,) tensor: bidirectional prefix (prefix-LM)
    q_offset: int = 0,
    kv_block: int = 512,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Blocked flash attention with a recomputing backward, in plain PyTorch:
    the JAX package's ``flash_attention`` and its custom VJP, tile for tile.
    Tiles only the causal / sliding-window reach of each q block; GQA
    expands K/V inside and folds the cotangents back onto the kv heads. A
    tensor ``prefix_len`` gets no gradient.

    On DTensors it runs on each rank's batch rows and, when q, k and v
    split their heads over the same mesh dims, on its local heads; any
    other split (a sequence split, heads that do not divide) is gathered
    (site "attention")."""
    if isinstance(q, DTensor):
        def heads(t):
            return [isinstance(p, Shard) and p.dim == 2 for p in t.placements]

        per_row = isinstance(prefix_len, DTensor)  # a (B,) prefix goes with the rows

        def local(q_, k_, v_, *pl):
            return flash_attention(q_, k_, v_, causal=causal, window=window,
                                   prefix_len=pl[0] if per_row else prefix_len,
                                   q_offset=q_offset, kv_block=kv_block, scale=scale)

        aligned = heads(q) == heads(k) == heads(v)
        return run_local("attention", local, (q, k, v) + ((prefix_len,) if per_row else ()),
                         keep=(0, 2) if aligned else (0,))
    d = q.shape[-1]
    scale = (d**-0.5) if scale is None else scale
    if isinstance(prefix_len, torch.Tensor):
        prefix_len = prefix_len.to(q.device)
    return _FlashAttention.apply(q, k, v, prefix_len, causal, window, q_offset, kv_block,
                                 scale)


def write_token(cache, pos, new) -> None:
    """``cache[b, pos[b]] = new[b]`` for every row b, in place: a decode
    step's new K or V (B, KVH, D) into one layer's cache (B, S, KVH, D).

    On a DTensor cache each rank writes into its own shard: the rows of its
    batch block at the positions its sequence block holds, every other
    entry rewritten with its old value, so no shape depends on the data.
    The new token and the positions are gathered whole first (site "cache
    write")."""
    if not isinstance(cache, DTensor):
        rows = torch.arange(cache.shape[0], device=cache.device)
        cache[rows, pos] = new.to(cache.dtype)
        return
    mesh = cache.device_mesh
    note_site("cache write")
    whole = [Replicate()] * mesh.ndim
    pos_all = redistribute(as_dtensor(pos, mesh), whole).to_local()
    new_all = redistribute(as_dtensor(new, mesh), whole).to_local().to(cache.dtype)
    local = cache.to_local()
    start = [0] * cache.ndim  # this shard's first index in each dim
    size = list(cache.shape)
    for i, p in enumerate(cache.placements):  # split over mesh dims in order, major first
        if isinstance(p, Shard):
            size[p.dim] //= mesh.size(i)
            start[p.dim] += mesh.get_local_rank(i) * size[p.dim]
    b0, s0 = start[0], start[1]
    nb, ns = local.shape[0], local.shape[1]
    pos_l = pos_all.long()[b0:b0 + nb] - s0
    inside = (pos_l >= 0) & (pos_l < ns)
    pos_l = pos_l.clamp(0, ns - 1)
    rows = torch.arange(nb, device=local.device)
    new_l = new_all[b0:b0 + nb, start[2]:start[2] + local.shape[2],
                    start[3]:start[3] + local.shape[3]]
    local[rows, pos_l] = torch.where(inside[:, None, None], new_l, local[rows, pos_l])


@functools.lru_cache(maxsize=64)
def _identity_table(batch: int, device: torch.device) -> torch.Tensor:
    """The page table of a dense cache read as an arena: chunk b is sequence b."""
    return torch.arange(batch, dtype=torch.int32, device=device)[:, None]


def _decode_attention_kernel(q, k_cache, v_cache, lengths, *, window=None, scale=None):
    """``decode_attention_dense`` through the port's flash-decoding kernel:
    one layer's cache (B, S, KVH, D) read as an arena of B chunks of S
    tokens under the identity page table, so each sequence's valid tokens
    are read once, in the cache's dtype, with no head expansion or copy.
    Softmax statistics, probabilities and sums stay in float32 (the plain
    path rounds the probabilities to q's dtype before P.V). A CPU tensor
    takes the kernel wrapper's plain version."""
    from ..kernels.stitched_attention import stitched_decode_attention

    if window is not None and window < 1:
        raise ValueError(f"window must be None or positive, got {window}")
    b, _, h, d = q.shape
    count("attn.decode_kernel")
    out = stitched_decode_attention(
        q.reshape(b, h, d).contiguous(), k_cache, v_cache, _identity_table(b, q.device),
        lengths.to(torch.int32), scale=scale, window=window or 0)
    return out[:, None]


def decode_attention_dense(
    q: torch.Tensor,  # (B, 1, H, D)
    k_cache: torch.Tensor,  # (B, S, KVH, D)
    v_cache: torch.Tensor,  # (B, S, KVH, D)
    lengths: torch.Tensor,  # (B,) valid tokens in cache (new token included)
    *,
    window: Optional[int] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Single-token decode over a dense KV cache (serve_step path). On the
    card it runs the flash-decoding kernel (``_decode_attention_kernel``);
    CPU tensors and DTensors take the plain code below."""
    if q.is_cuda and not any(isinstance(t, DTensor) for t in (q, k_cache, v_cache)):
        return _decode_attention_kernel(q, k_cache, v_cache, lengths, window=window, scale=scale)
    b, _, h, d = q.shape
    s = k_cache.shape[1]
    scale = (d**-0.5) if scale is None else scale
    kf = _expand_kv(k_cache, h)
    vf = _expand_kv(v_cache, h)
    logits = torch.einsum("bqhd,bshd->bhqs", (q * scale).float(), kf.float())
    pos = torch.arange(s, device=q.device)[None, :]
    valid = pos < lengths.long()[:, None]
    if window is not None:
        valid = valid & (pos > (lengths.long()[:, None] - 1 - window))
    logits = logits.masked_fill(~valid[:, None, None, :], NEG_INF)
    p = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhqs,bshd->bqhd", p.float(), vf.float()).to(q.dtype)


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------


def mlp_init(generator: torch.Generator, d_model: int, d_ff: int, gated: bool,
             dtype=torch.float32) -> dict:
    """One MLP's weights, drawn in the reference's order: ``wi``, ``wo``,
    then ``wg`` when gated."""
    p = {
        "wi": dense_init(generator, (d_model, d_ff), dtype=dtype),
        "wo": dense_init(generator, (d_ff, d_model), dtype=dtype),
    }
    if gated:
        p["wg"] = dense_init(generator, (d_model, d_ff), dtype=dtype)
    return p


def mlp_axes(gated: bool) -> dict:
    p = {"wi": ("embed", "ffn"), "wo": ("ffn", "embed")}
    if gated:
        p["wg"] = ("embed", "ffn")
    return p


def mlp_apply(params: dict, x: torch.Tensor, act: str = "gelu", gated: bool = False):
    a = ACTIVATIONS[act]
    h = x @ params["wi"]
    if gated:
        h = a(x @ params["wg"]) * h
    else:
        h = a(h)
    return h @ params["wo"]


# ---------------------------------------------------------------------------
# cross-entropy
# ---------------------------------------------------------------------------


def _nll(logits, targets):
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, targets.long()[..., None])[..., 0]
    return logz - gold


def softmax_xent(logits: torch.Tensor, targets: torch.Tensor, mask=None) -> torch.Tensor:
    """logits (..., V) float, targets (...) int -> mean xent. On DTensors
    the per-position loss runs on each rank's positions with the vocab
    gathered (site "cross-entropy")."""
    nll = run_local("cross-entropy", _nll, (logits, targets), keep=range(logits.ndim - 1))
    if mask is not None:
        return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
    return nll.mean()

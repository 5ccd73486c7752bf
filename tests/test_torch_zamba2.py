"""Port parity: the hybrid family (mamba2 mixers + zamba2) against the JAX package.

Weights come from the JAX init through ``zamba2.params_from_jax_numpy``
(``A_log``, ``D`` and ``dt_bias`` kept float32), inputs from a numpy seed.
The chunked SSD scan must match the reference's within 1e-5 of each
output's largest value, on lengths that are and are not multiples of the
chunk; the port must keep the reference's own consistency properties
(chunked == sequential recurrence, prefill + decode == forward, with the
reference's limits); one mixer and the whole model's f32 loss and every
gradient leaf must match ``jax.value_and_grad`` within 1e-4, and the bf16
smoke loss within one bf16 rounding (2^-8)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.configs import get_arch as jget_arch
from repro.models import mamba2 as JM2
from repro.models import zamba2 as JZ
from repro_torch.configs import get_arch
from repro_torch.models import mamba2 as M2
from repro_torch.models import zamba2 as Z
from repro_torch.models import layers as L
from repro_torch.tree import flatten_with_path, leaves, unflatten_like

KEY = jax.random.PRNGKey(0)
TOL = dict(rtol=1e-4, atol=1e-4)


def t(x):
    return torch.from_numpy(np.asarray(x, np.float32))


def row_close(got, want, tol):
    """Every element within ``tol`` of its array's largest |value|."""
    want = np.asarray(want, np.float32)
    err = np.abs(got.detach().float().numpy() - want).max()
    assert err <= tol * np.abs(want).max(), (err, np.abs(want).max())


def smoke(dtype="float32"):
    jcfg = jget_arch("zamba2-1.2b").smoke
    cfg = get_arch("zamba2-1.2b").smoke
    if dtype == "bfloat16":
        jcfg = dataclasses.replace(jcfg, dtype=jnp.bfloat16)
        cfg = dataclasses.replace(cfg, dtype=torch.bfloat16)
    jparams = JZ.init_params(jcfg, KEY)
    return jcfg, jparams, cfg, Z.params_from_jax_numpy(cfg, jax.tree.map(np.asarray, jparams),
                                                       device="cpu")


@pytest.mark.parametrize("s", [32, 24, 20, 13])
def test_ssd_chunked_matches_reference(s):
    """Chunk 8: 32 and 24 run whole chunks, 20 falls back to chunks of 4 and
    13 to chunks of 1, as the reference's ``while s % q`` rule does."""
    cfg = M2.Mamba2Config(d_model=32, d_state=16, head_p=8, chunk=8)
    rng = np.random.default_rng(s)
    b, h, p, n = 2, cfg.n_heads, cfg.head_p, cfg.d_state
    x = rng.standard_normal((b, s, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, s, h)))).astype(np.float32)
    a = -np.exp(rng.standard_normal(h) * 0.3).astype(np.float32)
    bm, cm = (rng.standard_normal((b, s, n)).astype(np.float32) for _ in range(2))
    jy, jh = JM2._ssd_chunked(cfg, *(jnp.asarray(v) for v in (x, dt, a, bm, cm)))
    y, hs = M2._ssd_chunked(cfg, *(torch.from_numpy(v) for v in (x, dt, a, bm, cm)))
    row_close(y, jy, 1e-5)
    row_close(hs, jh, 1e-5)


def test_mamba2_chunked_equals_sequential_and_decode():
    """The reference's ``test_mamba2_chunked_equals_sequential`` on the port:
    the chunked mixer equals a step-by-step recurrence, decode reaches the
    same last output, and prefill's final states equal the recurrence's."""
    cfg = M2.Mamba2Config(d_model=32, d_state=16, head_p=8, expand=2, chunk=8)
    p = {k: v[0] for k, v in M2.block_init(cfg, torch.Generator().manual_seed(0), 1,
                                           torch.float32, "cpu").items()}
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((2, 24, 32))
                         .astype(np.float32) * 0.5)
    y, hstate, conv = M2.apply_block_with_state(cfg, p, x)
    b, s, _ = x.shape
    h, pp, n = cfg.n_heads, cfg.head_p, cfg.d_state
    z, xbc, dt = M2._split_proj(cfg, x @ p["in_proj"])
    xbc = M2._causal_conv(cfg, p["conv_w"], p["conv_b"], xbc)
    xi = xbc[..., :cfg.d_inner].reshape(b, s, h, pp)
    bm, cm = xbc[..., cfg.d_inner:cfg.d_inner + n], xbc[..., cfg.d_inner + n:]
    dt = F.softplus(dt + p["dt_bias"])
    hs = torch.zeros((b, h, pp, n))
    ys = []
    for i in range(s):
        at = torch.exp(dt[:, i] * -torch.exp(p["A_log"]))
        hs = at[..., None, None] * hs + torch.einsum("bhp,bn,bh->bhpn", xi[:, i], bm[:, i],
                                                     dt[:, i])
        ys.append(torch.einsum("bhpn,bn->bhp", hs, cm[:, i]))
    yr = torch.stack(ys, 1) + p["D"][None, None, :, None] * xi
    yr = L.rmsnorm(yr.reshape(b, s, cfg.d_inner) * F.silu(z), p["norm"])
    ref = yr @ p["out_proj"]
    torch.testing.assert_close(y, ref, **TOL)
    torch.testing.assert_close(hstate, hs, **TOL)
    st = M2.init_state(cfg, 2, torch.float32, "cpu")
    for i in range(s):
        out, st = M2.decode_block(cfg, p, st, x[:, i])
    torch.testing.assert_close(out, ref[:, -1], **TOL)
    torch.testing.assert_close(st["ssm"], hstate, **TOL)
    torch.testing.assert_close(st["conv"], conv)


def test_mixer_and_decode_block_match_reference():
    """One mixer of the smoke config (layer 1) over 16 positions, its final
    states, then 3 decode steps from them, against the reference's."""
    jcfg, jparams, cfg, params = smoke()
    li = 1
    jp = jax.tree.map(lambda a: a[li], jparams["mamba"])
    p = {k: v[li] for k, v in params["mamba"].items()}
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 16, cfg.d_model)).astype(np.float32)
    jy, jh, jc = JZ._apply_block_with_state(jcfg.mamba, jp, jnp.asarray(x))
    y, hs, c = M2.apply_block_with_state(cfg.mamba, p, torch.from_numpy(x))
    for got, want in ((y, jy), (hs, jh), (c, jc)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    jst, st = {"ssm": jh, "conv": jc}, {"ssm": hs, "conv": c}
    for _ in range(3):
        xt = rng.standard_normal((2, cfg.d_model)).astype(np.float32)
        jo, jst = JM2.decode_block(jcfg.mamba, jp, jst, jnp.asarray(xt))
        o, st = M2.decode_block(cfg.mamba, p, st, torch.from_numpy(xt))
        np.testing.assert_allclose(o.numpy(), np.asarray(jo), **TOL)
        np.testing.assert_allclose(st["ssm"].numpy(), np.asarray(jst["ssm"]), **TOL)


def test_forward_collects_kv_as_reference():
    jcfg, jparams, cfg, params = smoke()
    toks = np.random.default_rng(3).integers(0, cfg.vocab, (2, 16)).astype(np.int32)
    pos = np.broadcast_to(np.arange(16), (2, 16))
    jh, (jk, jv) = JZ.forward(jcfg, jparams, jparams["embed"][toks], jnp.asarray(pos),
                              collect_kv=True)
    h, (k, v) = Z.forward(cfg, params, params["embed"][torch.from_numpy(toks).long()],
                          torch.from_numpy(pos.copy()), collect_kv=True)
    assert k.shape == jk.shape == (cfg.n_apps, 2, 16, cfg.n_kv, cfg.dh)
    for got, want in ((h, jh), (k, jk), (v, jv)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_decode_equals_forward():
    """The reference's ``test_zamba2_decode_equals_forward`` on the port."""
    cfg = Z.Zamba2Config(name="t", n_layers=5, d_model=32, n_heads=4, n_kv=2, d_ff=64,
                         vocab=101, d_state=16, attn_every=2, chunk=8, dtype=torch.float32,
                         remat=False)
    params = Z.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    toks = torch.from_numpy(np.random.default_rng(0).integers(0, 101, (2, 16)))
    cache = Z.init_cache(cfg, 2, 32, device="cpu")
    lp, cache = Z.prefill(cfg, params, {"tokens": toks}, cache)
    nxt = lp[:, -1].argmax(-1)
    ld, _ = Z.decode_step(cfg, params, cache, nxt)
    toks2 = torch.cat([toks, nxt[:, None]], 1)
    h, _ = Z.forward(cfg, params, params["embed"][toks2], torch.arange(17).expand(2, 17))
    torch.testing.assert_close(ld, h[:, -1] @ params["embed"].T, rtol=2e-4, atol=2e-4)


def _loss_and_grads(cfg, params, batch):
    xs = [x.detach().requires_grad_(True) for x in leaves(params)]
    loss = Z.loss_fn(cfg, unflatten_like(params, xs), batch)
    grads = torch.autograd.grad(loss, xs)
    return float(loss.detach()), {p: g for (p, _), g in zip(flatten_with_path(params), grads)}


def test_loss_and_gradients_match_jax_grad_f32():
    jcfg, jparams, cfg, params = smoke()
    toks = np.random.default_rng(4).integers(0, cfg.vocab, (2, 24)).astype(np.int32)
    jloss, jgrads = jax.value_and_grad(lambda p: JZ.loss_fn(jcfg, p, {"tokens": toks}))(jparams)
    loss, grads = _loss_and_grads(cfg, params, {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(loss, float(jloss), rtol=1e-4)
    flat = jax.tree_util.tree_flatten_with_path(jgrads)[0]
    assert len(flat) == len(grads)
    for path, jg in flat:
        key = "".join(f"[{q.key!r}]" for q in path)
        np.testing.assert_allclose(grads[key].numpy(), np.asarray(jg), **TOL, err_msg=key)


def test_remat_gives_the_same_gradients():
    _, _, cfg, params = smoke()
    toks = {"tokens": torch.from_numpy(np.random.default_rng(5).integers(0, cfg.vocab, (2, 16)))}
    l1, g1 = _loss_and_grads(cfg, params, toks)
    l2, g2 = _loss_and_grads(dataclasses.replace(cfg, remat=True), params, toks)
    assert l1 == l2
    for k in g1:
        torch.testing.assert_close(g1[k], g2[k], rtol=1e-6, atol=1e-6)


def test_bf16_loss_matches_reference():
    """The smoke config in bf16, the full config's working type, with the
    float32 leaves kept: the loss within one bf16 rounding."""
    jcfg, jparams, cfg, params = smoke("bfloat16")
    assert params["mamba"]["A_log"].dtype == torch.float32
    assert params["mamba"]["in_proj"].dtype == torch.bfloat16
    toks = np.random.default_rng(6).integers(0, cfg.vocab, (2, 32)).astype(np.int32)
    jl = JZ.loss_fn(jcfg, jparams, {"tokens": jnp.asarray(toks)})
    tl = Z.loss_fn(cfg, params, {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(float(tl), float(jl), rtol=2.0**-8)


def test_init_params_tree_and_determinism():
    """The port's own init gives the reference's tree (keys, shapes, dtypes
    with the float32 leaves of a bf16 model), the same weights for a seed,
    and fan-in scaled projections."""
    jcfg = dataclasses.replace(jget_arch("zamba2-1.2b").smoke, dtype=jnp.bfloat16)
    cfg = dataclasses.replace(get_arch("zamba2-1.2b").smoke, dtype=torch.bfloat16)
    jtree = jax.eval_shape(lambda: JZ.init_params(jcfg, KEY))
    a = Z.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    b = Z.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    flat_j = jax.tree_util.tree_flatten_with_path(jtree)[0]
    assert [p for p, _ in flatten_with_path(a)] == \
        ["".join(f"[{q.key!r}]" for q in path) for path, _ in flat_j]
    for (path, x), (_, y), (_, j) in zip(flatten_with_path(a), flatten_with_path(b), flat_j):
        assert tuple(x.shape) == j.shape, path
        assert str(x.dtype).split(".")[-1] == jnp.dtype(j.dtype).name, path
        assert torch.equal(x, y), path
    w = a["mamba"]["in_proj"].float()
    assert not torch.equal(w[0], w[1])
    assert abs(float(w.std()) * cfg.d_model**0.5 - 1.0) < 0.1

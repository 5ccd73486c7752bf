"""Port parity: the ssm family (rwkv6) against the JAX package.

Weights come from the JAX init through ``rwkv6.params_from_jax_numpy``
(``w0`` and ``u`` kept float32), inputs from a numpy seed. The chunked WKV6
must match the reference's within 1e-5 of each output's largest value, on
lengths that are and are not multiples of the chunk; the port must keep the
reference's consistency properties (chunked == sequential recurrence,
chunked prefill == sequential decode, with its 2e-4 limit); the layer
steps, and the whole model's f32 loss and every gradient leaf, must match
JAX within 1e-4, and the bf16 smoke loss within one bf16 rounding."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch
from repro.models import rwkv6 as JR
from repro_torch.configs import get_arch
from repro_torch.models import rwkv6 as R
from repro_torch.tree import flatten_with_path, leaves, unflatten_like

KEY = jax.random.PRNGKey(0)
TOL = dict(rtol=1e-4, atol=1e-4)


def row_close(got, want, tol):
    """Every element within ``tol`` of its array's largest |value|."""
    want = np.asarray(want, np.float32)
    err = np.abs(got.detach().float().numpy() - want).max()
    assert err <= tol * np.abs(want).max(), (err, np.abs(want).max())


def smoke(dtype="float32"):
    jcfg = jget_arch("rwkv6-7b").smoke
    cfg = get_arch("rwkv6-7b").smoke
    if dtype == "bfloat16":
        jcfg = dataclasses.replace(jcfg, dtype=jnp.bfloat16)
        cfg = dataclasses.replace(cfg, dtype=torch.bfloat16)
    jparams = JR.init_params(jcfg, KEY)
    return jcfg, jparams, cfg, R.params_from_jax_numpy(cfg, jax.tree.map(np.asarray, jparams),
                                                       device="cpu")


def wkv_inputs(rng, b, s, h, d):
    r, k, v = (rng.standard_normal((b, s, h, d)).astype(np.float32) for _ in range(3))
    logw = -np.exp(np.minimum(rng.standard_normal((b, s, h, d)) - 1.0, R.DECAY_EXP_CAP))
    u = (rng.standard_normal((h, d)) * 0.1).astype(np.float32)
    return r, k, v, logw.astype(np.float32), u


@pytest.mark.parametrize("s", [32, 24, 20, 13])
def test_wkv6_chunked_matches_reference(s):
    """Chunk 8: 32 and 24 run whole chunks, 20 falls back to chunks of 4 and
    13 to chunks of 1."""
    cfg = get_arch("rwkv6-7b").smoke
    inp = wkv_inputs(np.random.default_rng(s), 2, s, 4, 16)
    jy, js = JR._wkv6_chunked(cfg, *(jnp.asarray(v) for v in inp))
    y, st = R._wkv6_chunked(cfg, *(torch.from_numpy(v) for v in inp))
    row_close(y, jy, 1e-5)
    row_close(st, js, 1e-5)


def test_wkv6_chunked_equals_sequential_recurrence():
    """The chunked form against the defining recurrence, step by step:
    y_t = r_t (S_{t-1} + diag(u) k_t v_t^T), S_t = diag(w_t) S_{t-1} + k_t v_t^T."""
    cfg = get_arch("rwkv6-7b").smoke
    r, k, v, logw, u = (torch.from_numpy(x) for x in
                        wkv_inputs(np.random.default_rng(7), 2, 24, 4, 16))
    y, st = R._wkv6_chunked(cfg, r, k, v, logw, u)
    S = torch.zeros((2, 4, 16, 16))
    ys = []
    for i in range(24):
        kv = torch.einsum("bhd,bhe->bhde", k[:, i], v[:, i])
        ys.append(torch.einsum("bhd,bhde->bhe", r[:, i], S + u[None, :, :, None] * kv))
        S = torch.exp(logw[:, i])[..., None] * S + kv
    torch.testing.assert_close(y, torch.stack(ys, 1), **TOL)
    torch.testing.assert_close(st, S, **TOL)


def test_time_and_channel_mix_and_steps_match_reference():
    """Layer 0's time-mix and channel-mix over 16 positions, then 3 single-
    token steps from the prefill's state, against the reference's."""
    jcfg, jparams, cfg, params = smoke()
    jlp = jax.tree.map(lambda a: a[0], jparams["layers"])
    lp = {g: {k: v[0] for k, v in params["layers"][g].items()} for g in ("tm", "cm")}
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 16, cfg.d_model)).astype(np.float32)
    out, S = R.time_mix_with_state(cfg, lp["tm"], torch.from_numpy(x))
    np.testing.assert_allclose(out.numpy(), np.asarray(JR.time_mix(jcfg, jlp["tm"],
                                                                   jnp.asarray(x))), **TOL)
    np.testing.assert_allclose(R.channel_mix(cfg, lp["cm"], torch.from_numpy(x)).numpy(),
                               np.asarray(JR.channel_mix(jcfg, jlp["cm"], jnp.asarray(x))), **TOL)
    jS, xp = jnp.asarray(S.numpy()), x[:, -1]
    for _ in range(3):
        xt = rng.standard_normal((2, cfg.d_model)).astype(np.float32)
        jo, jS = JR._tm_step(jcfg, jlp["tm"], jnp.asarray(xt), jnp.asarray(xp), jS)
        o, S = R._tm_step(cfg, lp["tm"], torch.from_numpy(xt), torch.from_numpy(xp), S)
        np.testing.assert_allclose(o.numpy(), np.asarray(jo), **TOL)
        np.testing.assert_allclose(S.numpy(), np.asarray(jS), **TOL)
        jc = JR._cm_step(jcfg, jlp["cm"], jnp.asarray(xt), jnp.asarray(xp))
        c = R._cm_step(cfg, lp["cm"], torch.from_numpy(xt), torch.from_numpy(xp))
        np.testing.assert_allclose(c.numpy(), np.asarray(jc), **TOL)
        xp = xt


def test_chunked_prefill_equals_sequential_decode():
    """The reference's ``test_rwkv6_chunked_prefill_equals_sequential_decode``
    on the port: decoding the prompt token by token ends at prefill's
    logits, and both carried states give the same next step."""
    cfg = R.RWKV6Config(name="t", n_layers=3, d_model=64, d_ff=128, vocab=101, head_size=16,
                        decay_lora=8, chunk=8, dtype=torch.float32, remat=False)
    params = R.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    toks = torch.from_numpy(np.random.default_rng(0).integers(0, 101, (2, 24)))
    lp, cache = R.prefill(cfg, params, {"tokens": toks}, R.init_cache(cfg, 2, device="cpu"))
    c = R.init_cache(cfg, 2, device="cpu")
    for i in range(24):
        lo, c = R.decode_step(cfg, params, c, toks[:, i])
    torch.testing.assert_close(lo, lp[:, -1], rtol=2e-4, atol=2e-4)
    nxt = lp[:, -1].argmax(-1)
    a, _ = R.decode_step(cfg, params, cache, nxt)
    b, _ = R.decode_step(cfg, params, c, nxt)
    torch.testing.assert_close(a, b, rtol=2e-4, atol=2e-4)


def test_decode_state_is_o1_in_history():
    """The reference's long-context premise: the state's size does not grow
    with the tokens decoded."""
    cfg = get_arch("rwkv6-7b").smoke
    params = R.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    cache = R.init_cache(cfg, 1, 500_000, device="cpu")
    shapes = {k: tuple(v.shape) for k, v in cache.items()}
    for i in range(40):
        _, cache = R.decode_step(cfg, params, cache, torch.tensor([i % cfg.vocab]))
    assert {k: tuple(v.shape) for k, v in cache.items()} == shapes
    assert cache["length"].tolist() == [40]


def _loss_and_grads(cfg, params, batch):
    xs = [x.detach().requires_grad_(True) for x in leaves(params)]
    loss = R.loss_fn(cfg, unflatten_like(params, xs), batch)
    grads = torch.autograd.grad(loss, xs)
    return float(loss.detach()), {p: g for (p, _), g in zip(flatten_with_path(params), grads)}


def test_loss_and_gradients_match_jax_grad_f32():
    jcfg, jparams, cfg, params = smoke()
    toks = np.random.default_rng(4).integers(0, cfg.vocab, (2, 24)).astype(np.int32)
    jloss, jgrads = jax.value_and_grad(lambda p: JR.loss_fn(jcfg, p, {"tokens": toks}))(jparams)
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
    jcfg, jparams, cfg, params = smoke("bfloat16")
    tm = params["layers"]["tm"]
    assert tm["w0"].dtype == tm["u"].dtype == torch.float32 and tm["wr"].dtype == torch.bfloat16
    toks = np.random.default_rng(6).integers(0, cfg.vocab, (2, 32)).astype(np.int32)
    jl = JR.loss_fn(jcfg, jparams, {"tokens": jnp.asarray(toks)})
    tl = R.loss_fn(cfg, params, {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(float(tl), float(jl), rtol=2.0**-8)


def test_init_params_tree_and_determinism():
    jcfg = dataclasses.replace(jget_arch("rwkv6-7b").smoke, dtype=jnp.bfloat16)
    cfg = dataclasses.replace(get_arch("rwkv6-7b").smoke, dtype=torch.bfloat16)
    jtree = jax.eval_shape(lambda: JR.init_params(jcfg, KEY))
    a = R.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    b = R.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    flat_j = jax.tree_util.tree_flatten_with_path(jtree)[0]
    assert [p for p, _ in flatten_with_path(a)] == \
        ["".join(f"[{q.key!r}]" for q in path) for path, _ in flat_j]
    for (path, x), (_, y), (_, j) in zip(flatten_with_path(a), flatten_with_path(b), flat_j):
        assert tuple(x.shape) == j.shape, path
        assert str(x.dtype).split(".")[-1] == jnp.dtype(j.dtype).name, path
        assert torch.equal(x, y), path
    w = a["layers"]["cm"]["wk"].float()
    assert not torch.equal(w[0], w[1])
    assert abs(float(w.std()) * cfg.d_model**0.5 - 1.0) < 0.1

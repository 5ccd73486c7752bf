"""Port parity: the audio family (whisper) against the JAX package.

Weights come from the JAX init through ``whisper.params_from_jax_numpy``,
inputs (frame embeddings and tokens) from a numpy seed. ``encode`` and
``decode_train`` (logits, self- and cross-K/V) must match the reference's
within 1e-4; prefill + decode must equal the teacher-forced decoder (the
reference's 3e-4 limit); the f32 loss and every gradient leaf must match
``jax.value_and_grad`` within 1e-4, and the bf16 smoke loss within one
bf16 rounding."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_arch as jget_arch
from repro.data.pipeline import DataConfig as JDataConfig, SyntheticTokens as JSyntheticTokens
from repro.models import whisper as JW
from repro_torch.configs import get_arch
from repro_torch.data.pipeline import DataConfig, SyntheticTokens
from repro_torch.models import whisper as W
from repro_torch.tree import flatten_with_path, leaves, unflatten_like

KEY = jax.random.PRNGKey(0)
TOL = dict(rtol=1e-4, atol=1e-4)


def smoke(dtype="float32"):
    jcfg = jget_arch("whisper-medium").smoke
    cfg = get_arch("whisper-medium").smoke
    if dtype == "bfloat16":
        jcfg = dataclasses.replace(jcfg, dtype=jnp.bfloat16)
        cfg = dataclasses.replace(cfg, dtype=torch.bfloat16)
    jparams = JW.init_params(jcfg, KEY)
    return jcfg, jparams, cfg, W.params_from_jax_numpy(cfg, jax.tree.map(np.asarray, jparams),
                                                       device="cpu")


def inputs(cfg, seed, n_frames=16, n_tok=12):
    rng = np.random.default_rng(seed)
    frames = rng.standard_normal((2, n_frames, cfg.d_model)).astype(np.float32)
    toks = rng.integers(0, cfg.vocab, (2, n_tok)).astype(np.int32)
    return frames, toks


def test_sinusoid_matches_reference():
    """Within one float32 ulp of the largest angle (2^-13 at 1499 rad): the
    two packages' ``pow`` differ by an ulp on a few frequencies."""
    for s, d in ((16, 64), (1500, 1024)):
        np.testing.assert_allclose(W._sinusoid(s, d, torch.float32, "cpu").numpy(),
                                   np.asarray(JW._sinusoid(s, d, jnp.float32)),
                                   rtol=0, atol=2.0**-13)


def test_encode_and_decode_train_match_reference():
    jcfg, jparams, cfg, params = smoke()
    frames, toks = inputs(cfg, 1)
    jmem = JW.encode(jcfg, jparams, jnp.asarray(frames))
    mem = W.encode(cfg, params, torch.from_numpy(frames))
    np.testing.assert_allclose(mem.numpy(), np.asarray(jmem), **TOL)
    jlog, ((jk, jv), (jxk, jxv)) = JW.decode_train(jcfg, jparams, jnp.asarray(toks), jmem,
                                                   collect_kv=True)
    log, ((k, v), (xk, xv)) = W.decode_train(cfg, params, torch.from_numpy(toks), mem,
                                             collect_kv=True)
    assert xk.shape == jxk.shape == (cfg.n_layers, 2, 16, cfg.n_kv, cfg.dh)
    for got, want in ((log, jlog), (k, jk), (v, jv), (xk, jxk), (xv, jxv)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_decode_equals_train_path():
    """The reference's ``test_whisper_decode_equals_train_path`` on the port."""
    cfg = W.WhisperConfig(name="t", n_layers=2, d_model=64, n_heads=4, n_kv=4, d_ff=128,
                          vocab=101, max_positions=64, dtype=torch.float32, remat=False)
    params = W.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    frames, toks = (torch.from_numpy(x) for x in inputs(cfg, 0))
    cache = W.init_cache(cfg, 2, 32, 16, device="cpu")
    lp, cache = W.prefill(cfg, params, {"frames": frames, "tokens": toks}, cache)
    nxt = lp[:, -1].argmax(-1)
    ld, _ = W.decode_step(cfg, params, cache, nxt)
    ref, _ = W.decode_train(cfg, params, torch.cat([toks, nxt[:, None]], 1),
                            W.encode(cfg, params, frames))
    torch.testing.assert_close(ld, ref[:, -1], rtol=3e-4, atol=3e-4)


def _loss_and_grads(cfg, params, batch):
    xs = [x.detach().requires_grad_(True) for x in leaves(params)]
    loss = W.loss_fn(cfg, unflatten_like(params, xs), batch)
    grads = torch.autograd.grad(loss, xs)
    return float(loss.detach()), {p: g for (p, _), g in zip(flatten_with_path(params), grads)}


def test_loss_and_gradients_match_jax_grad_f32():
    """On the data pipeline's audio batches (frames included), bit-identical
    in both packages."""
    jcfg, jparams, cfg, params = smoke()
    dc = dict(vocab=cfg.vocab, seq_len=24, global_batch=2, frame_dim=cfg.d_model)
    jbatch = JSyntheticTokens(JDataConfig(**dc)).batch_at(3)
    batch = SyntheticTokens(DataConfig(**dc), "cpu").batch_at(3)
    assert sorted(batch) == sorted(jbatch) == ["frames", "tokens"]
    for k in batch:
        np.testing.assert_array_equal(batch[k].numpy(), np.asarray(jbatch[k]))
    jloss, jgrads = jax.value_and_grad(lambda p: JW.loss_fn(jcfg, p, jbatch))(jparams)
    loss, grads = _loss_and_grads(cfg, params, batch)
    np.testing.assert_allclose(loss, float(jloss), rtol=1e-4)
    flat = jax.tree_util.tree_flatten_with_path(jgrads)[0]
    assert len(flat) == len(grads)
    for path, jg in flat:
        key = "".join(f"[{q.key!r}]" for q in path)
        np.testing.assert_allclose(grads[key].numpy(), np.asarray(jg), **TOL, err_msg=key)


def test_remat_gives_the_same_gradients():
    _, _, cfg, params = smoke()
    frames, toks = (torch.from_numpy(x) for x in inputs(cfg, 5))
    batch = {"frames": frames, "tokens": toks}
    l1, g1 = _loss_and_grads(cfg, params, batch)
    l2, g2 = _loss_and_grads(dataclasses.replace(cfg, remat=True), params, batch)
    assert l1 == l2
    for k in g1:
        torch.testing.assert_close(g1[k], g2[k], rtol=1e-6, atol=1e-6)


def test_bf16_loss_matches_reference():
    jcfg, jparams, cfg, params = smoke("bfloat16")
    frames, toks = inputs(cfg, 6, n_tok=32)
    jl = JW.loss_fn(jcfg, jparams, {"frames": jnp.asarray(frames), "tokens": jnp.asarray(toks)})
    tl = W.loss_fn(cfg, params, {"frames": torch.from_numpy(frames),
                                 "tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(float(tl), float(jl), rtol=2.0**-8)


def test_init_params_tree_and_determinism():
    jcfg = dataclasses.replace(jget_arch("whisper-medium").smoke, dtype=jnp.bfloat16)
    cfg = dataclasses.replace(get_arch("whisper-medium").smoke, dtype=torch.bfloat16)
    jtree = jax.eval_shape(lambda: JW.init_params(jcfg, KEY))
    a = W.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    b = W.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    flat_j = jax.tree_util.tree_flatten_with_path(jtree)[0]
    assert [p for p, _ in flatten_with_path(a)] == \
        ["".join(f"[{q.key!r}]" for q in path) for path, _ in flat_j]
    for (path, x), (_, y), (_, j) in zip(flatten_with_path(a), flatten_with_path(b), flat_j):
        assert tuple(x.shape) == j.shape, path
        assert str(x.dtype).split(".")[-1] == jnp.dtype(j.dtype).name, path
        assert torch.equal(x, y), path
    w = a["decoder"]["mlp"]["wi"].float()
    assert not torch.equal(w[0], w[1])
    assert abs(float(w.std()) * cfg.d_model**0.5 - 1.0) < 0.1

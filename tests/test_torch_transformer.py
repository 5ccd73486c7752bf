"""Port parity: the dense transformer and its layers against the JAX package.

Weights come from the JAX init and reach the port through
``params_from_jax_numpy``; token batches come from a numpy seed. Everything
runs in float32 at the smoke config, where the two must agree within
rtol/atol 1e-4 (summation order differs, nothing else)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch
from repro.models import layers as JL
from repro.models import transformer as JT
from repro_torch.configs import get_arch
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models.api import family_of

TOL = dict(rtol=1e-4, atol=1e-4)


def close(port, ref, **tol):
    np.testing.assert_allclose(port.float().numpy(), np.asarray(ref, np.float32), **(tol or TOL))


@pytest.fixture(scope="module")
def smoke():
    jcfg = jget_arch("smollm-135m").smoke
    cfg = get_arch("smollm-135m").smoke
    jparams = JT.init_params(jcfg, jax.random.PRNGKey(0))
    params = T.params_from_jax_numpy(cfg, jax.tree.map(np.asarray, jparams), device="cpu")
    return jcfg, jparams, cfg, params


@pytest.mark.parametrize("which", ["full", "smoke"])
def test_config_matches_reference(which):
    jcfg = getattr(jget_arch("smollm-135m"), which)
    cfg = getattr(get_arch("smollm-135m"), which)
    for f in dataclasses.fields(cfg):
        if f.name != "dtype":
            assert getattr(cfg, f.name) == getattr(jcfg, f.name), f.name
    assert str(cfg.dtype).split(".")[-1] == jnp.dtype(jcfg.dtype).name
    assert cfg.n_params == jcfg.n_params and cfg.dh == jcfg.dh


def test_init_params_tree_matches_reference(smoke):
    """The port's own init gives the reference's tree: same keys, shapes and
    dtype, and a seed gives the same weights on every call."""
    jcfg, jparams, cfg, _ = smoke
    a = T.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    b = T.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    flat_j = jax.tree_util.tree_flatten_with_path(jparams)[0]
    assert len(flat_j) == len(jax.tree.leaves(a))
    for path, leaf in flat_j:
        keys = [p.key for p in path]
        x, y = a, b
        for k in keys:
            x, y = x[k], y[k]
        assert tuple(x.shape) == leaf.shape and x.dtype == cfg.dtype, keys
        assert torch.equal(x, y)
    assert family_of(cfg).init_params is T.init_params


def test_loss_matches_reference(smoke):
    jcfg, jparams, cfg, params = smoke
    tokens = np.random.default_rng(0).integers(0, cfg.vocab, size=(2, 24)).astype(np.int32)
    mask = (np.arange(23)[None, :] < np.array([[23], [15]])).astype(np.float32)
    for extra_j, extra_t in (({}, {}), ({"loss_mask": jnp.asarray(mask)},
                                        {"loss_mask": torch.from_numpy(mask)})):
        jl = JT.loss_fn(jcfg, jparams, {"tokens": jnp.asarray(tokens), **extra_j})
        tl = T.loss_fn(cfg, params, {"tokens": torch.from_numpy(tokens), **extra_t})
        close(tl, jl)


def test_prefill_and_decode_match_reference(smoke):
    jcfg, jparams, cfg, params = smoke
    rng = np.random.default_rng(1)
    prompt = rng.integers(0, cfg.vocab, size=(2, 11)).astype(np.int32)
    jcache = JT.init_cache(jcfg, 2, 32)
    tcache = T.init_cache(cfg, 2, 32, device="cpu")
    jlog, jcache = JT.prefill(jcfg, jparams, {"tokens": jnp.asarray(prompt)}, jcache)
    tlog, tcache = T.prefill(cfg, params, {"tokens": torch.from_numpy(prompt)}, tcache)
    close(tlog, jlog)
    for step in range(5):
        nxt = rng.integers(0, cfg.vocab, size=(2,)).astype(np.int32)
        jlog, jcache = JT.decode_step(jcfg, jparams, jcache, jnp.asarray(nxt))
        tlog, tcache = T.decode_step(cfg, params, tcache, torch.from_numpy(nxt))
        close(tlog, jlog)
    np.testing.assert_array_equal(tcache["length"].numpy(), np.asarray(jcache["length"]))
    close(tcache["k"], jcache["k"])
    close(tcache["v"], jcache["v"])


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------


def _pair(rng, shape):
    x = rng.standard_normal(shape).astype(np.float32)
    return jnp.asarray(x), torch.from_numpy(x)


@pytest.mark.parametrize("opts", [
    dict(), dict(window=5), dict(prefix_len=4), dict(prefix_len="per_batch"),
    dict(causal=False), dict(q_offset=3),
])
def test_flash_attention_forward_matches_reference(opts):
    rng = np.random.default_rng(2)
    jq, tq = _pair(rng, (2, 12, 4, 16))
    jk, tk = _pair(rng, (2, 12 + opts.get("q_offset", 0), 2, 16))
    jv, tv = _pair(rng, tk.shape)
    jo, to = dict(opts), dict(opts)
    if opts.get("prefix_len") == "per_batch":
        jo["prefix_len"], to["prefix_len"] = jnp.array([3, 7]), torch.tensor([3, 7])
    close(L.flash_attention(tq, tk, tv, **to), JL.flash_attention(jq, jk, jv, **jo))


@pytest.mark.parametrize("window", [None, 4])
def test_decode_attention_dense_matches_reference(window):
    rng = np.random.default_rng(3)
    jq, tq = _pair(rng, (3, 1, 6, 16))
    jk, tk = _pair(rng, (3, 10, 2, 16))
    jv, tv = _pair(rng, (3, 10, 2, 16))
    lens = np.array([1, 6, 10], np.int32)
    close(L.decode_attention_dense(tq, tk, tv, torch.from_numpy(lens), window=window),
          JL.decode_attention_dense(jq, jk, jv, jnp.asarray(lens), window=window))


def test_norms_rope_mlp_and_xent_match_reference():
    rng = np.random.default_rng(4)
    jx, tx = _pair(rng, (2, 5, 3, 8))
    js, ts = _pair(rng, (8,))
    jb, tb = _pair(rng, (8,))
    close(L.rmsnorm(tx, ts), JL.rmsnorm(jx, js))
    close(L.layernorm(tx, ts, tb), JL.layernorm(jx, js, jb))
    pos = np.array([[0, 1, 2, 7, 9], [3, 4, 5, 6, 100]], np.int32)
    close(L.apply_rope(tx, torch.from_numpy(pos)), JL.apply_rope(jx, jnp.asarray(pos)))
    jh, th = _pair(rng, (2, 5, 8))
    mlp = {k: _pair(rng, s) for k, s in (("wi", (8, 12)), ("wg", (8, 12)), ("wo", (12, 8)))}
    for act in L.ACTIVATIONS:
        for gated in (False, True):
            close(L.mlp_apply({k: v[1] for k, v in mlp.items()}, th, act, gated),
                  JL.mlp_apply({k: v[0] for k, v in mlp.items()}, jh, act, gated))
    jl, tl = _pair(rng, (2, 5, 11))
    tgt = rng.integers(0, 11, size=(2, 5)).astype(np.int32)
    close(L.softmax_xent(tl, torch.from_numpy(tgt)), JL.softmax_xent(jl, jnp.asarray(tgt)))


def test_bf16_decode_attention_dense_matches_reference():
    """The serving path's working type: bf16 inputs, f32 softmax."""
    rng = np.random.default_rng(5)
    arrs = [rng.standard_normal(s).astype(np.float32)
            for s in ((2, 1, 9, 64), (2, 20, 3, 64), (2, 20, 3, 64))]
    lens = np.array([7, 20], np.int32)
    j = JL.decode_attention_dense(*[jnp.asarray(a).astype(jnp.bfloat16) for a in arrs],
                                  jnp.asarray(lens))
    t = L.decode_attention_dense(*[torch.from_numpy(a).to(torch.bfloat16) for a in arrs],
                                 torch.from_numpy(lens))
    assert t.dtype == torch.bfloat16
    close(t, j.astype(jnp.float32), rtol=2e-2, atol=2e-2)

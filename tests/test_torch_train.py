"""Port parity: the training path against the JAX package.

Data, flash attention's forward and backward, AdamW, model gradients (with
and without recomputation), the train step's loss curve, host offload and
the launcher, at the smoke size on numpy inputs from fixed seeds. Weights
reach the port from the JAX init through ``params_from_jax_numpy``. Each
tolerance is written beside its test. In float32 differences come from
summation order only; the bfloat16 tests (smollm-135m's full config trains
in bf16) allow for the two packages rounding at different points: XLA
keeps excess precision inside fused bf16 ops and rounds inside ``silu``
where PyTorch rounds once.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch
from repro.core.arena import Arena as JArena, ArenaConfig as JArenaConfig
from repro.core.offload import OffloadManager as JOffloadManager
from repro.data.pipeline import DataConfig as JDataConfig, SyntheticTokens as JSyntheticTokens
from repro.models import layers as JL
from repro.models import transformer as JT
from repro.train import optimizer as jopt
from repro.train.step import init_state as jinit_state, make_train_step as jmake_train_step
from repro_torch.configs import get_arch
from repro_torch.core.arena import Arena, ArenaConfig
from repro_torch.core.offload import OffloadManager
from repro_torch.data.pipeline import DataConfig, SyntheticTokens
from repro_torch.launch import train
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.train import optimizer as opt
from repro_torch.train.step import TrainState, make_train_step
from repro_torch.tree import leaves, tree_map

CPU = "cpu"


def np32(x):
    return np.asarray(x, np.float32)


def to_torch_tree(tree):
    return jax.tree.map(lambda x: torch.from_numpy(np.array(x, np.float32)), tree)


def assert_tree_close(port, ref, **tol):
    """Port tree (torch) against reference tree (jax), leaf for leaf in
    JAX's order."""
    ref_leaves = jax.tree.leaves(ref)
    port_leaves = leaves(port)
    assert len(port_leaves) == len(ref_leaves)
    for p, r in zip(port_leaves, ref_leaves):
        np.testing.assert_allclose(p.float().numpy(), np32(r), **tol)


@pytest.fixture(scope="module")
def smoke():
    jcfg = jget_arch("smollm-135m").smoke
    cfg = get_arch("smollm-135m").smoke
    jparams = JT.init_params(jcfg, jax.random.PRNGKey(0))
    params = T.params_from_jax_numpy(cfg, jax.tree.map(np.asarray, jparams), device=CPU)
    return jcfg, jparams, cfg, params


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed,step,host_id,n_hosts,buckets", [
    (0, 0, 0, 1, (1.0,)), (3, 5, 0, 2, (1.0,)), (3, 5, 1, 2, (1.0,)),
    (7, 11, 3, 4, (1.0, 0.5)), (7, 12, 2, 4, (1.0, 0.5)), (1, 2, 0, 1, (0.5, 0.25, 1.0)),
])
def test_batches_bit_identical_to_reference(seed, step, host_id, n_hosts, buckets):
    kw = dict(vocab=1000, seq_len=64, global_batch=8, seed=seed, buckets=buckets)
    want = np.asarray(JSyntheticTokens(JDataConfig(**kw)).batch_at(step, host_id, n_hosts)
                      ["tokens"])
    got = SyntheticTokens(DataConfig(**kw), device=CPU).batch_at(step, host_id, n_hosts)
    assert got["tokens"].dtype == torch.int32
    np.testing.assert_array_equal(got["tokens"].numpy(), want)


def test_length_buckets_cycle_and_restart_replays():
    d = SyntheticTokens(DataConfig(vocab=10, seq_len=64, global_batch=2,
                                   buckets=(1.0, 0.5)), device=CPU)
    assert [d.batch_at(s)["tokens"].shape[1] for s in range(4)] == [64, 32, 64, 32]
    assert torch.equal(d.batch_at(5)["tokens"], d.batch_at(5)["tokens"])
    assert torch.equal(next(iter(d))["tokens"], d.batch_at(0)["tokens"])
    with pytest.raises(ValueError, match="split"):
        d.batch_at(0, host_id=0, n_hosts=3)


# ---------------------------------------------------------------------------
# flash attention: forward and backward against jax.grad
# ---------------------------------------------------------------------------

#: (B, Sq, Skv, H, KVH, D, options); kv_block 8 gives several q and kv tiles
FLASH_CASES = {
    "gqa_causal": (2, 32, 32, 4, 2, 16, dict(kv_block=8)),
    "mha_causal": (1, 24, 24, 3, 3, 8, dict(kv_block=8)),
    "window": (2, 32, 32, 4, 1, 16, dict(kv_block=8, window=5)),
    "int_prefix": (2, 32, 32, 4, 2, 16, dict(kv_block=8, prefix_len=11)),
    "tensor_prefix": (2, 32, 32, 4, 2, 16, dict(kv_block=8, prefix_len="per_batch")),
    "q_offset": (2, 16, 24, 4, 2, 16, dict(kv_block=8, q_offset=8)),
    "bidirectional": (2, 16, 16, 2, 1, 16, dict(kv_block=8, causal=False)),
    "longer_than_kv_block": (1, 1024, 1024, 2, 1, 16, dict()),  # default kv_block 512
}


@pytest.mark.parametrize("case", sorted(FLASH_CASES))
def test_flash_attention_forward_and_grads_match_reference(case):
    """Within 1e-5 (f32) of the reference for o, dq, dk and dv; the tensor
    prefix gets no gradient."""
    b, sq, skv, h, kvh, d, opts = FLASH_CASES[case]
    rng = np.random.default_rng(sorted(FLASH_CASES).index(case))
    q, k, v = (rng.standard_normal(s).astype(np.float32)
               for s in ((b, sq, h, d), (b, skv, kvh, d), (b, skv, kvh, d)))
    cot = rng.standard_normal((b, sq, h, d)).astype(np.float32)
    jopts, topts = dict(opts), dict(opts)
    if opts.get("prefix_len") == "per_batch":
        pl = np.array([5, 19][:b], np.int32)
        jopts["prefix_len"], topts["prefix_len"] = jnp.asarray(pl), torch.from_numpy(pl)

    def jloss(q, k, v):
        o = JL.flash_attention(q, k, v, **jopts)
        return jnp.sum(o * cot), o

    (_, jo), jgrads = jax.value_and_grad(jloss, argnums=(0, 1, 2), has_aux=True)(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_(True) for x in (q, k, v))
    to = L.flash_attention(tq, tk, tv, **topts)
    tgrads = torch.autograd.grad((to * torch.from_numpy(cot)).sum(), (tq, tk, tv))
    tol = dict(rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(to.detach().numpy(), np32(jo), **tol)
    for name, got, want in zip("qkv", tgrads, jgrads):
        np.testing.assert_allclose(got.numpy(), np32(want), err_msg=f"d{name}", **tol)


def assert_bf16_close(got, want, what):
    """bf16 outputs of the same algorithm: none off by more than one bf16
    rounding (2^-8) of the output's largest value, and at most 1 % of the
    elements differ at all (dropping the cast of p to bf16 before P.V
    changes a fifth of them)."""
    assert got.dtype == torch.bfloat16, what
    g, w = got.detach().float().numpy(), np32(want)
    assert np.abs(g - w).max() <= 2.0**-8 * np.abs(w).max(), what
    assert np.mean(g != w) <= 0.01, (what, np.mean(g != w))


@pytest.mark.parametrize("case", ["gqa_causal", "window", "int_prefix", "q_offset"])
def test_flash_attention_bf16_forward_and_grads_match_reference(case):
    """bf16 q, k, v, as the full config trains: o, dq, dk and dv against
    ``jax.grad`` of the reference in bf16 (``assert_bf16_close``)."""
    b, sq, skv, h, kvh, d, opts = FLASH_CASES[case]
    rng = np.random.default_rng(100 + sorted(FLASH_CASES).index(case))
    q, k, v = (jnp.asarray(rng.standard_normal(s), jnp.bfloat16)
               for s in ((b, sq, h, d), (b, skv, kvh, d), (b, skv, kvh, d)))
    cot = rng.standard_normal((b, sq, h, d)).astype(np.float32)

    def jloss(q, k, v):
        o = JL.flash_attention(q, k, v, **opts)
        return jnp.sum(o.astype(jnp.float32) * cot), o

    (_, jo), jgrads = jax.value_and_grad(jloss, argnums=(0, 1, 2), has_aux=True)(q, k, v)
    tq, tk, tv = (torch.from_numpy(np32(x)).to(torch.bfloat16).requires_grad_(True)
                  for x in (q, k, v))
    to = L.flash_attention(tq, tk, tv, **opts)
    tgrads = torch.autograd.grad((to.float() * torch.from_numpy(cot)).sum(), (tq, tk, tv))
    assert_bf16_close(to, jo, "o")
    for name, got, want in zip("qkv", tgrads, jgrads):
        assert_bf16_close(got, want, f"d{name}")


def test_flash_attention_saves_only_its_residuals():
    """The backward keeps q, the expanded k and v, o, m and l: no (Sq, Skv)
    tensor is saved for the backward pass."""
    rng = np.random.default_rng(9)
    q = torch.from_numpy(rng.standard_normal((1, 64, 4, 8)).astype(np.float32))
    k = torch.from_numpy(rng.standard_normal((1, 64, 2, 8)).astype(np.float32))
    q.requires_grad_(True)
    k.requires_grad_(True)
    shapes = []
    with torch.autograd.graph.saved_tensors_hooks(lambda t: shapes.append(tuple(t.shape)) or t,
                                                  lambda t: t):
        L.flash_attention(q, k, k, kv_block=16)
    assert sorted(shapes) == sorted([(1, 64, 4, 8)] * 4 + [(1, 4, 64)] * 2)


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("moment_dtype", ["float32", "bfloat16"])
def test_adamw_apply_matches_reference(moment_dtype):
    """Three steps of ``apply`` fed the same numpy grads as the reference's
    ``opt.apply`` (one of them clipped): params and f32 moments within
    1e-6; bf16 moments within one bf16 rounding (rtol 1e-2)."""
    rng = np.random.default_rng(0)
    shapes = {"a": (7, 5), "b": {"c": (3,), "d": (2, 4, 3)}}
    params = jax.tree.map(lambda s: rng.standard_normal(s).astype(np.float32), shapes,
                          is_leaf=lambda x: isinstance(x, tuple))
    jcfg = jopt.AdamWConfig(lr=1e-2, moment_dtype=getattr(jnp, moment_dtype))
    cfg = opt.AdamWConfig(lr=1e-2, moment_dtype=getattr(torch, moment_dtype))
    jp, jstate = jax.tree.map(jnp.asarray, params), None
    tp = to_torch_tree(params)
    jstate, tstate = jopt.init(jcfg, jp), opt.init(cfg, tp)
    for step, gscale in enumerate((0.1, 3.0, 0.5)):
        grads = jax.tree.map(lambda p: (gscale * rng.standard_normal(p.shape))
                             .astype(np.float32), params)
        jp, jstate, jm = jopt.apply(jcfg, jp, jax.tree.map(jnp.asarray, grads), jstate)
        tp, tstate, tm = opt.apply(cfg, tp, to_torch_tree(grads), tstate)
        np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]), rtol=1e-6)
        assert int(tstate.count) == int(jstate.count) == step + 1
        assert_tree_close(tp, jp, rtol=1e-6, atol=1e-6)
        mtol = dict(rtol=1e-6, atol=1e-7) if moment_dtype == "float32" else dict(rtol=1e-2)
        assert_tree_close(tstate.mu, jstate.mu, **mtol)
        assert_tree_close(tstate.nu, jstate.nu, **mtol)
        assert all(m.dtype == cfg.moment_dtype for m in leaves(tstate.mu))


def test_adamw_updates_in_place_and_keeps_leaf_dtypes():
    """The step reuses the state's buffers, as the reference's donated step
    does: the returned params and moments are the tensors passed in,
    updated, in their own dtypes; ``count`` is a new tensor."""
    p = {"w": torch.ones(4, dtype=torch.bfloat16)}
    g = {"w": torch.full((4,), 0.5, dtype=torch.bfloat16)}
    cfg = opt.AdamWConfig(lr=0.1)  # a step bf16 can see at 1.0
    state = opt.init(cfg, p)
    w, mu, nu = p["w"], state.mu["w"], state.nu["w"]
    new_p, new_state, _ = opt.apply(cfg, p, g, state)
    assert new_p["w"] is w and new_state.mu["w"] is mu and new_state.nu["w"] is nu
    assert w.dtype == torch.bfloat16 and mu.dtype == torch.float32
    assert not torch.equal(w, torch.ones(4, dtype=torch.bfloat16)) and bool((mu > 0).all())
    assert int(state.count) == 0 and int(new_state.count) == 1


# ---------------------------------------------------------------------------
# model gradients, with and without recomputation
# ---------------------------------------------------------------------------


def _batch(cfg, b=2, s=24, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab, size=(b, s)).astype(np.int32)


def _grads(cfg, params, tokens):
    """Loss and every leaf's gradient, in JAX's leaf order."""
    ps = tree_map(lambda t: t.detach().requires_grad_(True), params)
    loss = T.loss_fn(cfg, ps, {"tokens": torch.from_numpy(tokens)})
    return loss, torch.autograd.grad(loss, leaves(ps))


@pytest.mark.parametrize("remat", [False, True])
def test_loss_gradients_match_jax_grad(smoke, remat):
    """Every leaf's gradient within 1e-4 of ``jax.grad`` of the reference
    loss (f32, summation order only), remat on or off on either side."""
    jcfg, jparams, cfg, params = smoke
    jcfg, cfg = dataclasses.replace(jcfg, remat=remat), dataclasses.replace(cfg, remat=remat)
    tokens = _batch(cfg)
    jloss, jgrads = jax.value_and_grad(lambda p: JT.loss_fn(jcfg, p, {"tokens": tokens}))(
        jparams)
    loss, grads = _grads(cfg, params, tokens)
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
    for got, want in zip(grads, jax.tree.leaves(jgrads), strict=True):
        np.testing.assert_allclose(got.numpy(), np32(want), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("remat", [False, True])
def test_bf16_loss_gradients_match_jax_grad(smoke, remat):
    """The smoke config in bf16, as the full config trains: loss within one
    bf16 rounding (rtol 2^-8) of the reference's, and each leaf's gradient
    within 4e-2 of ``jax.grad``'s in relative Frobenius norm (rounding at
    different points through 3 layers forward and back; measured up to
    2.2 %)."""
    jcfg, jparams, cfg, _ = smoke
    jcfg = dataclasses.replace(jcfg, dtype=jnp.bfloat16, remat=remat)
    cfg = dataclasses.replace(cfg, dtype=torch.bfloat16, remat=remat)
    jparams = jax.tree.map(lambda x: x.astype(jnp.bfloat16), jparams)
    params = T.params_from_jax_numpy(cfg, jax.tree.map(np.asarray, jparams), device=CPU)
    tokens = _batch(cfg)
    jloss, jgrads = jax.value_and_grad(lambda p: JT.loss_fn(jcfg, p, {"tokens": tokens}))(
        jparams)
    loss, grads = _grads(cfg, params, tokens)
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=2.0**-8)
    for got, want in zip(grads, jax.tree.leaves(jgrads), strict=True):
        assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
        g, w = got.float().numpy(), np32(want)
        assert np.linalg.norm(g - w) <= 4e-2 * np.linalg.norm(w), (w.shape,
                                                                   np.linalg.norm(g - w))


def test_remat_gives_the_same_gradients_and_reaches_stacked_leaves(smoke):
    """Recomputing each layer under torch.utils.checkpoint gives the
    gradients of the plain backward (the same CPU ops, so bit for bit), and
    every layer's slice of each stacked leaf gets its gradient."""
    _, _, cfg, params = smoke
    tokens = _batch(cfg, seed=1)
    _, plain = _grads(dataclasses.replace(cfg, remat=False), params, tokens)
    _, remat = _grads(dataclasses.replace(cfg, remat=True), params, tokens)
    for a, b in zip(plain, remat, strict=True):
        assert torch.equal(a, b)
    for g in remat:
        if g.dim() == 3:  # stacked (n_layers, ., .) leaves
            assert all(bool(g[i].abs().sum() > 0) for i in range(cfg.n_layers))


def test_serving_never_takes_the_remat_wrapper(smoke, monkeypatch):
    """prefill and decode_step run without gradients, so a remat config
    serves without going through torch.utils.checkpoint."""
    _, _, cfg, params = smoke
    cfg = dataclasses.replace(cfg, remat=True)
    calls, real = [], T.checkpoint
    monkeypatch.setattr(T, "checkpoint", lambda *a, **k: calls.append(1) or real(*a, **k))
    cache = T.init_cache(cfg, 2, 16, device=CPU)
    logits, cache = T.prefill(cfg, params, {"tokens": torch.from_numpy(_batch(cfg, s=5))},
                              cache)
    T.decode_step(cfg, params, cache, torch.tensor([1, 2], dtype=torch.int32))
    assert calls == [] and not logits.requires_grad
    T.loss_fn(cfg, params, {"tokens": torch.from_numpy(_batch(cfg))})  # training does
    assert len(calls) == cfg.n_layers


# ---------------------------------------------------------------------------
# train step: a 10-step loss curve
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("microbatches", [1, 2])
def test_train_step_loss_curve_matches_reference(smoke, microbatches):
    """Ten steps from the same weights on the same batches: each loss within
    rtol 1e-4 of the unsharded, jitted reference step (AdamW's first step
    is a sign function, so near-zero gradients may move a few weights
    differently; the curve is held, not the weights)."""
    jcfg, _, cfg, _ = smoke
    jadamw, adamw = jopt.AdamWConfig(lr=1e-3), opt.AdamWConfig(lr=1e-3)
    jstate = jinit_state(jcfg, jadamw, jax.random.PRNGKey(1))
    params = T.params_from_jax_numpy(cfg, jax.tree.map(np.asarray, jstate.params), device=CPU)
    state = TrainState(params, opt.init(adamw, params), torch.zeros((), dtype=torch.int32))
    jstep = jax.jit(jmake_train_step(jcfg, jadamw, microbatches=microbatches))
    step = make_train_step(cfg, adamw, microbatches=microbatches)
    kw = dict(vocab=cfg.vocab, seq_len=32, global_batch=4, seed=0)
    jdata, data = JSyntheticTokens(JDataConfig(**kw)), SyntheticTokens(DataConfig(**kw), CPU)
    jl, tl = [], []
    for i in range(10):
        jstate, jm = jstep(jstate, jdata.batch_at(i))
        state, m = step(state, data.batch_at(i))
        jl.append(float(jm["loss"]))
        tl.append(float(m["loss"]))
    np.testing.assert_allclose(tl, jl, rtol=1e-4)
    assert int(state.step) == 10


def test_train_step_bf16_loss_curve_matches_reference(smoke):
    """The full config's working types at the smoke size (bf16 params and
    activations, f32 moments, remat on): six steps from the same weights on
    the same batches, each loss within one bf16 rounding (rtol 2^-8) of the
    jitted reference step's; the params stay bf16 and the moments f32."""
    jcfg, _, cfg, _ = smoke
    jcfg = dataclasses.replace(jcfg, dtype=jnp.bfloat16, remat=True)
    cfg = dataclasses.replace(cfg, dtype=torch.bfloat16, remat=True)
    jadamw, adamw = jopt.AdamWConfig(lr=1e-3), opt.AdamWConfig(lr=1e-3)
    jstate = jinit_state(jcfg, jadamw, jax.random.PRNGKey(1))
    params = T.params_from_jax_numpy(cfg, jax.tree.map(np.asarray, jstate.params), device=CPU)
    state = TrainState(params, opt.init(adamw, params), torch.zeros((), dtype=torch.int32))
    jstep = jax.jit(jmake_train_step(jcfg, jadamw))
    step = make_train_step(cfg, adamw)
    kw = dict(vocab=cfg.vocab, seq_len=32, global_batch=4, seed=0)
    jdata, data = JSyntheticTokens(JDataConfig(**kw)), SyntheticTokens(DataConfig(**kw), CPU)
    jl, tl = [], []
    for i in range(6):
        jstate, jm = jstep(jstate, jdata.batch_at(i))
        state, m = step(state, data.batch_at(i))
        jl.append(float(jm["loss"]))
        tl.append(float(m["loss"]))
    np.testing.assert_allclose(tl, jl, rtol=2.0**-8)
    assert all(p.dtype == torch.bfloat16 for p in leaves(state.params))
    assert all(m.dtype == torch.float32 for m in leaves(state.opt.mu))


# ---------------------------------------------------------------------------
# host offload
# ---------------------------------------------------------------------------


def test_offload_roundtrip_matches_reference():
    """put / spill / get / put-replace / drop on the same data in both
    packages: same values back, same allocator stats after every call."""
    rng = np.random.default_rng(0)
    arrays = {"opt.m": rng.standard_normal((100, 300)).astype(np.float32),
              "opt.v": rng.standard_normal((700, 1000)).astype(np.float32),
              "act": rng.standard_normal((3, 5)).astype(np.float32)}
    jarena = JArena(JArenaConfig(n_chunks=16, dtype=jnp.float32, use_reference_ops=True))
    arena = Arena(ArenaConfig(n_chunks=16, dtype=torch.float32, device=CPU))
    jom, om = JOffloadManager(jarena), OffloadManager(arena)

    def same_stats():
        a, b = jarena.allocator, arena.allocator
        assert (b.stats.active_bytes, b.stats.reserved_bytes, b.stats.n_alloc, b.stats.n_free) \
            == (a.stats.active_bytes, a.stats.reserved_bytes, a.stats.n_alloc, a.stats.n_free)
        assert b.state_counts == a.state_counts

    script = [("put", "opt.m"), ("put", "opt.v"), ("spill", "opt.m"), ("put", "act"),
              ("get", "opt.m"), ("spill", "opt.v"), ("put", "act"), ("get", "opt.v"),
              ("drop", "opt.m"), ("drop", "opt.v"), ("drop", "act")]
    for op, name in script:
        if op == "put":
            jom.put(name, jnp.asarray(arrays[name]))
            om.put(name, torch.from_numpy(arrays[name]))
        elif op == "get":
            want = np.asarray(jom.get(name))
            got = om.get(name)
            np.testing.assert_array_equal(got.numpy(), want)
            np.testing.assert_array_equal(want, arrays[name])
        else:
            getattr(jom, op)(name)
            getattr(om, op)(name)
        assert om.names() == jom.names()
        assert {n: om.is_resident(n) for n in om.names()} == \
            {n: jom.is_resident(n) for n in jom.names()}
        same_stats()
    assert arena.active_bytes == 0


def test_offload_keeps_bf16_on_the_host():
    arena = Arena(ArenaConfig(n_chunks=4, dtype=torch.float32, device=CPU))
    om = OffloadManager(arena)
    x = torch.randn(64, 33, generator=torch.Generator().manual_seed(0)).to(torch.bfloat16)
    om.put("x", x)
    om.spill("x")
    assert om._host["x"].dtype == torch.bfloat16 and om._host["x"].device.type == "cpu"
    assert torch.equal(om.get("x"), x) and om.is_resident("x")


# ---------------------------------------------------------------------------
# launcher
# ---------------------------------------------------------------------------


def test_launcher_smoke_loss_decreases(tmp_path):
    """The port's counterpart of the reference's end-to-end training test."""
    out = train.main(["--arch", "smollm-135m", "--smoke", "--steps", "40", "--batch", "4",
                      "--seq", "64", "--device", "cpu", "--ckpt-dir", str(tmp_path)])
    # stragglers are only logged (the wall clock of a loaded host); no restart
    assert out["steps"] == 40 and [e for e in out["events"] if e["kind"] != "straggler"] == []
    assert out["last_loss"] < out["first_loss"]
    assert [h["step"] for h in out["history"]] == list(range(40))
    assert "peak_allocated_bytes" not in out  # device memory only on the card


def test_launcher_rejects_model_parallelism(tmp_path):
    """``--model-parallel 2`` is no longer rejected: on one rank the launcher
    clamps the model axis, as the reference's mesh does, and trains on the
    (1, 1) mesh of a one-rank gloo group (its losses equal the plain
    step's)."""
    argv = ["--arch", "smollm-135m", "--smoke", "--device", "cpu", "--steps", "3",
            "--ckpt-dir", str(tmp_path / "a")]
    plain = train.main(argv)
    out = train.main(argv[:-1] + [str(tmp_path / "b"), "--model-parallel", "2"])
    assert out["mesh"] == {"shape": [1, 1], "names": ["data", "model"]}
    assert out["world"] == 1 and out["backend"] == "gloo"
    np.testing.assert_allclose(out["last_loss"], plain["last_loss"], rtol=1e-6)

"""Port parity: the MoE layer and model against the JAX package.

Weights come from the JAX init and reach the port through
``moe.params_from_jax_numpy`` (router kept in float32); inputs come from a
numpy seed. In float32 the two must route identically (top-k experts and
the set of slots dropped past capacity) and agree within 1e-5 on the layer
output, 1e-6 on the aux loss and 1e-4 on the model's loss and gradients
(summation order differs, nothing else). In bf16, the full configs' working
type, the loss must agree within one bf16 rounding (rtol 2^-8), one MoE
layer's gradients within the dense model's bf16 bound, and the whole
model's gradients within bounds set from readings over several token draws."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch
from repro.models import moe as JM
from repro_torch.configs import get_arch
from repro_torch.models import moe as M
from repro_torch.tree import flatten_with_path, leaves, unflatten_like

ARCHS = ["dbrx-132b", "grok-1-314b"]
#: each arch's smoke config as it stands, with capacity 0.5 (slots drop),
#: and with virtual experts (grok's full config splits each expert in two)
VARIANTS = {"smoke": {}, "cf0.5": {"capacity_factor": 0.5}, "shards2": {"expert_shards": 2}}


def configs(arch, **over):
    return (dataclasses.replace(jget_arch(arch).smoke, **over),
            dataclasses.replace(get_arch(arch).smoke, **over))


def converted(jcfg, cfg, seed=0):
    jparams = JM.init_params(jcfg, jax.random.PRNGKey(seed))
    return jparams, M.params_from_jax_numpy(cfg, jax.tree.map(np.asarray, jparams),
                                            device="cpu")


def jax_routing(jcfg, router, xf):
    """The reference's routing, as its ``moe_apply`` computes it: the top-k
    experts, the capacity and which sorted slots fit it."""
    probs = jax.nn.softmax(jnp.einsum("td,de->te", xf.astype(jnp.float32), router), axis=-1)
    _, topi = jax.lax.top_k(probs, jcfg.top_k)
    n_tok = xf.shape[0]
    capacity = max(int(jcfg.capacity_factor * n_tok * jcfg.top_k / jcfg.n_experts),
                   min(n_tok, 16))
    flat_e = topi.reshape(-1)
    order = jnp.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    rank = jnp.arange(flat_e.shape[0]) - jnp.searchsorted(sorted_e, sorted_e, side="left")
    return np.asarray(topi), np.asarray(order), np.asarray(rank < capacity), capacity


def layer0(tree):
    return {k: v[0] for k, v in tree["layers"]["mlp"].items()}


def check_layer(jcfg, cfg, jparams, params, x):
    """moe_apply on layer 0 of both packages: routing equal, output within
    1e-5, aux within 1e-6. Returns the number of dropped slots."""
    jp = jax.tree.map(lambda a: a[0], jparams["layers"]["mlp"])
    p = layer0(params)
    jout, jaux = JM.moe_apply(jcfg, jp, jnp.asarray(x), JM._id_sharder)
    out, aux = M.moe_apply(cfg, p, torch.from_numpy(x))
    r = M.route(cfg, p["router"], torch.from_numpy(x).reshape(-1, cfg.d_model))
    topi, order, kept, capacity = jax_routing(jcfg, jp["router"],
                                              jnp.asarray(x).reshape(-1, cfg.d_model))
    assert r.capacity == capacity
    np.testing.assert_array_equal(r.topi.numpy(), topi)
    np.testing.assert_array_equal(r.order.numpy(), order)
    np.testing.assert_array_equal(r.kept.numpy(), kept)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-6, atol=1e-6)
    return int((~kept).sum())


@pytest.mark.parametrize("variant", list(VARIANTS))
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_apply_matches_reference(arch, variant):
    jcfg, cfg = configs(arch, **VARIANTS[variant])
    jparams, params = converted(jcfg, cfg)
    x = np.random.default_rng(0).standard_normal((2, 24, cfg.d_model)).astype(np.float32)
    dropped = check_layer(jcfg, cfg, jparams, params, x)
    if variant == "cf0.5":
        assert dropped >= 1
    else:
        assert dropped == 0  # the smoke configs' capacity factor 2 keeps every slot


@pytest.mark.parametrize("n_tok,drops", [(8, False), (63, True)])
def test_full_routing_shape_decode_and_prefill(n_tok, drops):
    """dbrx's full routing (16 experts, top 4, capacity factor 1.25) at the
    smoke width, on the engine's two batch shapes: decode (max_batch 8, the
    capacity floor keeps every slot) and a one-request prefill of 63 tokens
    (capacity 19 against a mean load of 15.75: random routing drops)."""
    over = dict(n_experts=16, top_k=4, capacity_factor=1.25)
    jcfg, cfg = configs("dbrx-132b", **over)
    jparams, params = converted(jcfg, cfg, seed=1)
    x = np.random.default_rng(n_tok).standard_normal((1, n_tok, cfg.d_model)).astype(np.float32)
    dropped = check_layer(jcfg, cfg, jparams, params, x)
    assert (dropped > 0) == drops


def test_top_k_breaks_ties_toward_the_lower_index():
    probs = np.array([[0.1, 0.3, 0.3, 0.3], [0.25, 0.25, 0.25, 0.25], [0.4, 0.1, 0.4, 0.1]],
                     np.float32)
    for k in (1, 2, 3):
        v, i = M.top_k(torch.from_numpy(probs), k)
        jv, ji = jax.lax.top_k(jnp.asarray(probs), k)
        np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(v.numpy(), np.asarray(jv))


def test_virtual_experts_equivalence():
    """The reference's ``test_moe_virtual_experts_equivalence`` on the port:
    expert_shards=2 with re-laid-out weights == expert_shards=1."""
    def mk(es):
        return M.MoEConfig(name="t", n_layers=2, d_model=64, n_heads=4, n_kv=2, d_ff=96,
                           vocab=211, n_experts=4, top_k=2, capacity_factor=8.0,
                           dtype=torch.float32, gated=True, act="silu", remat=False,
                           expert_shards=es)
    p1 = M.init_params(mk(1), torch.Generator().manual_seed(1), device="cpu")
    p2 = {**p1, "layers": {**p1["layers"], "mlp": dict(p1["layers"]["mlp"])}}
    for k in ("wi", "wg"):
        w = p1["layers"]["mlp"][k]
        n, e, d, f = w.shape
        p2["layers"]["mlp"][k] = (w.reshape(n, e, d, 2, f // 2).permute(0, 1, 3, 2, 4)
                                  .reshape(n, e * 2, d, f // 2))
    wo = p1["layers"]["mlp"]["wo"]
    n, e, f, d = wo.shape
    p2["layers"]["mlp"]["wo"] = wo.reshape(n, e * 2, f // 2, d)
    toks = torch.from_numpy(np.random.default_rng(1).integers(0, 211, (2, 32)).astype(np.int32))
    l1 = M.loss_fn(mk(1), p1, {"tokens": toks})
    l2 = M.loss_fn(mk(2), p2, {"tokens": toks})
    np.testing.assert_allclose(float(l1), float(l2), rtol=1e-5)


def _loss_and_grads(cfg, params, tokens):
    """The loss and each leaf's gradient, keyed by its ``keystr`` path."""
    xs = [t.detach().requires_grad_(True) for t in leaves(params)]
    loss = M.loss_fn(cfg, unflatten_like(params, xs), {"tokens": torch.from_numpy(tokens)})
    grads = torch.autograd.grad(loss, xs)
    return float(loss.detach()), {p: g for (p, _), g in zip(flatten_with_path(params), grads)}


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_gradients_match_jax_grad_f32(arch):
    jcfg, cfg = configs(arch, capacity_factor=1.0)  # some slots drop
    jparams, params = converted(jcfg, cfg)
    tokens = np.random.default_rng(2).integers(0, cfg.vocab, (2, 24)).astype(np.int32)
    jloss, jgrads = jax.value_and_grad(lambda p: JM.loss_fn(jcfg, p, {"tokens": tokens}))(
        jparams)
    loss, grads = _loss_and_grads(cfg, params, tokens)
    np.testing.assert_allclose(loss, float(jloss), rtol=1e-4)
    for path, jg in jax.tree_util.tree_flatten_with_path(jgrads)[0]:
        key = "".join(f"[{p.key!r}]" for p in path)
        np.testing.assert_allclose(grads[key].numpy(), np.asarray(jg), rtol=1e-4, atol=1e-4,
                                   err_msg=key)


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_layer_gradients_match_reference_bf16(arch):
    """bf16 weights and activations with the float32 router, as the full
    configs run. The model's loss within one bf16 rounding (rtol 2^-8) of
    the reference's. Gradients through one MoE layer (capacity 1.0, so slots
    drop; routing equal, checked) within 4e-2 of ``jax.grad``'s in relative
    Frobenius norm, the dense model's bf16 bound (tests/test_torch_train.py;
    measured here up to 1.6 %). The whole model's gradients are held over
    several token draws in ``test_model_gradients_match_jax_grad_bf16``."""
    jcfg, cfg = configs(arch, dtype=jnp.bfloat16, capacity_factor=1.0)
    cfg = dataclasses.replace(cfg, dtype=torch.bfloat16)
    jparams, params = converted(jcfg, cfg)
    assert params["layers"]["mlp"]["router"].dtype == torch.float32
    assert params["layers"]["mlp"]["wi"].dtype == torch.bfloat16
    tokens = np.random.default_rng(3).integers(0, cfg.vocab, (2, 24)).astype(np.int32)
    jloss = JM.loss_fn(jcfg, jparams, {"tokens": jnp.asarray(tokens)})
    loss = M.loss_fn(cfg, params, {"tokens": torch.from_numpy(tokens)})
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=2.0**-8)

    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 24, cfg.d_model)).astype(np.float32)
    ct = rng.standard_normal(x.shape).astype(np.float32)
    jp = jax.tree.map(lambda a: a[0], jparams["layers"]["mlp"])
    jx = jnp.asarray(x).astype(jnp.bfloat16)

    def jf(p, x):
        out, aux = JM.moe_apply(jcfg, p, x, JM._id_sharder)
        return jnp.sum(out.astype(jnp.float32) * ct) + aux

    jgp, jgx = jax.grad(jf, argnums=(0, 1))(jp, jx)
    p = {k: v.detach().requires_grad_(True) for k, v in layer0(params).items()}
    tx = torch.from_numpy(x).to(torch.bfloat16).requires_grad_(True)
    out, aux = M.moe_apply(cfg, p, tx)
    (torch.sum(out.float() * torch.from_numpy(ct)) + aux).backward()
    r = M.route(cfg, p["router"], tx.detach().reshape(-1, cfg.d_model))
    topi, _, kept, _ = jax_routing(jcfg, jp["router"], jx.reshape(-1, cfg.d_model))
    np.testing.assert_array_equal(r.topi.numpy(), topi)
    np.testing.assert_array_equal(r.kept.numpy(), kept)
    assert not kept.all()
    for name, got, want in [(k, p[k].grad, jgp[k]) for k in p] + [("x", tx.grad, jgx)]:
        assert str(got.dtype).split(".")[-1] == jnp.dtype(want.dtype).name, name
        g, w = got.float().numpy(), np.asarray(want, np.float32)
        assert np.linalg.norm(g - w) <= 4e-2 * np.linalg.norm(w), (name, np.linalg.norm(g - w)
                                                                    / np.linalg.norm(w))


#: whole-model bf16 gradients, port vs ``jax.grad`` (capacity 1.0), over
#: these token seeds: each leaf's relative Frobenius gap must stay within
#: BF16_LEAF_MAX on every seed and within BF16_LEAF_MEDIAN at the median over
#: the seeds. Measured: 1.4-2.3 % on most seeds, up to 11.9 % on the router
#: (8.3 % on ln2) on grok's seed 5, where one token's bf16 activations round
#: across a routing boundary in one package and not the other
#: (``test_grok_bf16_gradient_outlier_is_one_routing_flip``).
BF16_SEEDS = range(6)
BF16_LEAF_MAX = 0.15
BF16_LEAF_MEDIAN = 0.03


@pytest.mark.parametrize("arch", ARCHS)
def test_model_gradients_match_jax_grad_bf16(arch):
    """The whole model's bf16 loss and gradients against ``jax.grad`` on
    several token draws: the loss within 2^-8 on each, every leaf within
    BF16_LEAF_MAX on each and within BF16_LEAF_MEDIAN at the median, so a
    fault in any leaf's bf16 backward shows on every draw."""
    jcfg, cfg = configs(arch, dtype=jnp.bfloat16, capacity_factor=1.0)
    cfg = dataclasses.replace(cfg, dtype=torch.bfloat16)
    jparams, params = converted(jcfg, cfg)
    jvg = jax.jit(jax.value_and_grad(lambda p, t: JM.loss_fn(jcfg, p, {"tokens": t})))
    gaps = {}
    for seed in BF16_SEEDS:
        tokens = np.random.default_rng(seed).integers(0, cfg.vocab, (2, 24)).astype(np.int32)
        jloss, jgrads = jvg(jparams, jnp.asarray(tokens))
        loss, grads = _loss_and_grads(cfg, params, tokens)
        np.testing.assert_allclose(loss, float(jloss), rtol=2.0**-8, err_msg=str(seed))
        for path, jg in jax.tree_util.tree_flatten_with_path(jgrads)[0]:
            key = "".join(f"[{p.key!r}]" for p in path)
            assert str(grads[key].dtype).split(".")[-1] == jnp.dtype(jg.dtype).name, key
            g, w = grads[key].float().numpy(), np.asarray(jg, np.float32)
            gaps.setdefault(key, []).append(np.linalg.norm(g - w) / np.linalg.norm(w))
    for key, gap in gaps.items():
        assert max(gap) <= BF16_LEAF_MAX, (key, gap)
        assert np.median(gap) <= BF16_LEAF_MEDIAN, (key, gap)


def test_grok_bf16_gradient_outlier_is_one_routing_flip(monkeypatch):
    """Grok's token seed 5 in bf16: at layer 1, token 0 (sequence 0,
    position 0) has experts 3 and 0 within 1e-3 of each other in router
    logit. Its bf16 router input differs from the reference's by about one
    bf16 rounding, so the port picks experts [1, 3] where the reference
    picks [1, 0]. That one choice is the whole outlier: forced to the
    reference's experts, the loss agrees within 1e-4 and every leaf's
    gradient within BF16_LEAF_MEDIAN."""
    jcfg, cfg = configs("grok-1-314b", dtype=jnp.bfloat16, capacity_factor=1.0)
    cfg = dataclasses.replace(cfg, dtype=torch.bfloat16)
    jparams, params = converted(jcfg, cfg)
    tokens = np.random.default_rng(5).integers(0, cfg.vocab, (2, 24)).astype(np.int32)
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p, t: JM.loss_fn(jcfg, p, {"tokens": t})))(jparams, jnp.asarray(tokens))
    top_k, seen = M.top_k, []

    def forced(probs, k):
        v, i = top_k(probs, k)
        seen.append(probs[0].clone())
        if len(seen) == 2:  # layer 1, token 0: the reference's experts
            i = i.clone()
            i[0] = torch.tensor([1, 0])
            v = torch.gather(probs, -1, i)
        return v, i

    gaps = {}
    for name, fn in (("as is", top_k), ("forced", forced)):
        monkeypatch.setattr(M, "top_k", fn)
        loss, grads = _loss_and_grads(cfg, params, tokens)
        gaps[name] = [abs(loss - float(jloss)) / float(jloss)]
        for path, jg in jax.tree_util.tree_flatten_with_path(jgrads)[0]:
            key = "".join(f"[{p.key!r}]" for p in path)
            g, w = grads[key].float().numpy(), np.asarray(jg, np.float32)
            gaps[name].append(np.linalg.norm(g - w) / np.linalg.norm(w))
    probs = seen[1]
    assert M.top_k(probs[None], 2)[1][0].tolist() == [1, 3]
    assert abs(float(torch.log(probs[3] / probs[0]))) < 1e-3  # the logit margin
    assert max(gaps["as is"][1:]) > 0.10
    assert gaps["forced"][0] < 1e-4 and max(gaps["forced"][1:]) <= BF16_LEAF_MEDIAN


def test_init_params_tree_and_determinism():
    """The port's own init gives the reference's tree (keys, shapes, the
    router in float32), and a seed gives the same weights every time."""
    for arch in ARCHS:
        jcfg, cfg = configs(arch, expert_shards=2)
        jtree = jax.eval_shape(lambda: JM.init_params(jcfg, jax.random.PRNGKey(0)))
        a = M.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
        b = M.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
        flat_a, flat_b = flatten_with_path(a), flatten_with_path(b)
        flat_j = jax.tree_util.tree_flatten_with_path(jtree)[0]
        assert [p for p, _ in flat_a] == ["".join(f"[{q.key!r}]" for q in path)
                                         for path, _ in flat_j]
        for (path, x), (_, y), (_, j) in zip(flat_a, flat_b, flat_j):
            assert tuple(x.shape) == j.shape, path
            assert str(x.dtype).split(".")[-1] == jnp.dtype(j.dtype).name, path
            assert torch.equal(x, y), path
        wi = a["layers"]["mlp"]["wi"]
        # each (layer, virtual expert) slice has its own draw
        assert not torch.equal(wi[0, 0], wi[0, 1]) and not torch.equal(wi[0, 0], wi[1, 0])
        assert abs(float(wi.std()) * cfg.d_model**0.5 - 1.0) < 0.1


def test_combine_is_deterministic_and_prefill_decode_agree():
    """The same inputs give the same bits on a second call, and decoding a
    token after a prefill gives the logits of a prefill one token longer."""
    _, cfg = configs("dbrx-132b")
    params = M.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    x = torch.from_numpy(np.random.default_rng(4).standard_normal((2, 8, cfg.d_model))
                         .astype(np.float32))
    a, _ = M.moe_apply(cfg, layer0(params), x)
    b, _ = M.moe_apply(cfg, layer0(params), x)
    assert torch.equal(a, b)
    toks = torch.from_numpy(np.random.default_rng(5).integers(0, cfg.vocab, (1, 9))
                            .astype(np.int32))
    cache = M.init_cache(cfg, 1, 16, device="cpu")
    _, cache = M.prefill(cfg, params, {"tokens": toks[:, :8]}, cache)
    step, _ = M.decode_step(cfg, params, cache, toks[:, 8])
    full, _ = M.prefill(cfg, params, {"tokens": toks}, M.init_cache(cfg, 1, 16, device="cpu"))
    np.testing.assert_allclose(step.numpy(), full[:, 0].numpy(), rtol=1e-4, atol=1e-4)

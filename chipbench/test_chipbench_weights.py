"""The weights a run draws and the float32 view a reference reads them
through: leaves drawn whole as they always were, big leaves drawn one
layer slice at a time, the view casting no more than one layer at once,
and a reference that sets aside the positions it cannot decide."""

import dataclasses
import hashlib
import json
import math
import weakref
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import smoke
from harness import compare, model, weights
from harness.kinds import closed_loop
from harness.runtime import Context
from harness.spec import Spec

HERE = Path(__file__).resolve().parent
SEED = 3_000_000_019

#: sha256 over (name, bytes) of every leaf of the smoke trees, drawn on the
#: CPU by the rule of one call a leaf, before big leaves were sliced
DIGESTS = {
    ("sc2-smoke", 0): "0afcf47261d84bceb140c44515da03521df4971b376f91abe3c805c1b1186bc2",
    ("sc2-smoke", SEED): "85f1b207b579a90a2536bf0dbb5b5082960b5e1d431f4e77adceda8a8d65f55d",
    ("whisper-smoke", 0): "7630044a34ccdb6f7ca1e9d33650fbd129cba4539b6e7aa4835501fda267d49c",
    ("whisper-smoke", SEED): "a4c703a0081af681686ae608b919f9d7f590db667b99f1085c59d3dbce19faab",
}


def smoke_shapes(name):
    return model.param_shapes(model.port_config(smoke.CONFIGS[name]))


def digest(tree) -> str:
    h = hashlib.sha256()
    for n, t in weights.leaves(tree):
        h.update(n.encode())
        h.update(t.contiguous().view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


@pytest.mark.parametrize("name,seed", sorted(DIGESTS), ids=lambda x: str(x))
def test_leaves_under_the_threshold_draw_as_before(name, seed):
    n_layers = smoke.CONFIGS[name]["model"]["n_layers"]
    assert digest(weights.draw(smoke_shapes(name), seed, "cpu", n_layers)) == DIGESTS[(name, seed)]


def full_shapes(name):
    """Meta shapes and layer count at full size: a benchmark configuration,
    or DBRX at 8 of its 40 layers with an untied head (the next MoE cell's
    tree)."""
    if name == "dbrx-132b-8l":
        from repro_torch.configs import get_arch

        cfg = dataclasses.replace(get_arch("dbrx-132b").full, n_layers=8, tie_embeddings=False)
        return model.param_shapes(cfg), cfg.n_layers
    conf = json.loads((HERE / "configs" / f"{name}.json").read_text())
    return model.param_shapes(model.port_config(conf)), conf["model"]["n_layers"]


@pytest.mark.parametrize("name", ["starcoder2-15b-4l", "whisper-medium", "dbrx-132b-8l"])
def test_which_leaves_are_drawn_in_slices_at_full_size(name):
    shapes, n_layers = full_shapes(name)
    leaves = weights.leaves(shapes)
    sliced = {n for n, t in leaves if weights.sliced(n, tuple(t.shape), n_layers)}
    if name == "dbrx-132b-8l":
        assert sliced == {"layers.mlp.wi", "layers.mlp.wg", "layers.mlp.wo"}
        assert sum(t.numel() for _, t in leaves) == 27_305_809_920
        for n in sliced:
            shape = dict(leaves)[n].shape
            assert shape[0] == 8 and math.prod(shape[1:]) <= weights.WHOLE
    else:  # every leaf of the benchmark's cells is drawn whole, as it always was
        assert sliced == set()


def test_a_big_leaf_not_stacked_raises_and_names_it():
    n = weights.WHOLE
    assert weights.sliced("layers.mlp.wi", (4, 1024, n // 1024), 4) is True
    assert weights.sliced("layers.ln1.scale", (4, n // 2), 4) is True
    with pytest.raises(ValueError, match="lm_head"):
        weights.sliced("lm_head", (2, n), 4)
    with pytest.raises(ValueError, match="layers.mlp.wg"):
        weights.sliced("layers.mlp.wg", (2, 2, n), 2)
    with pytest.raises(ValueError, match="layers.mlp.wi"):
        weights.sliced("layers.mlp.wi", (4, 1024, n // 1024), 8)


def test_one_rule_says_which_leaves_are_stacked():
    """The leaves drawn by slice and the leaves the view reads by layer are
    picked by the same rule, ``weights.stacked``."""
    n = weights.WHOLE
    for shape, n_layers in [((4, 1024, n // 1024), 4), ((4, n // 2), 4), ((8, n), 4),
                            ((2, n), 4), ((4,), 4), ((4, 3), 4)]:
        assert weights.stacked(shape, n_layers) == (len(shape) >= 2 and shape[0] == n_layers)
        if math.prod(shape) > n:
            try:
                by_slice = weights.sliced("w", shape, n_layers)
            except ValueError:
                by_slice = False
            assert by_slice == weights.stacked(shape, n_layers)
    view = weights.OnDemand({"a": torch.ones(4, 3, dtype=torch.bfloat16),
                             "b": torch.ones(3, 4, dtype=torch.bfloat16)}, 4)
    assert isinstance(view["a"], weights.Layers) and torch.is_tensor(view["b"])


def test_a_sliced_leaf_is_seeded_by_layer_and_keeps_the_fan_in_rule(monkeypatch):
    monkeypatch.setattr(weights, "WHOLE", 64 * 128)
    name, shape = "layers.mlp.wi", (4, 64, 128)
    a = weights.draw_leaf(name, shape, torch.bfloat16, SEED, "cpu", 4)
    b = weights.draw_leaf(name, shape, torch.bfloat16, SEED, "cpu", 4)
    assert a.dtype == torch.bfloat16 and tuple(a.shape) == shape and torch.equal(a, b)
    for i in range(shape[0]):
        alone = weights.drawn(name, shape, SEED, "cpu", i).to(torch.bfloat16)
        assert torch.equal(a[i], alone)
        assert abs(float(a[i].float().std()) * math.sqrt(shape[-2]) - 1) < 0.05
    assert not torch.equal(a[0], a[1])
    other = weights.draw_leaf(name, shape, torch.bfloat16, SEED + 1, "cpu", 4)
    assert not torch.equal(a[0], other[0])
    monkeypatch.setattr(weights, "WHOLE", 1 << 30)
    assert not torch.equal(a, weights.draw_leaf(name, shape, torch.bfloat16, SEED, "cpu", 4))


# the on-demand float32 view

@pytest.fixture(scope="module")
def root(tmp_path_factory):
    torch.set_num_threads(2)
    return smoke.make_root(tmp_path_factory.mktemp("bench"))


def chat_ctx(root, **limits) -> Context:
    cell = Spec(root).cell("sc2-smoke.chat")
    if limits:
        cell = dataclasses.replace(cell, limits={"limits": limits})
    return Context(cell=cell, seed=SEED, seconds=0.0, trace=False, device=torch.device("cpu"),
                   t_start=0.0)


def requests(vocab: int, n: int = 3):
    rng = np.random.default_rng(7)
    out = []
    for k in range(n):
        prompt = rng.integers(0, vocab, 9 + 5 * k).astype(np.int32)
        out.append(SimpleNamespace(prompt=prompt, generated=rng.integers(0, vocab, 6).tolist()))
    return out


def cast_whole(tree):
    return {k: cast_whole(v) if isinstance(v, dict) else v.float() for k, v in tree.items()}


def eager_gaps(ctx, shapes, picked, precisions):
    """The comparison as it was: the whole tree cast to float32 first."""
    from reference.common import Precision, exact_float32

    ref = model.reference(ctx.cell.config)
    m = ctx.cell.config["model"]
    w32 = cast_whole(weights.draw(shapes, ctx.seed, ctx.device, m["n_layers"]))
    widest = {p: 0.0 for p in precisions}
    with exact_float32():
        for r in picked:
            p = len(r.prompt)
            toks = torch.as_tensor(np.concatenate([r.prompt, np.asarray(r.generated[:-1],
                                                                       np.int32)]))
            served = torch.as_tensor(r.generated).long()
            best = ref.logits(m, w32, toks, Precision("float32"))[p - 1:]
            top = best.max(-1).values
            for prec in precisions:
                chosen = served if prec == "float32" else ref.logits(
                    m, w32, toks, Precision(prec))[p - 1:].argmax(-1)
                gap = (top - best.gather(1, chosen[:, None])[:, 0]).max()
                widest[prec] = max(widest[prec], float(gap))
    return widest


class CastCount:
    """Counts the float32 casts the view makes, and the most elements they
    hold at once."""

    def __init__(self, monkeypatch):
        self.live, self.made, self.most = [], 0, 0
        cast = weights.to_float32

        def counted(t):
            out = cast(t)
            self.made += 1
            self.live = [(r, n) for r, n in self.live if r() is not None]
            self.live.append((weakref.ref(out), out.numel()))
            self.most = max(self.most, sum(n for _, n in self.live))
            return out

        monkeypatch.setattr(weights, "to_float32", counted)


def layer_and_unstacked(tree, n_layers):
    """The elements of one layer's slices of the stacked leaves (the
    largest layer's, where ``tree`` holds stacks of two kinds), and of the
    leaves not stacked."""
    def split(t):
        leaves = weights.leaves(t)
        stacked = [x for _, x in leaves if weights.stacked(x.shape, n_layers)]
        return (sum(x.numel() for x in stacked) // n_layers,
                sum(x.numel() for _, x in leaves) - sum(x.numel() for x in stacked))

    parts = [split(v) for v in tree.values()] if "decoder" in tree else [split(tree)]
    return max(a for a, _ in parts), sum(b for _, b in parts)


def test_the_chat_gap_is_bit_identical_through_the_on_demand_view(root, monkeypatch):
    ctx = chat_ctx(root)
    shapes = smoke_shapes("sc2-smoke")
    m = ctx.cell.config["model"]
    picked = requests(m["vocab"])
    want = eager_gaps(ctx, shapes, picked, ("float32", "fp8"))
    count = CastCount(monkeypatch)
    got = closed_loop.reference_gaps(ctx, shapes, picked, ("float32", "fp8"))
    assert got == want and set(got) == {"float32", "fp8"}
    layer, unstacked = layer_and_unstacked(shapes, m["n_layers"])
    assert count.most <= layer + unstacked
    # 10 stacked leaves, each read by layer in both passes; 3 leaves cast once
    assert count.made == 3 + 2 * len(picked) * m["n_layers"] * 10


def test_whisper_reads_the_same_through_the_on_demand_view(monkeypatch):
    from reference import whisper
    from reference.common import Precision, exact_float32

    m = smoke.CONFIGS["whisper-smoke"]["model"]
    w = weights.draw(smoke_shapes("whisper-smoke"), SEED, "cpu", m["n_layers"])
    g = torch.Generator().manual_seed(5)
    frames = torch.randn(40, m["d_model"], generator=g).to(torch.bfloat16)
    tokens = torch.randint(m["vocab"], (16,), generator=g)
    prec = Precision("float32")

    def logits(tree):
        with exact_float32():
            return whisper.decode(m, tree, tokens, whisper.encode(m, tree, frames, prec), prec)

    eager = logits(cast_whole(w))
    count = CastCount(monkeypatch)
    assert torch.equal(logits(weights.OnDemand(w, m["n_layers"])), eager)
    layer, unstacked = layer_and_unstacked(w, m["n_layers"])
    assert count.most <= layer + unstacked
    # 10 stacked leaves in the encoder and 16 in the decoder; 6 cast once
    assert count.made == 6 + (10 + 16) * m["n_layers"]


def test_a_stacked_leaf_is_read_by_layer_only():
    view = weights.OnDemand({"layers": {"w": torch.ones(2, 3, 4, dtype=torch.bfloat16)},
                             "embed": torch.ones(5, 3, dtype=torch.bfloat16)}, 2)
    w = view["layers"]["w"]
    assert w[1].dtype == torch.float32 and tuple(w[1].shape) == (3, 4)
    with pytest.raises(TypeError):
        w[0:1]
    assert view["embed"] is view["embed"] and view["embed"].dtype == torch.float32


# references that set positions aside

class Stub:
    """A reference whose best logit is token 0 at every position and whose
    served token (1) lies ``gap[j]`` below it at served position j; the
    control puts token 2 first, ``ctrl[j]`` below the best. ``undecided``
    marks served positions to set aside, or is None for no mask."""

    def __init__(self, gaps, ctrl, undecided):
        self.gaps, self.ctrl, self.undecided = gaps, ctrl, undecided

    def logits(self, m, w, toks, prec):
        s, p = len(toks), len(toks) - len(self.gaps)
        out = torch.zeros(s, 4)
        out[:, 0] = 1.0
        out[p:, 1] = 1.0 - torch.tensor(self.gaps)
        out[p:, 2] = 1.0 - torch.tensor(self.ctrl)
        if prec.name == "fp8":
            out[:, 2] = 2.0
        if self.undecided is None:
            return out
        mask = torch.zeros(s, dtype=torch.bool)
        mask[p:] = torch.tensor(self.undecided)
        return out, mask


def stub_run(root, monkeypatch, undecided, **limits):
    """One request of 5 served tokens (positions: its last prompt token and
    four generated) through ``reference_gaps`` and ``judged``."""
    gaps = [0.1, 0.9, 0.2, 0.8, 0.3]
    ctrl = [0.4, 3.0, 0.5, 2.0, 0.6]
    monkeypatch.setattr(closed_loop.model, "reference", lambda conf: Stub(gaps, ctrl, undecided))
    ctx = chat_ctx(root, **limits)
    req = SimpleNamespace(prompt=np.array([3, 1, 2], np.int32), generated=[1] * 5)
    out = closed_loop.reference_gaps(ctx, smoke_shapes("sc2-smoke"), [req], ("float32", "fp8"))
    served = closed_loop.Served(record={}, shapes={}, picked=[req], attempted=1,
                                length_errors=0, profile=None)
    return out, closed_loop.judged(ctx, served, out)


def test_positions_set_aside_are_left_out_of_both_gaps(root, monkeypatch):
    out, o = stub_run(root, monkeypatch, [False, True, False, True, False],
                      logit_gap=0.5, length_errors=0, undecided_share=0.5)
    assert math.isclose(out["float32"], 0.3, rel_tol=1e-6)
    assert math.isclose(out["fp8"], 0.6, rel_tol=1e-6)
    assert out["undecided_share"] == 0.4
    assert compare.passed(o.checks)
    assert [n for n, _, _ in o.checks] == ["logit_gap", "length_errors", "undecided_share"]


def test_the_share_set_aside_is_held_to_its_limit(root, monkeypatch):
    _, o = stub_run(root, monkeypatch, [False, True, False, True, False],
                    logit_gap=0.5, length_errors=0, undecided_share=0.25)
    assert ("undecided_share", 0.4, 0.25) in o.checks and not compare.passed(o.checks)


def test_a_sample_wholly_set_aside_fails(root, monkeypatch):
    out, o = stub_run(root, monkeypatch, [True] * 5,
                      logit_gap=0.5, length_errors=0, undecided_share=1.0)
    assert math.isnan(out["float32"]) and math.isnan(out["fp8"])
    assert out["undecided_share"] == 1.0 and not compare.passed(o.checks)


def test_a_reference_with_no_mask_adds_no_reading(root, monkeypatch):
    out, o = stub_run(root, monkeypatch, None, logit_gap=0.5, length_errors=0)
    assert set(out) == {"float32", "fp8"}
    assert math.isclose(out["float32"], 0.9, rel_tol=1e-6)
    assert [n for n, _, _ in o.checks] == ["logit_gap", "length_errors"]
    _, o = stub_run(root, monkeypatch, None, logit_gap=1.0, length_errors=0,
                    undecided_share=0.5)
    assert not compare.passed(o.checks), "a limit on a reading never made fails"


def test_a_mask_with_no_limit_may_set_nothing_aside(root, monkeypatch):
    """A cell whose limits do not name ``undecided_share`` holds it to 0:
    its reference may return a mask, but not use it."""
    _, o = stub_run(root, monkeypatch, [False, True, False, True, False],
                    logit_gap=0.5, length_errors=0)
    assert ("undecided_share", 0.4, 0.0) in o.checks and not compare.passed(o.checks)
    _, o = stub_run(root, monkeypatch, [False] * 5, logit_gap=1.0, length_errors=0)
    assert ("undecided_share", 0.0, 0.0) in o.checks and compare.passed(o.checks)

"""Port parity: logical-axis sharding rules, specs and fallbacks.

For every architecture in the registry, full and smoke configs, on the
(data 2, model 2), (16, 16) and (2, 16, 16) meshes and under five rule
sets (train, train with sequence parallelism, pure data parallelism,
decode, long-context decode), the port's spec for every leaf of the train
state (params and AdamW moments) and of the serving cache equals the
reference's ``PartitionSpec``, with ZeRO off and on; so do each device's
block shape and the recorded fallbacks. Specs read only axis names and
sizes, so both packages take spec-only meshes (JAX's ``AbstractMesh``, the
port's ``AbstractMesh``), and full-size shapes come without memory
(``jax.eval_shape``; the port's meta tensors).
"""

import functools

import jax
import pytest
from jax.sharding import AbstractMesh as JAbstractMesh, PartitionSpec as P

from repro.configs import get_arch as jget_arch
from repro.models.api import family_of as jfamily_of
from repro.parallel import sharding as JS
from repro.train import optimizer as jopt
from repro.train.step import init_state as jinit_state, state_axes as jstate_axes
from repro_torch.configs import ARCHS, get_arch
from repro_torch.models.api import family_of, param_shapes
from repro_torch.parallel import sharding as S
from repro_torch.train import optimizer as opt
from repro_torch.train.step import TrainState, state_axes
from repro_torch.tree import flatten_with_path

MESHES = {
    "2x2": ((2, 2), ("data", "model")),
    "16x16": ((16, 16), ("data", "model")),
    "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
}
RULESETS = {
    "train": dict(kind="train"),
    "train_seq_parallel": dict(kind="train", seq_parallel=True),
    "pure_dp": dict(kind="train", pure_dp=True),
    "decode": dict(kind="decode"),
    "decode_long_context": dict(kind="decode", long_context=True),
}
#: serving-cache geometry: batch, max_len (and whisper's encoder length)
CACHE = (4, 128, 64)


def _configs(arch, size):
    return getattr(jget_arch(arch), size), getattr(get_arch(arch), size)


def _cache_args(fam_name):
    b, max_len, enc_len = CACHE
    return (b, max_len, enc_len) if fam_name == "audio" else (b, max_len)


@functools.lru_cache(maxsize=None)
def trees(arch, size, what):
    """(reference shapes, reference axes, port shapes, port axes) of the
    train state or the serving cache."""
    jcfg, cfg = _configs(arch, size)
    jfam, fam = jfamily_of(jcfg), family_of(cfg)
    if what == "state":
        jshapes = jax.eval_shape(lambda: jinit_state(jcfg, jopt.AdamWConfig(),
                                                     jax.random.PRNGKey(0)))
        params = param_shapes(cfg)
        shapes = TrainState(params, opt.init(opt.AdamWConfig(), params), None)
        shapes = shapes._replace(step=shapes.opt.count)
        return jshapes, jstate_axes(jcfg), shapes, state_axes(cfg)
    args = _cache_args(fam.name)
    jshapes = jax.eval_shape(lambda: jfam.init_cache(jcfg, *args))
    return jshapes, jfam.cache_axes(jcfg), fam.init_cache(cfg, *args, device="meta"), \
        fam.cache_axes(cfg)


def meshes(name):
    shape, names = MESHES[name]
    return JAbstractMesh(shape, names), S.AbstractMesh(names, shape)


@pytest.mark.parametrize("rules", sorted(RULESETS))
@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("size", ["full", "smoke"])
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_specs_and_fallbacks_match_reference(arch, size, mesh, rules):
    """Every leaf's spec equals the reference's ``PartitionSpec`` and each
    device's block shape its ``NamedSharding.shard_shape``, for the train
    state and the cache, ZeRO off and on; the fallback lists are equal."""
    jmesh, tmesh = meshes(mesh)
    jrules, trules = JS.make_rules(jmesh, **RULESETS[rules]), S.make_rules(tmesh, **RULESETS[rules])
    assert trules == jrules
    for what in ("state", "cache"):
        jshapes, jaxes, shapes, axes = trees(arch, size, what)
        for zero in (False, True):
            jsh = JS.tree_shardings(jshapes, jaxes, jrules, jmesh, zero=zero)
            jfallbacks = list(JS.tree_shardings.last_fallbacks)
            sh = S.tree_shardings(shapes, axes, trules, tmesh, zero=zero)
            assert S.tree_shardings.last_fallbacks == jfallbacks, (what, zero)
            jflat = jax.tree_util.tree_flatten_with_path(jsh)[0]
            jleaves = jax.tree.leaves(jshapes)
            flat = flatten_with_path(sh)
            assert [jax.tree_util.keystr(p) for p, _ in jflat] == [p for p, _ in flat]
            for (path, want), (_, got), leaf in zip(jflat, flat, jleaves):
                assert P(*got.spec) == want.spec, (what, zero, jax.tree_util.keystr(path))
                assert got.shard_shape(leaf.shape) == want.shard_shape(leaf.shape)


@pytest.mark.parametrize("size", ["full", "smoke"])
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_axes_trees_match_reference(arch, size):
    """``param_axes``, ``cache_axes`` and ``state_axes`` equal the
    reference's key for key, and name every leaf of the trees they describe."""
    jcfg, cfg = _configs(arch, size)
    jfam, fam = jfamily_of(jcfg), family_of(cfg)
    assert fam.param_axes(cfg) == jfam.param_axes(jcfg)
    assert fam.cache_axes(cfg) == jfam.cache_axes(jcfg)
    assert tuple(state_axes(cfg)) == tuple(jstate_axes(jcfg))
    for what in ("state", "cache"):
        _, _, shapes, axes = trees(arch, size, what)
        named = S.tree_shardings(shapes, axes, S.make_rules(meshes("2x2")[1]),
                                 meshes("2x2")[1])
        assert [p for p, _ in flatten_with_path(named)] == \
            [p for p, _ in flatten_with_path(shapes)]


def test_param_shapes_draw_nothing():
    """A full config's tree comes as meta tensors with the real init's
    shapes and dtypes (checked on the smoke config against a real draw)."""
    import torch

    cfg = get_arch("dbrx-132b").smoke
    meta = param_shapes(cfg)
    real = family_of(cfg).init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    for (path, m), (_, r) in zip(flatten_with_path(meta), flatten_with_path(real)):
        assert m.device.type == "meta" and m.shape == r.shape and m.dtype == r.dtype, path
    full = param_shapes(get_arch("grok-1-314b").full)
    assert sum(t.numel() for _, t in flatten_with_path(full)) == \
        get_arch("grok-1-314b").full.n_params


@pytest.mark.parametrize("spec,mesh,want", [
    ((("data",), None, "model"), "2x2", (0, 2)),
    ((("pod", "data"), "model"), "2x16x16", (0, 0, 1)),
    ((None, ("data", "model")), "16x16", (1, 1)),
    ((), "2x16x16", (None, None, None)),
])
def test_placements_for_specs(spec, mesh, want):
    """One placement per mesh dim: a ``Shard`` of the tensor dim it splits
    (major axis first), else ``Replicate``."""
    from torch.distributed.tensor import Replicate, Shard

    assert S.placements_for(spec, meshes(mesh)[1]) == \
        tuple(Replicate() if d is None else Shard(d) for d in want)


def test_placements_refuse_axes_out_of_mesh_order():
    with pytest.raises(NotImplementedError):
        S.placements_for((("model", "data"),), meshes("2x2")[1])


def test_sharder_is_identity_on_plain_tensors():
    import torch

    mesh = meshes("2x2")[1]
    sharder = S.make_sharder(mesh, S.make_rules(mesh), zero_params=True)
    x = torch.ones(4, 8, 16)
    assert sharder(x, ("batch", "seq", "embed")) is x
    assert sharder.mesh is mesh and sharder.zero_params and sharder.rules["batch"] == ("data",)

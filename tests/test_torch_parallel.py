"""Port parity: collectives, GPipe and the all-to-all MoE dispatch on four
CPU ranks.

The port runs on four spawned ``gloo`` ranks (``tests/_torch_ranks.py``);
the reference runs in a subprocess over four forced host devices, on a
``Mesh`` built from the device array, whose axes are Auto (``jax.make_mesh``
gives Explicit axes under this JAX, which its ``with_sharding_constraint``
refuses). Both get the same numpy inputs. Each multi-rank scenario runs
once per module and its results are checked case by case; tolerances are
written beside each test.
"""

import os
import pickle
import subprocess
import sys
import textwrap

import numpy as np
import pytest

from _torch_ranks import parallel_job, run_ranks

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 4

REFERENCE = """
import pickle, sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import Mesh, PartitionSpec as P
from repro.utils.compat import shard_map
from repro.parallel.collectives import compressed_psum, overlapped_all_gather, ring_layer_matmul
from repro.parallel.pipeline import pipeline_forward, split_stages
from repro.parallel.sharding import make_rules, make_sharder
from repro.models import moe as M

inp = pickle.load(open(sys.argv[1], "rb"))
devs = np.array(jax.devices())
line = Mesh(devs, ("data",))
out = {}

f = jax.jit(shard_map(lambda g, r: compressed_psum(g, r, "data"), mesh=line,
                      in_specs=(P("data"), P("data")), out_specs=(P("data"), P("data")),
                      check_vma=False))
g, r = jnp.asarray(inp["g"]), jnp.zeros_like(jnp.asarray(inp["g"]))
means, residuals = [], []
for _ in range(30):
    m, r = f(g, r)
    means.append(np.asarray(m))
    residuals.append(np.asarray(r))
out["means"], out["residuals"] = np.stack(means, 1), np.stack(residuals, 1)

def gather(w_shard):
    stacked, parts = overlapped_all_gather(w_shard, "data", 4, lambda src, p: (src, p))
    srcs = jnp.stack([s for s, _ in parts])
    return stacked[None], srcs[None], jnp.stack([p for _, p in parts])[None]
st, srcs, parts = shard_map(gather, mesh=line, in_specs=(P("data"),),
                            out_specs=(P("data"), P("data"), P("data")),
                            check_vma=False)(jnp.asarray(inp["w"]))
out["stacked"], out["srcs"], out["parts"] = np.asarray(st), np.asarray(srcs), np.asarray(parts)
out["ring"] = np.asarray(shard_map(lambda x, w: ring_layer_matmul(x, w, "data", 4), mesh=line,
                                   in_specs=(P(), P("data")), out_specs=P(),
                                   check_vma=False)(jnp.asarray(inp["x"]), jnp.asarray(inp["w"])))

def stage_fn(ws, h):
    return jax.lax.scan(lambda h, w: (jnp.tanh(h @ w), None), h, ws)[0]
pod = Mesh(devs, ("pod",))
out["pipeline"] = np.asarray(jax.jit(lambda ws, xs: pipeline_forward(
    stage_fn, split_stages(ws, 4), xs, pod, "pod"))(jnp.asarray(inp["ws"]), jnp.asarray(inp["xs"])))

mk = lambda a2a, gated: M.MoEConfig(
    name="t", n_layers=2, d_model=64, n_heads=4, n_kv=2, d_ff=96, vocab=211, n_experts=4,
    top_k=2, capacity_factor=8.0, dtype=jnp.float32, gated=gated, act="silu", remat=False,
    a2a_dispatch=a2a)
toks = jnp.asarray(inp["tokens"])
grid = Mesh(devs.reshape(2, 2), ("data", "model"))
for gated in (True, False):
    params = jax.tree.map(jnp.asarray, inp["params"][gated])
    out[("global", gated)] = float(jax.jit(lambda p: M.loss_fn(mk(False, gated), p,
                                                               {"tokens": toks}))(params))
    for zero in (False, True):
        with grid:
            rules = make_rules(grid, kind="train", seq_parallel=True)
            sharder = make_sharder(grid, rules, zero_params=zero)
            loss, grads = jax.jit(jax.value_and_grad(
                lambda p: M.loss_fn(mk(True, gated), p, {"tokens": toks}, sharder=sharder)))(params)
        out[(gated, zero)] = {"loss": float(loss), "grads": {
            k: np.asarray(v) for k, v in grads["layers"]["mlp"].items()}}
pickle.dump(out, open(sys.argv[2], "wb"))
"""


def moe_inputs():
    """The reference a2a test's weights (its MoE init at key 1, gated and
    ungated) and tokens, as numpy."""
    import jax

    from repro.models import moe as JM

    key = jax.random.PRNGKey(1)
    params = {}
    for gated in (True, False):
        cfg = JM.MoEConfig(name="t", n_layers=2, d_model=64, n_heads=4, n_kv=2, d_ff=96,
                           vocab=211, n_experts=4, top_k=2, capacity_factor=8.0,
                           dtype=jax.numpy.float32, gated=gated, act="silu", remat=False)
        params[gated] = jax.tree.map(np.asarray, JM.init_params(cfg, key))
    return params, np.asarray(jax.random.randint(key, (4, 32), 0, 211))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(inputs, reference results, the port's per-rank results); the
    reference's process and the port's ranks run at the same time."""
    tmp = tmp_path_factory.mktemp("parallel")
    rng = np.random.default_rng(0)
    inputs = {
        "g": rng.standard_normal((WORLD, 64)).astype(np.float32),  # one row per rank
        "w": rng.standard_normal((64, 32)).astype(np.float32),
        "x": rng.standard_normal((4, 64)).astype(np.float32),
        "ws": (rng.standard_normal((8, 16, 16)) * 0.3).astype(np.float32),
        "xs": rng.standard_normal((6, 2, 5, 16)).astype(np.float32),  # 6 microbatches
    }
    inputs["params"], inputs["tokens"] = moe_inputs()
    in_path, ref_path = tmp / "inputs.pkl", tmp / "reference.pkl"
    with open(in_path, "wb") as f:
        pickle.dump(inputs, f)
    env = dict(os.environ, XLA_FLAGS=f"--xla_force_host_platform_device_count={WORLD}",
               PYTHONPATH=os.path.join(REPO, "src"), JAX_PLATFORMS="cpu")
    proc = subprocess.Popen([sys.executable, "-c", textwrap.dedent(REFERENCE), str(in_path),
                             str(ref_path)], env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    port = run_ranks(parallel_job, WORLD, tmp, str(in_path))
    _, err = proc.communicate(timeout=600)
    assert proc.returncode == 0, err[-4000:]
    with open(ref_path, "rb") as f:
        ref = pickle.load(f)
    return inputs, ref, port


# ---------------------------------------------------------------------------
# int8 error-feedback psum
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("rank", range(WORLD))
def test_compressed_psum_steps_match_reference(runs, rank):
    """All 30 steps' means and residuals within 1e-6 of the reference's
    shard_map run on the same rows (the shared scale makes the int8
    payloads equal: any gap beyond rounding of the f32 decode is a fault)."""
    _, ref, coll = runs
    np.testing.assert_allclose(coll[rank]["means"], ref["means"][rank], rtol=0, atol=1e-6)
    np.testing.assert_allclose(coll[rank]["residuals"], ref["residuals"][rank], rtol=0,
                               atol=1e-6)


def test_compressed_psum_error_feedback_converges(runs):
    """The criterion of the reference's own test: the time-average of 30
    compressed means is within 0.05 (relative to the largest entry) of the
    exact mean; every rank holds the same means."""
    inputs, _, coll = runs
    exact = inputs["g"].mean(0)
    approx = coll[0]["means"].mean(0)
    err = np.abs(approx - exact).max() / np.abs(exact).max()
    assert err < 0.05, err
    for r in coll[1:]:
        np.testing.assert_array_equal(r["means"], coll[0]["means"])


def test_compressed_grad_sync_is_compressed_psum_per_leaf(runs):
    """``make_compressed_grad_sync`` over the mesh's data axis gives each
    leaf of a tree what ``compressed_psum`` gives it alone."""
    _, _, coll = runs
    assert all(r["tree_sync"] for r in coll)


def test_quantize_roundtrip_matches_reference():
    """quantize_int8 / dequantize_int8 against the reference on one tensor,
    half-way values included (both round half to even): equal bits."""
    import jax.numpy as jnp
    import torch

    from repro.parallel import collectives as JC
    from repro_torch.parallel import collectives as C

    x = np.concatenate([np.random.default_rng(1).standard_normal(253),
                        [127.0, -63.5, 0.5]]).astype(np.float32)
    jq, js = JC.quantize_int8(jnp.asarray(x))
    q, s = C.quantize_int8(torch.from_numpy(x))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    assert float(s) == float(js)
    np.testing.assert_array_equal(C.dequantize_int8(q, s).numpy(),
                                  np.asarray(JC.dequantize_int8(jq, js)))


# ---------------------------------------------------------------------------
# ring all-gather, ring matmul, GPipe
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("rank", range(WORLD))
def test_overlapped_all_gather_matches_reference(runs, rank):
    """The stacked shards (in hop order, own shard first), the source rank
    of each hop and the shard each compute call saw equal the reference's
    ring on the same device, exactly."""
    _, ref, coll = runs
    np.testing.assert_array_equal(coll[rank]["stacked"], ref["stacked"][rank])
    assert coll[rank]["srcs"] == list(ref["srcs"][rank])
    np.testing.assert_array_equal(coll[rank]["parts"], ref["parts"][rank])


@pytest.mark.parametrize("rank", range(WORLD))
def test_ring_layer_matmul_matches_dense_and_reference(runs, rank):
    """x @ W through the ring within 1e-5 of the dense product and of the
    reference's ring."""
    inputs, ref, coll = runs
    np.testing.assert_allclose(coll[rank]["ring"], inputs["x"] @ inputs["w"], rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(coll[rank]["ring"], ref["ring"], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("rank", range(WORLD))
def test_pipeline_matches_sequential_on_every_rank(runs, rank):
    """GPipe with 4 stages, 8 layers, 6 microbatches: every rank's outputs
    within 2e-5 of the sequential layers and of the reference's schedule."""
    inputs, ref, coll = runs
    seq = inputs["xs"]
    for w in inputs["ws"]:
        seq = np.tanh(seq @ w)
    np.testing.assert_allclose(coll[rank]["pipeline"], seq, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(coll[rank]["pipeline"], ref["pipeline"], rtol=2e-5, atol=2e-5)


def test_host_mesh_clamps_the_model_axis(runs):
    """``make_host_mesh`` over four ranks: (4, 1), (2, 2), and (1, 4) for
    ``model=8``, clamped to the world as the reference's; the production
    mesh needs 256 ranks and refuses four."""
    _, _, coll = runs
    for r in coll:
        assert r["host_meshes"] == {1: (4, 1), 2: (2, 2), 8: (1, 4)}
        assert r["production_refused"]


def test_split_stages_matches_reference():
    import jax.numpy as jnp
    import torch

    from repro.parallel.pipeline import split_stages as jsplit
    from repro_torch.parallel.pipeline import split_stages

    w = np.arange(8 * 3 * 2, dtype=np.float32).reshape(8, 3, 2)
    got = split_stages({"w": torch.from_numpy(w)}, 4)["w"]
    np.testing.assert_array_equal(got.numpy(), np.asarray(jsplit({"w": jnp.asarray(w)}, 4)["w"]))
    with pytest.raises(AssertionError):
        split_stages(torch.zeros(6, 2), 4)


# ---------------------------------------------------------------------------
# all-to-all MoE dispatch
# ---------------------------------------------------------------------------

A2A_CASES = [(gated, zero) for gated in (True, False) for zero in (False, True)]


@pytest.mark.parametrize("gated,zero", A2A_CASES)
def test_a2a_loss_matches_reference(runs, gated, zero):
    """The a2a loss on the (data 2, model 2) mesh within 1e-5 of the
    reference's a2a loss on its Auto (2, 2) mesh, on every rank, and within
    rtol 5e-4 of the global dispatch (the aux-loss statistics are per-shard
    means under a2a), in both packages."""
    _, ref, a2a = runs
    want = ref[(gated, zero)]["loss"]
    for r in a2a:
        np.testing.assert_allclose(r[(gated, zero)]["loss"], want, rtol=1e-5)
    np.testing.assert_allclose(a2a[0][(gated, zero)]["loss"], ref[("global", gated)],
                               rtol=5e-4)
    np.testing.assert_allclose(a2a[0][("global", gated)], ref[("global", gated)], rtol=1e-5)


@pytest.mark.parametrize("gated,zero", A2A_CASES)
def test_a2a_gradients_match_reference(runs, gated, zero):
    """Router and expert gradients within 1e-4, row-scaled (each row's
    error over that row's largest reference entry), of ``jax.grad`` of the
    reference's a2a loss."""
    _, ref, a2a = runs
    want, got = ref[(gated, zero)]["grads"], a2a[0][(gated, zero)]["grads"]
    assert sorted(got) == sorted(want) == sorted(["router", "wi", "wo"] + (["wg"] if gated else []))
    for k in want:
        scale = np.abs(want[k]).max(-1, keepdims=True)
        err = np.abs(got[k] - want[k]) / np.maximum(scale, 1e-30)
        assert err.max() < 1e-4, (k, float(err.max()))
    for r in a2a[1:]:
        for k in want:
            np.testing.assert_array_equal(r[(gated, zero)]["grads"][k], got[k])


def test_a2a_takes_no_gathering_site(runs):
    """The a2a dispatch runs on each rank's block; only the attention (a
    sequence split), the cross-entropy (a vocab split) and, with ZeRO, the
    embedding table gather."""
    _, _, a2a = runs
    assert set(a2a[0]["sites"]) <= {"attention", "cross-entropy", "embedding"}
    assert not any("moe" in s for s in a2a[0]["sites"])

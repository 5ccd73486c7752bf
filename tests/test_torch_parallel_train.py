"""Port parity: the sharded train step, the sharded launcher and elastic
restore, on four CPU ranks.

smollm's smoke config (3 heads and 1 kv head, so a model split of 2 cuts
a head's projection in two) and dbrx's (ZeRO, ZeRO-3 expert weights and 4
microbatches, as its ``ArchEntry`` asks) take three steps on a (data 2,
model 2) mesh from weights drawn by the JAX init. The port's sharded step
is held to its own unsharded step and to the reference's jitted step with
the state placed by its ``tree_shardings`` on an Auto (2, 2) mesh, run in a
subprocess over four forced host devices at the same time. The launcher
runs on four ranks with one injected failure; its last checkpoint is
restored onto a (data 4, model 1) mesh and onto one rank.
"""

import os
import pickle
import subprocess
import sys
import textwrap

import numpy as np
import pytest

from _torch_ranks import run_ranks, train_job

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 4
ARCHS = ("smollm-135m", "dbrx-132b")
LAUNCH = ["--arch", "smollm-135m", "--smoke", "--model-parallel", "2", "--steps", "20",
          "--batch", "8", "--seq", "128", "--device", "cpu", "--ckpt-every", "5"]

REFERENCE = """
import pickle, sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import Mesh
from repro.configs import get_arch
from repro.models.api import family_of
from repro.parallel.sharding import make_rules, make_sharder, tree_shardings
from repro.train import optimizer as opt
from repro.train.step import TrainState, make_train_step, state_axes

inp = pickle.load(open(sys.argv[1], "rb"))
mesh = Mesh(np.array(jax.devices()).reshape(2, 2), ("data", "model"))
out = {}
for arch in inp["archs"]:
    entry = get_arch(arch)
    cfg = entry.smoke
    adamw = opt.AdamWConfig(lr=1e-3)
    params = jax.tree.map(jnp.asarray, inp[arch]["params"])
    state = TrainState(params, opt.init(adamw, params), jnp.zeros((), jnp.int32))
    with mesh:
        rules = make_rules(mesh, kind="train", seq_parallel=False)
        sharder = make_sharder(mesh, rules, zero_params=entry.zero_params)
        sh = tree_shardings(jax.eval_shape(lambda: state), state_axes(cfg), rules, mesh,
                            zero=entry.zero)
        state = jax.device_put(state, sh)
        batches = [{"tokens": jnp.asarray(t)} for t in inp[arch]["batches"]]
        grads = jax.jit(jax.grad(lambda p: family_of(cfg).loss_fn(cfg, p, batches[0],
                                                                  sharder=sharder)))(params)
        step = jax.jit(make_train_step(cfg, adamw, sharder, microbatches=entry.microbatches))
        losses = []
        for b in batches:
            state, m = step(state, b)
            losses.append(float(m["loss"]))
    out[arch] = {"losses": losses, "grads": [np.asarray(g) for g in jax.tree.leaves(grads)],
                 "final": [np.asarray(x, np.float32) for x in jax.tree.leaves(state)],
                 "shard_shapes": [s.shard_shape(x.shape) for s, x in
                                  zip(jax.tree.leaves(sh), jax.tree.leaves(state))]}
pickle.dump(out, open(sys.argv[2], "wb"))
"""


def inputs():
    """Each arch's JAX-initialised smoke params (key 1) and three batches
    of the reference's data pipeline (batch 8, seq 32), as numpy."""
    import jax

    from repro.configs import get_arch as jget_arch
    from repro.data.pipeline import DataConfig, SyntheticTokens
    from repro.models.api import family_of

    out = {"archs": ARCHS}
    for arch in ARCHS:
        cfg = jget_arch(arch).smoke
        params = family_of(cfg).init_params(cfg, jax.random.PRNGKey(1))
        data = SyntheticTokens(DataConfig(vocab=cfg.vocab, seq_len=32, global_batch=8, seed=0))
        out[arch] = {"params": jax.tree.map(np.asarray, params),
                     "batches": [np.asarray(data.batch_at(i)["tokens"]) for i in range(3)]}
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(reference results, the port's per-rank results, checkpoint dir)."""
    tmp = tmp_path_factory.mktemp("parallel_train")
    in_path, ref_path, ckpt_dir = tmp / "inputs.pkl", tmp / "reference.pkl", tmp / "ckpt"
    with open(in_path, "wb") as f:
        pickle.dump(inputs(), f)
    env = dict(os.environ, XLA_FLAGS=f"--xla_force_host_platform_device_count={WORLD}",
               PYTHONPATH=os.path.join(REPO, "src"), JAX_PLATFORMS="cpu")
    proc = subprocess.Popen([sys.executable, "-c", textwrap.dedent(REFERENCE), str(in_path),
                             str(ref_path)], env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    port = run_ranks(train_job, WORLD, tmp, str(in_path), ARCHS, str(ckpt_dir), LAUNCH)
    _, err = proc.communicate(timeout=600)
    assert proc.returncode == 0, err[-4000:]
    with open(ref_path, "rb") as f:
        ref = pickle.load(f)
    return ref, port, ckpt_dir


def rel(a, b):
    return float(np.abs(np.asarray(a) - np.asarray(b)).max() / np.abs(np.asarray(b)).max())


# ---------------------------------------------------------------------------
# the sharded train step
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_losses_match_unsharded_and_reference(runs, arch):
    """Each step's loss within 1e-5 (relative) of the port's unsharded
    step and within 1e-4 of the reference's sharded jitted step, on every
    rank."""
    ref, port, _ = runs
    for r in port:
        got = r["steps"][arch]
        np.testing.assert_allclose(got["losses"], got["plain_losses"], rtol=1e-5)
        np.testing.assert_allclose(got["losses"], ref[arch]["losses"], rtol=1e-4)


@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_gradients_match_unsharded_and_reference(runs, arch):
    """The first step's gradient, leaf by leaf, within 1e-5 of the port's
    unsharded gradient and 1e-4 of ``jax.grad`` of the reference's sharded
    loss (each relative to the leaf's largest entry)."""
    ref, port, _ = runs
    got = port[0]["steps"][arch]
    assert len(got["grads"]) == len(ref[arch]["grads"])
    for g, p, j in zip(got["grads"], got["plain_grads"], ref[arch]["grads"]):
        assert rel(g, p) < 1e-5
        assert rel(g, j) < 1e-4


@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_final_state_matches(runs, arch):
    """After three steps every leaf's whole value equals on every rank and
    is within 1e-5 (relative to the leaf's largest entry) of the port's
    unsharded step's, and 1e-4 of the reference's, except where AdamW's
    first steps act as a sign function: an entry whose gradient is of the
    order of eps (1e-8) may move by up to lr per step, so at most 0.5 % of
    a leaf's entries may differ, by at most 3 * lr. A sharding fault moves
    whole leaves."""
    ref, port, _ = runs
    got = port[0]["steps"][arch]
    for r in port[1:]:
        for a, b in zip(r["steps"][arch]["final"], got["final"]):
            np.testing.assert_array_equal(a, b)
    lr, steps = 1e-3, 3
    for want, tol in ((got["plain_final"], 1e-5), (ref[arch]["final"], 1e-4)):
        for g, w in zip(got["final"], want):
            diff = np.abs(g - w)
            off = diff > tol * max(np.abs(w).max(), 1e-30)
            assert off.mean() <= 0.005, (arch, off.mean())
            assert diff.max() <= steps * lr * 1.01, (arch, diff.max())


@pytest.mark.parametrize("arch", ARCHS)
def test_each_rank_holds_what_jax_would(runs, arch):
    """Every state leaf is a DTensor with the rules' placements, and each
    rank's block shape equals the reference's ``NamedSharding.shard_shape``
    of that leaf."""
    ref, port, _ = runs
    for r in port:
        got = r["steps"][arch]
        assert got["placements"] == got["want_placements"]
        assert [tuple(s) for s in got["local_shapes"]] == \
            [tuple(s) for s in ref[arch]["shard_shapes"]]


def test_sharded_step_records_its_gathering_sites(runs):
    """smollm's heads reshape and the vocab-split cross-entropy gather;
    dbrx's global dispatch routes every token on every rank; its ffn dims
    fall back to replication where the expert dim takes the model axis."""
    _, port, _ = runs
    smollm, dbrx = port[0]["steps"]["smollm-135m"], port[0]["steps"]["dbrx-132b"]
    assert smollm["fallbacks"] == []
    assert set(smollm["sites"]) == {"heads reshape", "cross-entropy"}
    assert {"moe dispatch", "moe combine", "cross-entropy"} <= set(dbrx["sites"])
    assert dbrx["fallbacks"] and set(dbrx["fallbacks"]) == {"ffn:96"}


# ---------------------------------------------------------------------------
# the launcher, restarts and elastic restore
# ---------------------------------------------------------------------------


def test_launcher_trains_on_a_2x2_mesh_and_recovers(runs):
    """``--model-parallel 2`` on four ranks: a (data 2, model 2) gloo mesh,
    the loss falls over 20 steps, and the failure injected at step 12 is
    recovered from the step-10 checkpoint; every rank reports the same."""
    _, port, _ = runs
    results = [r["launcher"]["result"] for r in port]
    res = results[0]
    assert res["mesh"] == {"shape": [2, 2], "names": ["data", "model"]}
    assert res["world"] == WORLD and res["backend"] == "gloo"
    assert res["steps"] == 20 and res["last_loss"] < res["first_loss"]
    restarts = [e for e in res["events"] if e["kind"] == "restart"]
    assert len(restarts) == 1 and restarts[0]["step"] == 12
    assert "site:cross-entropy" in res["fallbacks"]
    for r in results[1:]:
        assert r["first_loss"] == res["first_loss"] and r["last_loss"] == res["last_loss"]


def test_checkpoint_restores_bit_for_bit_on_another_mesh(runs):
    """The launcher's last checkpoint (saved from the (2, 2) mesh) restores
    onto a (4, 1) mesh with that mesh's placements, every leaf bit-equal."""
    _, port, _ = runs
    for r in port:
        assert r["launcher"]["last_step"] == 20
        assert all(r["launcher"]["restored_equal"])
        assert r["launcher"]["restored_placements_ok"]


def test_checkpoint_restores_bit_for_bit_on_one_rank(runs):
    """The same checkpoint restored by a single process, with no process
    group, into plain tensors: bit-equal to the trained state."""
    import torch

    from repro_torch.ckpt.checkpoint import CheckpointManager
    from repro_torch.configs import get_arch
    from repro_torch.train import optimizer as opt
    from repro_torch.train.step import init_state
    from repro_torch.tree import leaves

    _, port, ckpt_dir = runs
    cfg = get_arch("smollm-135m").smoke
    like = init_state(cfg, opt.AdamWConfig(), torch.Generator().manual_seed(0), "cpu")
    restored = CheckpointManager(ckpt_dir).restore(like)
    whole = port[0]["launcher"]["whole"]
    assert len(leaves(restored)) == len(whole)
    for a, b in zip(leaves(restored), whole):
        np.testing.assert_array_equal(a.float().numpy(), b)


@pytest.mark.parametrize("model_parallel", [1, 2])
def test_finetune_example_trains_on_one_rank(tmp_path, model_parallel):
    """``examples/finetune_torch.py`` at smoke size on the CPU: the plain
    step, and with ``--model-parallel 2`` the sharded step on the (1, 1)
    mesh one rank clamps it to; the loss falls."""
    import importlib.util

    path = os.path.join(REPO, "examples", "finetune_torch.py")
    spec = importlib.util.spec_from_file_location("finetune_torch", path)
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    result = example.main(["--steps", "20", "--batch", "8", "--seq", "128", "--device", "cpu",
                           "--model-parallel", str(model_parallel),
                           "--ckpt-dir", str(tmp_path / "ckpt")])
    assert result["last_loss"] < result["first_loss"]
    assert ("mesh" in result) == (model_parallel > 1)
    if model_parallel > 1:
        assert result["mesh"]["shape"] == [1, 1] and result["world"] == 1

"""Port parity: checkpointing and the fault-tolerance supervisor.

Counterparts of ``tests/test_ft.py`` on the port, and checkpoints across
packages: a checkpoint either package writes restores in the other with
the same ``meta.json`` keys and dtypes. The reference cannot restore its
own bf16 checkpoints (its ``restore`` hands numpy's 2-byte void items to
``jnp.asarray``); a test pins that, and the port restores them bit-exact.
"""

import itertools
import json

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.ckpt.checkpoint import CheckpointManager as JCheckpointManager
from repro.train import optimizer as jopt
from repro.train.step import TrainState as JTrainState
from repro_torch.ckpt.checkpoint import CheckpointManager
from repro_torch.data.pipeline import DataConfig, SyntheticTokens
from repro_torch.ft.supervisor import StragglerDetector, Supervisor, SupervisorConfig, to_float
from repro_torch.train import optimizer as opt
from repro_torch.train.step import TrainState
from repro_torch.tree import flatten_with_path

CPU = "cpu"


def tiny_state():
    return {"w": torch.arange(12.0).reshape(3, 4), "step": torch.tensor(7, dtype=torch.int32)}


def data(seq_len=16):
    return SyntheticTokens(DataConfig(vocab=97, seq_len=seq_len, global_batch=2), device=CPU)


# ---------------------------------------------------------------------------
# checkpointing
# ---------------------------------------------------------------------------


def test_checkpoint_roundtrip(tmp_path):
    mgr = CheckpointManager(tmp_path)
    state = tiny_state()
    mgr.save(3, state)
    assert mgr.latest_step() == 3
    back = mgr.restore({k: torch.zeros_like(v) for k, v in state.items()})
    assert torch.equal(back["w"], state["w"]) and int(back["step"]) == 7
    assert back["step"].dtype == torch.int32
    assert sorted(p.name for p in mgr.step_dir(3).iterdir()) == [
        "COMMIT", "meta.json", "shard_00000.npz"]


def test_checkpoint_uncommitted_is_invisible(tmp_path):
    mgr = CheckpointManager(tmp_path)
    mgr.save(1, tiny_state())
    torn = mgr.step_dir(5)
    torn.mkdir()
    (torn / "meta.json").write_text("{}")  # no COMMIT marker
    assert mgr.latest_step() == 1
    with pytest.raises(FileNotFoundError):
        CheckpointManager(tmp_path / "empty").restore(tiny_state())


def test_checkpoint_async_and_retention(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=2)
    for s in (1, 2, 3, 4):
        mgr.save_async(s, tiny_state())
    mgr.wait()
    steps = sorted(int(p.name.split("_")[1]) for p in tmp_path.glob("step_*"))
    assert steps == [3, 4]


def test_save_async_snapshots_before_it_returns(tmp_path):
    """An in-place update right after ``save_async`` must not reach the
    checkpoint: a CPU tensor's ``.cpu()`` is the tensor itself, so the
    snapshot has to copy it."""
    mgr = CheckpointManager(tmp_path)
    state = tiny_state()
    mgr.save_async(1, state)
    state["w"].add_(100.0)
    mgr.wait()
    back = mgr.restore(tiny_state())
    assert torch.equal(back["w"], torch.arange(12.0).reshape(3, 4))


def test_checkpoint_restore_onto_device_and_dtype(tmp_path):
    """Restore places leaves on the named device and casts to the dtypes of
    ``like`` (the port's counterpart of the reference's elastic restore)."""
    mgr = CheckpointManager(tmp_path)
    mgr.save(1, {"w": torch.arange(16.0).reshape(4, 4)})
    back = mgr.restore({"w": torch.zeros(4, 4, dtype=torch.bfloat16)}, device=CPU)
    assert back["w"].dtype == torch.bfloat16 and back["w"].device.type == "cpu"
    assert torch.equal(back["w"].float(), torch.arange(16.0).reshape(4, 4))
    with pytest.raises(KeyError, match="missing"):
        mgr.restore({"w": torch.zeros(4, 4), "extra": torch.zeros(1)})


def test_checkpoint_errors_surface_through_wait(tmp_path):
    def broken(step, arrays):
        raise OSError("disk full")

    mgr = CheckpointManager(tmp_path)
    mgr._write = broken
    mgr.save_async(1, tiny_state())
    with pytest.raises(OSError, match="disk full"):
        mgr.wait()
    mgr.wait()  # the error is raised once


# ---------------------------------------------------------------------------
# checkpoints across packages
# ---------------------------------------------------------------------------


def _states(dtype_name: str):
    """The same train state in both packages: params of ``dtype_name``,
    f32 moments, count 3, step 5 (leaf values from a numpy seed)."""
    rng = np.random.default_rng(0)
    shapes = {"embed": (6, 4), "layers": {"attn": {"wq": (2, 4, 4)}, "ln1": {"scale": (2, 4)}}}
    raw = jax.tree.map(lambda s: rng.standard_normal(s).astype(np.float32), shapes,
                       is_leaf=lambda x: isinstance(x, tuple))
    jdt = getattr(jnp, dtype_name)
    jparams = jax.tree.map(lambda x: jnp.asarray(x).astype(jdt), raw)
    jmu = jax.tree.map(lambda x: jnp.asarray(0.5 * x), raw)
    jnu = jax.tree.map(lambda x: jnp.asarray(x * x), raw)
    jstate = JTrainState(jparams, jopt.OptState(jmu, jnu, jnp.int32(3)), jnp.int32(5))

    def conv(tree, dt):
        return jax.tree.map(lambda x: torch.from_numpy(np.array(x, np.float32)).to(dt), tree)

    tdt = getattr(torch, dtype_name)
    state = TrainState(conv(jparams, tdt),
                       opt.OptState(conv(jmu, torch.float32), conv(jnu, torch.float32),
                                    torch.tensor(3, dtype=torch.int32)),
                       torch.tensor(5, dtype=torch.int32))
    return jstate, state


def _zeros_like(state):
    return TrainState(*jax.tree.map(torch.zeros_like, tuple(state)))


def _same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    view = {2: torch.int16, 4: torch.int32, 8: torch.int64}[a.element_size()]
    return a.dtype == b.dtype and torch.equal(a.view(view), b.view(view))


def test_leaf_keys_are_jax_keystr():
    jstate, state = _states("float32")
    want = [jax.tree_util.keystr(k) for k, _ in jax.tree_util.tree_flatten_with_path(jstate)[0]]
    assert [p for p, _ in flatten_with_path(state)] == want
    assert ".params['layers']['attn']['wq']" in want and ".opt.count" in want


def test_jax_f32_checkpoint_restores_in_port_and_back(tmp_path):
    jstate, state = _states("float32")
    JCheckpointManager(tmp_path / "j").save(5, jstate)
    CheckpointManager(tmp_path / "t").save(5, state)
    jmeta = json.loads((tmp_path / "j" / "step_000000005" / "meta.json").read_text())
    tmeta = json.loads((tmp_path / "t" / "step_000000005" / "meta.json").read_text())
    assert tmeta["paths"] == jmeta["paths"] and tmeta["step"] == jmeta["step"] == 5
    # JAX-written -> port
    back = CheckpointManager(tmp_path / "j").restore(_zeros_like(state))
    for (path, got), (_, want) in zip(flatten_with_path(back), flatten_with_path(state)):
        assert _same_bits(got, want), path
    # port-written -> JAX
    jback = JCheckpointManager(tmp_path / "t").restore(jax.tree.map(jnp.zeros_like, jstate))
    for got, want in zip(jax.tree.leaves(jback), jax.tree.leaves(jstate)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def test_jax_bf16_checkpoint_restores_in_port_bit_exact(tmp_path):
    jstate, state = _states("bfloat16")
    JCheckpointManager(tmp_path / "j").save(5, jstate)
    back = CheckpointManager(tmp_path / "j").restore(_zeros_like(state))
    for (path, got), (_, want) in zip(flatten_with_path(back), flatten_with_path(state)):
        assert _same_bits(got, want), path
    assert back.params["embed"].dtype == torch.bfloat16


def test_port_writes_bf16_as_the_reference_does(tmp_path):
    """Same keys, shapes and dtypes in meta.json; bf16 leaves are 2-byte
    void items in the npz with the reference's bytes."""
    jstate, state = _states("bfloat16")
    JCheckpointManager(tmp_path / "j").save(5, jstate)
    CheckpointManager(tmp_path / "t").save(5, state)
    jd, td = tmp_path / "j" / "step_000000005", tmp_path / "t" / "step_000000005"
    jmeta, tmeta = (json.loads((d / "meta.json").read_text()) for d in (jd, td))
    assert tmeta["paths"] == jmeta["paths"]
    assert tmeta["paths"][".params['embed']"]["dtype"] == "bfloat16"
    with np.load(jd / "shard_00000.npz") as jz, np.load(td / "shard_00000.npz") as tz:
        assert sorted(tz.files) == sorted(jz.files)
        for k in jz.files:
            assert tz[k].dtype.itemsize == jz[k].dtype.itemsize and tz[k].shape == jz[k].shape
            assert tz[k].tobytes() == jz[k].tobytes(), k
            if jmeta["paths"][k]["dtype"] == "bfloat16":
                assert tz[k].dtype.kind == jz[k].dtype.kind == "V"
    # the bytes are the params: viewed as bfloat16 they equal them
    with np.load(td / "shard_00000.npz") as tz:
        emb = tz[".params['embed']"].view(ml_dtypes.bfloat16)
    np.testing.assert_array_equal(emb, np.asarray(jstate.params["embed"]))


def test_reference_cannot_restore_its_own_bf16_checkpoint(tmp_path):
    """Reference fault (ROADMAP queue C): its restore calls jnp.asarray on
    the npz's 2-byte void items. If this starts passing, the reference was
    fixed and this pin should go."""
    jstate, _ = _states("bfloat16")
    mgr = JCheckpointManager(tmp_path)
    mgr.save(5, jstate)
    with pytest.raises(TypeError, match="V2"):
        mgr.restore(jax.tree.map(jnp.zeros_like, jstate))


# ---------------------------------------------------------------------------
# straggler detector
# ---------------------------------------------------------------------------


def test_straggler_detector_fires_on_slow_step():
    t = [0.0]
    det = StragglerDetector(factor=3.0, warmup=3, clock=lambda: t[0])
    for i in range(5):
        det.start()
        t[0] += 1.0  # steady 1s steps
        assert det.stop(i) is None
    det.start()
    t[0] += 10.0  # 10x slower
    ev = det.stop(5)
    assert ev is not None and ev.elapsed == 10.0 and ev.median == 1.0


def test_straggler_window_bounds_the_median():
    t = [0.0]
    det = StragglerDetector(factor=3.0, window=4, warmup=2, clock=lambda: t[0])
    for i, dt in enumerate([8.0, 8.0, 8.0, 1.0, 1.0, 1.0, 1.0]):
        det.start()
        t[0] += dt
        det.stop(i)
    assert det.times == [1.0, 1.0, 1.0, 1.0]
    det.start()
    t[0] += 4.0  # 4x the current median of 1.0 -> fires
    assert det.stop(99) is not None


# ---------------------------------------------------------------------------
# supervisor
# ---------------------------------------------------------------------------


def make_step():
    def step(state, batch):
        w = state["w"] + batch["tokens"].sum()
        return {"w": w}, {"loss": w.sum()}

    return step


def injector_at(*steps):
    crashes = set(steps)

    def injector(step):
        if step in crashes:
            crashes.discard(step)
            raise RuntimeError(f"injected failure at {step}")

    return injector


def test_supervisor_restart_recovers_and_is_deterministic(tmp_path):
    """A steady fake clock (one tick per reading) keeps straggler events
    out, so the events are exactly the two restarts."""
    state0 = {"w": torch.tensor(0.0)}
    sup1 = Supervisor(make_step(), data().batch_at, CheckpointManager(tmp_path / "a"),
                      SupervisorConfig(checkpoint_every=5))
    clean, _ = sup1.run(state0, 0, 20)
    sup2 = Supervisor(make_step(), data().batch_at, CheckpointManager(tmp_path / "b"),
                      SupervisorConfig(checkpoint_every=5), clock=itertools.count().__next__)
    faulty, hist = sup2.run(state0, 0, 20, fail_injector=injector_at(7, 13))
    assert float(clean["w"]) == float(faulty["w"])
    assert [e["kind"] for e in sup2.events] == ["restart", "restart"]
    assert [e["step"] for e in sup2.events] == [7, 13]
    assert [h["step"] for h in hist] == list(range(20))  # no duplicates from the replays
    assert all(isinstance(h["loss"], float) for h in hist)


def test_supervisor_restart_budget(tmp_path):
    def injector(step):
        raise RuntimeError("always broken")

    sup = Supervisor(make_step(), data(8).batch_at, CheckpointManager(tmp_path),
                     SupervisorConfig(max_restarts=2))
    with pytest.raises(RuntimeError, match="restart budget"):
        sup.run({"w": torch.tensor(0.0)}, 0, 5, fail_injector=injector)


def test_supervisor_does_not_catch_what_is_not_recoverable(tmp_path):
    def injector(step):
        raise KeyError("a bug, not a fault")

    sup = Supervisor(make_step(), data(8).batch_at, CheckpointManager(tmp_path))
    with pytest.raises(KeyError):
        sup.run({"w": torch.tensor(0.0)}, 0, 5, fail_injector=injector)
    assert sup.events == []


def test_supervisor_config_is_per_instance(tmp_path):
    mgr = CheckpointManager(tmp_path)
    a = Supervisor(make_step(), data(8).batch_at, mgr)
    b = Supervisor(make_step(), data(8).batch_at, mgr)
    assert a.config is not b.config
    a.config.max_restarts = 99
    assert b.config.max_restarts == SupervisorConfig().max_restarts


def test_straggler_window_and_warmup_plumbed_from_config(tmp_path):
    sup = Supervisor(make_step(), data(8).batch_at, CheckpointManager(tmp_path),
                     SupervisorConfig(straggler_factor=2.5, straggler_window=5,
                                      straggler_warmup=2))
    assert (sup.detector.factor, sup.detector.window, sup.detector.warmup) == (2.5, 5, 2)


def test_restart_budget_resets_after_clean_streak(tmp_path):
    cfg = SupervisorConfig(checkpoint_every=2, max_restarts=1, restart_reset_after=3)
    sup = Supervisor(make_step(), data(8).batch_at, CheckpointManager(tmp_path / "reset"), cfg)
    _, history = sup.run({"w": torch.tensor(0.0)}, 0, 20, fail_injector=injector_at(5, 15))
    assert [h["step"] for h in history] == list(range(20))
    assert any(e["kind"] == "budget_reset" for e in sup.events)
    legacy = SupervisorConfig(checkpoint_every=2, max_restarts=1, restart_reset_after=None)
    sup2 = Supervisor(make_step(), data(8).batch_at, CheckpointManager(tmp_path / "legacy"),
                      legacy)
    with pytest.raises(RuntimeError, match="restart budget"):
        sup2.run({"w": torch.tensor(0.0)}, 0, 20, fail_injector=injector_at(5, 15))


def test_supervisor_restores_onto_its_device(tmp_path):
    seen = []

    class Recording(CheckpointManager):
        def restore(self, like, step=None, device=None):
            seen.append(device)
            return super().restore(like, step, device)

    sup = Supervisor(make_step(), data(8).batch_at, Recording(tmp_path),
                     SupervisorConfig(checkpoint_every=2), device=CPU)
    sup.run({"w": torch.tensor(0.0)}, 0, 6, fail_injector=injector_at(3))
    assert seen == [CPU]


def test_to_float_takes_scalar_tensors_only():
    out = to_float({"a": torch.tensor(2.5), "b": torch.tensor([1.0, 2.0]), "c": 3, "d": "x"})
    assert out["a"] == 2.5 and isinstance(out["a"], float) and out["c"] == 3.0
    assert torch.equal(out["b"], torch.tensor([1.0, 2.0])) and out["d"] == "x"

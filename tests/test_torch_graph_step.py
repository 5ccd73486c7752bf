"""The graphed train step (``repro_torch.train.graph``) on the CPU.

On the CPU ``GraphedStep`` captures nothing: each call runs the step's body
eagerly through the static state and the per-signature static batch, so
these tests hold the protocol a CUDA graph relies on. The wrapper against
the eager ``make_train_step`` (bit for bit) and against the reference's
jitted step (the tolerances of ``tests/test_torch_train.py``); every state
leaf keeping its storage across steps and across a supervisor restore;
and one step of each family's smoke config running no op that reads the
device from the host or sizes its output by the data, which a capture
cannot hold.
"""

import dataclasses
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.configs import get_arch as jget_arch
from repro.data.pipeline import DataConfig as JDataConfig, SyntheticTokens as JSyntheticTokens
from repro.train import optimizer as jopt
from repro.train.step import init_state as jinit_state, make_train_step as jmake_train_step
from repro_torch.ckpt.checkpoint import CheckpointManager
from repro_torch.configs import get_arch
from repro_torch.data.pipeline import DataConfig, SyntheticTokens
from repro_torch.ft.supervisor import Supervisor, SupervisorConfig
from repro_torch.launch import train
from repro_torch.models import transformer as T
from repro_torch.models.api import family_of
from repro_torch.train import optimizer as opt
from repro_torch.train.graph import GraphedStep, signature
from repro_torch.train.step import TrainState, init_state, make_train_step
from repro_torch.tree import leaves
from repro_torch.utils import tracing

CPU = "cpu"
SMOKE = get_arch("smollm-135m").smoke


def fresh(cfg=SMOKE, seed=0):
    adamw = opt.AdamWConfig(lr=1e-3)
    return adamw, init_state(cfg, adamw, torch.Generator().manual_seed(seed), CPU)


def pipeline(cfg, seq_len=32, batch=4, buckets=(1.0,)):
    fam = family_of(cfg).name
    return SyntheticTokens(DataConfig(
        vocab=cfg.vocab, seq_len=seq_len, global_batch=batch, buckets=buckets,
        patch_dim=cfg.d_model if fam == "vlm" else None,
        frame_dim=cfg.d_model if fam == "audio" else None), CPU)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Smoke-size steps run fastest on one intra-op thread, and so do the
    five other test workers beside this one; restored afterwards."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def same(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b)


# ---------------------------------------------------------------------------
# (a) against the eager step and the reference's jitted step
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("buckets,microbatches", [((1.0, 0.5), 1), ((1.0,), 2)],
                         ids=["buckets", "microbatches"])
def test_graphed_step_is_the_eager_step_bit_for_bit(buckets, microbatches):
    """Six steps from one seed: every loss and every state leaf equal bit
    for bit to the eager step's; the wrapper hands back its first state on
    every call, with each leaf in its first storage, and keeps one static
    batch per signature (two length buckets give two)."""
    adamw, eager_state = fresh()
    _, state = fresh()
    eager = make_train_step(SMOKE, adamw, microbatches=microbatches)
    graphed = GraphedStep(make_train_step(SMOKE, adamw, microbatches=microbatches), CPU)
    data = pipeline(SMOKE, buckets=buckets)
    first, ptrs = state, [t.data_ptr() for t in leaves(state)]
    for i in range(6):
        eager_state, em = eager(eager_state, data.batch_at(i))
        state, m = graphed(state, data.batch_at(i))
        assert state is first and [t.data_ptr() for t in leaves(state)] == ptrs
        assert m.keys() == em.keys() and all(same(m[k], em[k]) for k in m)
    for a, b in zip(leaves(state), leaves(eager_state), strict=True):
        assert same(a, b)
    assert int(state.step) == 6 and int(state.opt.count) == 6
    assert graphed.signatures == len(buckets) and graphed.captured == 0


@pytest.mark.parametrize("dtype,steps,rtol", [("float32", 10, 1e-4), ("bfloat16", 6, 2.0**-8)])
def test_graphed_step_loss_curve_matches_reference(dtype, steps, rtol):
    """The wrapped step against the unsharded, jitted reference step from
    the same weights on the same batches, at the tolerances of
    ``tests/test_torch_train.py``: rtol 1e-4 in float32 (summation order),
    one bf16 rounding (2^-8) in the full config's working types."""
    jcfg, cfg = jget_arch("smollm-135m").smoke, SMOKE
    if dtype == "bfloat16":
        jcfg = dataclasses.replace(jcfg, dtype=jnp.bfloat16, remat=True)
        cfg = dataclasses.replace(cfg, dtype=torch.bfloat16, remat=True)
    jadamw, adamw = jopt.AdamWConfig(lr=1e-3), opt.AdamWConfig(lr=1e-3)
    jstate = jinit_state(jcfg, jadamw, jax.random.PRNGKey(1))
    params = T.params_from_jax_numpy(cfg, jax.tree.map(np.asarray, jstate.params), device=CPU)
    state = TrainState(params, opt.init(adamw, params), torch.zeros((), dtype=torch.int32))
    jstep = jax.jit(jmake_train_step(jcfg, jadamw), donate_argnums=(0,))
    step = GraphedStep(make_train_step(cfg, adamw), CPU)
    kw = dict(vocab=cfg.vocab, seq_len=32, global_batch=4, seed=0)
    jdata, data = JSyntheticTokens(JDataConfig(**kw)), SyntheticTokens(DataConfig(**kw), CPU)
    jl, tl = [], []
    for i in range(steps):
        jstate, jm = jstep(jstate, jdata.batch_at(i))
        state, m = step(state, data.batch_at(i))
        jl.append(float(jm["loss"]))
        tl.append(float(m["loss"]))
    np.testing.assert_allclose(tl, jl, rtol=rtol)
    assert int(state.step) == steps


# ---------------------------------------------------------------------------
# (b) storage identity across steps and a supervisor restore
# ---------------------------------------------------------------------------


class Recorded(CheckpointManager):
    """Keeps a copy of every state it saves and holds each restore to it."""

    def __init__(self, directory):
        super().__init__(directory)
        self.saved, self.restored = {}, []

    def save_async(self, step, tree):
        self.saved[step] = [t.clone() for t in leaves(tree)]
        super().save_async(step, tree)

    def restore(self, like, step=None, device=None):
        out = super().restore(like, step, device)
        assert all(same(a, b) for a, b in zip(leaves(out), self.saved[step], strict=True))
        self.restored.append(step)
        return out


def supervised(tmp_path, name, fail_at=None):
    """Ten supervised steps of the wrapped step, checkpoints every 3, an
    optional fault; every call's static leaves' storage is recorded, and a
    state the supervisor re-enters with is held bit-exact after ``load``.
    The supervisor reads a steady fake clock (one tick per reading): on the
    wall clock a step slowed 3x by busy neighbours or the background
    checkpoint writes logs a straggler event, which the event checks would
    take for a fault."""
    adamw, state = fresh()
    graphed = GraphedStep(make_train_step(SMOKE, adamw), CPU)
    ptrs, loads = [], []

    def step(state, batch):
        if graphed.state is not None and state is not graphed.state:
            want = [t.clone() for t in leaves(state)]
            state = graphed.load(state)
            assert all(same(a, b) for a, b in zip(leaves(state), want, strict=True))
            loads.append(int(state.step))
        state, m = graphed(state, batch)
        ptrs.append([t.data_ptr() for t in leaves(state)])
        return state, m

    ckpt = Recorded(tmp_path / name)
    sup = Supervisor(step, pipeline(SMOKE).batch_at, ckpt, SupervisorConfig(checkpoint_every=3),
                     clock=itertools.count().__next__)

    def inject(i):
        if i == fail_at and not inject.fired:
            inject.fired = True
            raise RuntimeError(f"injected failure at step {i}")

    inject.fired = fail_at is None
    final, history = sup.run(state, 0, 10, fail_injector=inject)
    assert inject.fired
    return final, history, sup.events, ckpt.restored, loads, ptrs


def test_state_keeps_its_storage_across_steps_and_a_restore(tmp_path):
    """A fault at step 7 restores step 6: the restored state is bit-exact
    when it reaches the static leaves, every leaf keeps the storage it had
    at the first step throughout, and the history equals the unfaulted
    run's loss for loss."""
    clean, clean_hist, events, _, _, _ = supervised(tmp_path, "clean")
    assert events == []
    final, hist, events, restored, loads, ptrs = supervised(tmp_path, "faulted", fail_at=7)
    assert [(e["kind"], e["step"]) for e in events] == [("restart", 7)]
    assert restored == [6] and loads == [6]
    assert all(p == ptrs[0] for p in ptrs) and len(ptrs) == 11  # 10 steps + 1 replayed
    assert hist == clean_hist
    for a, b in zip(leaves(final), leaves(clean), strict=True):
        assert same(a, b)


def test_metrics_are_the_callers():
    """Each call's metrics are its own tensors: the next call leaves them
    as they were."""
    adamw, state = fresh()
    step = GraphedStep(make_train_step(SMOKE, adamw), CPU)
    data = pipeline(SMOKE)
    state, m1 = step(state, data.batch_at(0))
    loss1 = float(m1["loss"])
    state, m2 = step(state, data.batch_at(1))
    state, m3 = step(state, data.batch_at(2))
    assert m1["loss"] is not m2["loss"] and m2["loss"] is not m3["loss"]
    assert float(m1["loss"]) == loss1 and float(m2["loss"]) != float(m3["loss"])


def test_signature_and_restore_checks():
    """A signature keys on shapes and dtypes, not values; a state whose
    leaves do not match the static ones is refused."""
    data = pipeline(SMOKE, buckets=(1.0, 0.5))
    assert signature(data.batch_at(0)) == signature(data.batch_at(2))
    assert signature(data.batch_at(0)) != signature(data.batch_at(1))
    adamw, state = fresh()
    step = GraphedStep(make_train_step(SMOKE, adamw), CPU)
    step(state, data.batch_at(0))
    bad = state._replace(step=torch.zeros((), dtype=torch.int64))
    with pytest.raises(ValueError, match="does not match"):
        step.load(bad)


@pytest.mark.parametrize("microbatches", [1, 2])
def test_eager_phases_are_recorded_in_order(microbatches):
    """On the CPU each call runs the body eagerly: with tracing on, its
    phases are host spans under the three names, in order (forward and
    backward once a microbatch), inside no other span; nothing is held for
    the device."""
    adamw, state = fresh()
    step = GraphedStep(make_train_step(SMOKE, adamw, microbatches=microbatches), CPU)
    data = pipeline(SMOKE)
    tracing.reset()
    tracing.enable()
    try:
        for i in range(2):
            state, _ = step(state, data.batch_at(i))
    finally:
        tracing.disable()
    snap = tracing.snapshot()
    tracing.reset()
    one = ["train.forward", "train.backward"] * microbatches + ["train.optimizer"]
    assert [s.name for s in snap["spans"]] == one * 2
    assert all(s.parent == -1 for s in snap["spans"])
    assert "graph.replay" not in snap["names"]
    assert all(v["device_ms"] == 0.0 for v in snap["names"].values())


def test_launcher_runs_through_the_graphed_step(tmp_path):
    """``launch/train.py`` on the CPU: one signature, nothing captured."""
    result, state = train.run(train.parse_args([
        "--arch", "smollm-135m", "--smoke", "--steps", "4", "--batch", "2", "--seq", "32",
        "--device", "cpu", "--ckpt-dir", str(tmp_path)]))
    assert result["signatures"] == 1 and result["graphs"] == 0
    assert int(state.step) == 4


# ---------------------------------------------------------------------------
# (c) capture safety: no host read, no data-dependent shape
# ---------------------------------------------------------------------------


class HostReads(TorchDispatchMode):
    """Records every op that waits for the device to hand a value to the
    host, or sizes its output from the data."""

    def __init__(self):
        super().__init__()
        self.found = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = func.overloadpacket.__name__
        if (name in ("_local_scalar_dense", "item", "nonzero", "masked_select", "is_nonzero")
                or name.lstrip("_").startswith("unique")
                or (name == "repeat_interleave" and func._overloadname != "self_int"
                    and kwargs.get("output_size") is None)):
            self.found.append(str(func))
        return func(*args, **kwargs)


FAMILY_ARCHS = ("smollm-135m", "dbrx-132b", "paligemma-3b", "zamba2-1.2b", "rwkv6-7b",
                "whisper-medium")


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_train_step_is_capture_safe(arch):
    """One step of each family's smoke config (dense, moe, vlm, hybrid, ssm,
    audio), forward, backward and AdamW, runs none of those ops; the moe
    step's load-balancing counts compare with the expert ids instead of
    ``one_hot``, whose range check reads the device."""
    cfg = get_arch(arch).smoke
    assert family_of(cfg).name == ("dense", "moe", "vlm", "hybrid", "ssm",
                                   "audio")[FAMILY_ARCHS.index(arch)]
    adamw, state = fresh(cfg)
    step = make_train_step(cfg, adamw)
    batch = pipeline(cfg, seq_len=32, batch=2).batch_at(0)
    with HostReads() as mode:
        state, m = step(state, batch)
    assert mode.found == [], sorted(set(mode.found))
    assert np.isfinite(float(m["loss"]))

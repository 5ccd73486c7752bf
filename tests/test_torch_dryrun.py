"""Port parity: the dry run's shapes, cost model and per-device statistics.

The reference's input specs, cells, model FLOPs and roofline report are
computed in this process (``jax.eval_shape``: no device work). Its
compiled per-device argument bytes come from a subprocess that imports
``repro.launch.dryrun`` (which forces 512 host devices): the production
cells of smollm-135m through its own ``run_cell`` on ``make_production_mesh``
(where train and prefill stop at the Explicit axes: ROADMAP queue C),
and one smoke cell per family and kind on a (2, 2) ``Mesh`` built from the
device array (Auto axes). JAX prunes the arguments a program never reads
(``keep_unused=False``), which a device still holds; the port counts every
argument, so those cells are compiled with ``keep_unused=True``. The
port's side traces on ``fake`` process groups in this process; the sharded
decode steps run on four spawned ``gloo`` ranks.
"""

import dataclasses
import json
import os
import pickle
import subprocess
import sys
import textwrap
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from _torch_ranks import dryrun_job, run_ranks

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: one architecture per family for the smoke cells
FAMILY_ARCHS = ("starcoder2-15b", "dbrx-132b", "paligemma-3b", "zamba2-1.2b", "rwkv6-7b",
                "whisper-medium")
KINDS = ("train", "prefill", "decode")
#: the decode steps held sharded against unsharded: the dense model's
#: (which moe and vlm share), and hybrid's and audio's own
DECODE_ARCHS = ["starcoder2-15b", "zamba2-1.2b", "whisper-medium", "dbrx-132b"]
SMOKE_SEQ, SMOKE_BATCH = 64, 4
#: the reference's argument bytes for smollm-135m decode_32k on pod16x16:
#: the whole KV cache is replicated, since batch 128 does not split 256 ways
SMOLLM_DECODE_ARGS = 96_905_795_200

REFERENCE = """
import functools, pickle, sys
import jax, numpy as np
from jax.sharding import Mesh
from repro.configs import ARCHS
from repro.configs.shapes import ShapeSpec
from repro.launch import dryrun as D  # forces 512 host devices

archs, kinds, seq, batch = sys.argv[2].split(","), sys.argv[3].split(","), *map(int, sys.argv[4:6])
out = {"production": {}, "smoke": {}, "pruned": {}}
for shape in ("train_4k", "prefill_32k", "decode_32k"):
    try:
        rec = D.run_cell("smollm-135m", shape, False, None)
        out["production"][shape] = {"status": rec["status"],
                                    "args": rec["memory_analysis"]["argument_size_in_bytes"]}
    except Exception as e:
        out["production"][shape] = {"status": "fail", "error": type(e).__name__,
                                    "message": str(e)}
mesh = Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("data", "model"))

def args_bytes(arch, kind):
    e = ARCHS[arch]
    with mesh:
        lowered = D.LOWER[kind](e, e.smoke, ShapeSpec("s", seq, batch, kind), mesh)
    return int(lowered.compile().memory_analysis().argument_size_in_bytes)

for kind in ("prefill", "decode"):
    out["pruned"][kind] = args_bytes("whisper-medium", kind)
D.jax.jit = functools.partial(jax.jit, keep_unused=True)
for arch in archs:
    for kind in kinds:
        out["smoke"][(arch, kind)] = args_bytes(arch, kind)
pickle.dump(out, open(sys.argv[1], "wb"))
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(the reference's results, the port's smoke records, the ranks'
    sharded decode results); the reference runs beside the port."""
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.configs import get_arch
    from repro_torch.configs.shapes import ShapeSpec
    from repro_torch.launch import dryrun as D

    tmp = tmp_path_factory.mktemp("dryrun")
    ref_path = tmp / "reference.pkl"
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"), JAX_PLATFORMS="cpu")
    proc = subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(REFERENCE), str(ref_path), ",".join(FAMILY_ARCHS),
         ",".join(KINDS), str(SMOKE_SEQ), str(SMOKE_BATCH)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    with ThreadPoolExecutor(1) as pool:  # the ranks are processes of their own
        ranks = pool.submit(run_ranks, dryrun_job, 4, tmp, DECODE_ARCHS)
        port = {}
        D.fake_group(4)
        try:
            mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
            for arch in FAMILY_ARCHS + ("smollm-135m",):
                entry = get_arch(arch)
                for kind in KINDS if arch != "smollm-135m" else ("train",):
                    shape = ShapeSpec("s", SMOKE_SEQ, SMOKE_BATCH, kind)
                    port[(arch, kind)] = D.trace_cell(entry, entry.smoke, shape, mesh)
        finally:
            dist.destroy_process_group()
        ranks = ranks.result()
    _, err = proc.communicate(timeout=600)
    assert proc.returncode == 0, err[-4000:]
    with open(ref_path, "rb") as f:
        ref = pickle.load(f)
    return ref, port, ranks


# ---------------------------------------------------------------------------
# shapes and cells
# ---------------------------------------------------------------------------


def test_cells_match_reference():
    from repro.configs import cells as ref_cells
    from repro_torch.configs import cells

    assert cells() == ref_cells()
    assert len(cells()) == 40


def _spec(x):
    return tuple(x.shape), str(x.dtype).replace("torch.", "")


@pytest.mark.parametrize("arch", ["starcoder2-15b", "h2o-danube-3-4b", "internlm2-20b",
                                  "smollm-135m", "zamba2-1.2b", "paligemma-3b", "rwkv6-7b",
                                  "dbrx-132b", "grok-1-314b", "whisper-medium"])
def test_input_specs_match_reference(arch):
    """Shapes and dtypes of every model input and cache leaf, all four shapes."""
    from repro.configs import get_arch as ref_arch
    from repro.configs import shapes as RS
    from repro_torch.configs import SHAPES, get_arch
    from repro_torch.configs import shapes as S

    cfg, ref_cfg = get_arch(arch).full, ref_arch(arch).full
    for name, shape in SHAPES.items():
        rshape = RS.SHAPES[name]
        assert dataclasses.asdict(shape) == dataclasses.asdict(rshape)
        for port, ref in ((S.token_batch_specs(cfg, shape), RS.token_batch_specs(ref_cfg, rshape)),
                          (S.cache_specs(cfg, shape), RS.cache_specs(ref_cfg, rshape))):
            assert {k: _spec(v) for k, v in port.items()} == \
                {k: _spec(v) for k, v in ref.items()}, (arch, name)
            assert all(v.device.type == "meta" for v in port.values())
        assert _spec(S.decode_token_specs(shape)) == _spec(RS.decode_token_specs(rshape))
    assert S.supports_long_context(cfg) == RS.supports_long_context(ref_cfg)
    assert S.AUDIO_DEC_FRACTION == RS.AUDIO_DEC_FRACTION


def test_model_flops_match_reference_on_every_cell():
    from repro.configs import get_arch as ref_arch
    from repro.utils.roofline import model_flops as ref_flops
    from repro_torch.configs import SHAPES, cells, get_arch
    from repro_torch.utils.roofline import model_flops

    for arch, name, _ in cells():
        s = SHAPES[name]
        assert model_flops(get_arch(arch).full, s.kind, s.seq_len, s.global_batch) == \
            ref_flops(ref_arch(arch).full, s.kind, s.seq_len, s.global_batch), (arch, name)


def test_roofline_report_on_h100_constants():
    """A hand-made record: each term is its quantity over the H100's
    datasheet rate (989 TFLOP/s bf16, 3.35 TB/s HBM, 50 GB/s link)."""
    from repro.utils.roofline import RooflineReport as RefReport
    from repro_torch.utils import roofline as R

    assert (R.PEAK_FLOPS, R.HBM_BW, R.LINK_BW) == (989e12, 3.35e12, 50e9)
    kw = dict(arch="a", shape="s", mesh="m", kind="train", flops_per_device=989e12,
              bytes_per_device=2 * 3.35e12, collective_bytes_per_device=0.5 * 50e9,
              model_flops=0.25 * 989e12 * 4, n_devices=4)
    rep = R.RooflineReport(**kw)
    assert (rep.t_compute, rep.t_memory, rep.t_collective) == pytest.approx((1.0, 2.0, 0.5))
    assert rep.bottleneck == "memory"
    assert rep.step_time_lower_bound == pytest.approx(2.0)
    assert rep.useful_flops_fraction == pytest.approx(0.25)
    assert rep.roofline_fraction == pytest.approx(0.125)
    assert rep.to_dict().keys() == RefReport(**kw).to_dict().keys()


# ---------------------------------------------------------------------------
# opstats
# ---------------------------------------------------------------------------


def test_opstats_tanh_scan_matches_hlo_walker():
    """The 12-layer ``tanh(h @ w)`` scan of ``tests/test_integration.py``:
    the port's eager count equals the reference's walk of the compiled HLO
    less the scan's own loop counter (one s32 add in the body and one
    compare in the condition per trip, 24 flops), which a Python loop does
    not run on the device; on the CPU and on meta tensors alike."""
    from repro.utils.hlo import analyze as hlo_analyze
    from repro_torch.utils import opstats

    def f(x, ws):
        return jax.lax.scan(lambda h, w: (jnp.tanh(h @ w), None), x, ws)[0]

    ref = hlo_analyze(jax.jit(f).lower(jnp.ones((8, 32)), jnp.ones((12, 32, 32)))
                      .compile().as_text())

    def g(x, ws):
        for w in ws:
            x = torch.tanh(x @ w)
        return x

    for device in ("cpu", "meta"):
        st = opstats.analyze(g, torch.ones(8, 32, device=device),
                             torch.ones(12, 32, 32, device=device))
        assert st.flops == ref.flops - 2 * 12
        assert st.dot_flops == 12 * 2 * 8 * 32 * 32
        assert st.collectives == ref.collectives == {}


def test_fake_process_group_is_available():
    """The dry run's group comes from a private module of torch's tests:
    guard its import and the ``fake`` backend."""
    from torch.testing._internal.distributed.fake_pg import FakeStore  # noqa: F401

    assert "fake" in dist.Backend.backend_list


def test_opstats_counts_a_functional_all_reduce_on_a_fake_group():
    import torch.distributed._functional_collectives as funcol

    from repro_torch.launch.dryrun import fake_group
    from repro_torch.utils import opstats

    fake_group(4)
    try:
        st = opstats.analyze(lambda x: funcol.all_reduce(x, "sum", dist.group.WORLD).wait(),
                             torch.ones(8, 16))
    finally:
        dist.destroy_process_group()
    assert st.collectives == {"all-reduce": {"count": 1.0, "bytes": 512.0}}
    assert st.collective_bytes == 512.0


def test_opstats_tracks_the_live_high_water_mark():
    """Three 4 KiB results, at most two alive at once; views and in-place
    results allocate nothing."""
    from repro_torch.utils import opstats

    def f(x):
        a = x * 2
        b = a + 1
        del a
        b.add_(1)
        c = b.view(32, 32) * 3
        return c.t()

    for device in ("cpu", "meta"):
        st = opstats.analyze(f, torch.ones(1024, device=device))
        assert st.temp_peak_bytes == 2 * 4096
        assert st.temp_at_peak == {"before_backward": 8192, "backward": 0, "after_backward": 0}


# ---------------------------------------------------------------------------
# the dry run against the reference
# ---------------------------------------------------------------------------


def test_reference_production_cells(runs):
    """ROADMAP queue C: on ``make_production_mesh`` (Explicit axes) the
    reference's dry run stops train at its sharder's
    ``with_sharding_constraint``, which takes Auto axes only, and prefill at
    the cache's ``dynamic_update_slice`` (operand replicated, update split
    over the Explicit batch axes); its decode_32k replicates smollm's 96.6
    GB KV cache on every device (batch 128 does not split 256 ways), more
    than one H100 holds."""
    prod = runs[0]["production"]
    assert prod["train_4k"]["status"] == "fail" and prod["train_4k"]["error"] == "ValueError"
    assert "can only refer to Auto axes" in prod["train_4k"]["message"]
    assert prod["prefill_32k"]["error"] == "ShardingTypeError"
    assert "dynamic_update_slice operand sharding" in prod["prefill_32k"]["message"]
    assert prod["decode_32k"] == {"status": "ok", "args": SMOLLM_DECODE_ARGS}


def test_smollm_decode_32k_argument_bytes_on_pod16x16(tmp_path):
    """The command line on the production mesh: a record with the H100
    roofline, the reference's exact argument bytes, and no group left."""
    from repro_torch.launch import dryrun as D

    assert D.main(["--arch", "smollm-135m", "--shape", "decode_32k", "--out", str(tmp_path)]) == 0
    rec = json.loads((tmp_path / "pod16x16" / "smollm-135m__decode_32k.json").read_text())
    assert rec["status"] == "ok" and rec["n_devices"] == 256
    assert rec["memory_analysis"]["argument_size_in_bytes"] == SMOLLM_DECODE_ARGS
    assert rec["peak_memory_per_device"] > SMOLLM_DECODE_ARGS
    assert set(rec["roofline"]) == {"t_compute", "t_memory", "t_collective", "bottleneck",
                                    "useful_flops_fraction", "roofline_fraction"}
    assert rec["roofline"]["t_memory"] == rec["bytes_per_device"] / 3.35e12
    assert not dist.is_initialized()


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
@pytest.mark.parametrize("kind", KINDS)
def test_smoke_argument_bytes_match_reference(runs, arch, kind):
    ref, port, _ = runs
    assert port[(arch, kind)]["memory_analysis"]["argument_size_in_bytes"] == \
        ref["smoke"][(arch, kind)]


def test_reference_prunes_arguments_it_never_reads(runs):
    """Compiled as it ships, the reference drops whisper's prefill cache
    states it overwrites and, in decode, the encoder's weights: the device
    still holds them, and the port counts them."""
    ref, port, _ = runs
    for kind in ("prefill", "decode"):
        assert ref["pruned"][kind] < ref["smoke"][("whisper-medium", kind)]


def test_smollm_dot_flops_per_device_times_four_is_the_one_rank_count(runs):
    """smollm runs pure data-parallel: each of the 4 ranks holds a quarter
    of the batch, so 4 x its matmul FLOPs are the one-rank step's."""
    from repro_torch.configs import get_arch
    from repro_torch.data.pipeline import DataConfig, SyntheticTokens
    from repro_torch.launch import dryrun as D

    entry = get_arch("smollm-135m")
    batch = SyntheticTokens(DataConfig(vocab=entry.smoke.vocab, seq_len=SMOKE_SEQ,
                                       global_batch=SMOKE_BATCH), "cpu").batch_at(0)
    one = D.trace_one_rank(entry.smoke, batch, D._adamw_for(entry), entry.microbatches)
    assert 4 * runs[1][("smollm-135m", "train")]["dot_flops_per_device"] == \
        one["dot_flops_per_device"]


def test_sharded_traces_count_collectives_and_sites(runs):
    """Tensor-parallel cells move data between ranks; pure data-parallel
    smollm only all-reduces its gradients."""
    port = runs[1]
    assert set(port[("smollm-135m", "train")]["collectives"]) == {"all-reduce"}
    for arch in FAMILY_ARCHS:
        rec = port[(arch, "train")]
        assert rec["collective_bytes_per_device"] > 0
        assert rec["peak_memory_per_device"] == \
            rec["memory_analysis"]["argument_size_in_bytes"] + \
            rec["memory_analysis"]["temp_size_in_bytes"]
    assert "site:cache write" in port[("starcoder2-15b", "decode")]["fallbacks"]


@pytest.mark.parametrize("arch", DECODE_ARCHS)
def test_sharded_decode_matches_unsharded(runs, arch):
    """The decode step with its cache split over batch and sequence on four
    gloo ranks (each rank writes the new K/V into its own block): logits
    and every cache leaf within 1e-5 of the unsharded step (f32; the new
    K/V come from sharded products, summed in another order)."""
    for rank in runs[2]:
        r = rank["decode"][arch]
        assert r["logits"] <= 1e-5 * r["logits_max"] and r["cache"] <= 1e-5, r
        assert "cache write" in r["sites"]
        assert any("model" in str(s) for s in r["cache_specs"])


def test_gradient_split_inside_a_head_matches_unsharded(runs):
    """Attention projections split inside a head (2 heads of 32 over a
    4-wide model axis, as paligemma-3b's 8 heads on 16 ranks): the merged
    heads' gradient is laid out as the merged activation was, so the step
    runs, and every gradient leaf is within 1e-5 of the unsharded one
    (f32, relative to each leaf's largest entry)."""
    for rank in runs[2]:
        r = rank["heads"]
        assert r["grad_rel"] <= 1e-5, r
        assert "heads reshape" in r["sites"]


# ---------------------------------------------------------------------------
# the one-rank step: meta prediction against a real step
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["smollm-135m", "zamba2-1.2b"])
def test_validate_on_the_cpu(monkeypatch, arch):
    """``validate`` at the smoke config on the CPU: the FLOPs counted on the
    real step equal the meta count, and so do the live bytes' high-water
    marks; the argument bytes are the state's and the batch's."""
    from repro_torch.configs import get_arch
    from repro_torch.launch import dryrun as D

    entry = get_arch(arch)
    monkeypatch.setattr(D, "get_arch", lambda a: dataclasses.replace(entry, full=entry.smoke))
    out = D.validate(arch, batch=4, seq=32, device="cpu")
    assert out["card_flops"] == out["meta_flops"] > 0
    assert out["card_dot_flops"] == out["meta_dot_flops"]
    assert out["card_temp_bytes"] == out["predicted_temp_bytes"] > 0
    split = out["predicted_split"]
    assert sum(split.values()) == out["predicted_peak_bytes"]
    n_params = sum(int(np.prod(s)) for s in _param_shapes(entry.smoke))
    assert split["moments"] == 2 * 4 * n_params  # two float32 moments a parameter
    assert out["bound_ms"] > 0 and "device_busy_ms" not in out


def _param_shapes(cfg):
    from repro_torch.models.api import param_shapes
    from repro_torch.tree import leaves

    return [tuple(p.shape) for p in leaves(param_shapes(cfg))]


def test_validate_runs_on_the_card_unless_asked():
    from repro_torch.launch.dryrun import validate

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA was requested"):
        validate("smollm-135m")

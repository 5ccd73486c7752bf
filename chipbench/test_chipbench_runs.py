"""Whole runs of the harness at smoke size on the CPU: every kind of cell
through the harness's own entry, cells, a configuration and a metric added
from a temporary directory with no edit to any file, the references
against the program, and ``correct`` coming out false under the control
and under each planted fault."""

import contextlib
import io
import json
import time
from pathlib import Path

import pytest
import torch

import calibrate
import smoke
from harness import faults
from harness.main import run

CELLS = sorted(smoke.CELLS)
TRAIN_CELLS = [c for c in CELLS if smoke.TRAFFIC[smoke.CELLS[c][1]]["kind"] == "train"]
SEED = 3_000_000_019  # larger than 32 signed bits hold


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    torch.set_num_threads(2)
    return smoke.make_root(tmp_path_factory.mktemp("bench"))


def run_cell(root: Path, workload: str, trace: int = 0, seed: int = SEED, seconds=0.5):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = run(["--workload", workload, "--seed", str(seed), "--seconds", str(seconds),
                  "--trace", str(trace)], root, time.perf_counter(), device="cpu")
    assert rc == 0
    result = json.loads(out.getvalue().strip().splitlines()[-1])
    assert list(result)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(result)[-1] == "checks"
    return result


@pytest.mark.parametrize("workload", CELLS)
def test_each_kind_of_cell_runs_and_is_correct(root, workload):
    r = run_cell(root, workload)
    assert r["correct"] is True and r["failed"] == 0 and r["attempted"] > 0, r
    assert "setup_s" in r["metrics"] and len(r["metrics"]) >= 2
    traced = run_cell(root, workload, trace=1)
    assert traced["correct"] is True
    assert traced["metrics"], "a traced run reports per-layer metrics"
    assert not set(traced["metrics"]) & set(r["metrics"])


#: a reference added by a file alone, which sets aside the positions where
#: its two best logits lie within a margin: a stand-in for one that cannot
#: decide a token's expert routing
TIES_REFERENCE = '''"""The dense LM, with positions of a near-tie set aside."""

import torch

from . import dense_lm

MARGIN = 0.05


@torch.no_grad()
def logits(cfg, params, tokens, prec):
    out = dense_lm.logits(cfg, params, tokens, prec)
    two = out.topk(2, dim=-1).values
    return out, two[:, 0] - two[:, 1] < MARGIN
'''


def test_a_cell_config_and_metric_added_by_files_alone(root, tmp_path, monkeypatch):
    """The smoke cells and configurations already come from files added
    beside the checkout's; here a further metric is added too, and a
    configuration whose reference sets positions aside, with a cell that
    limits the share it sets aside."""
    import reference

    new = smoke.make_root(tmp_path)
    bench_dir = new / "chipbench"
    (bench_dir / "metrics" / "steps_in_window.py").write_text(
        "def read(record, profile):\n    return float(record['steps'])\n")
    (bench_dir / "reference" / "dense_lm_ties.py").write_text(TIES_REFERENCE)
    conf = {**smoke.CONFIGS["sc2-smoke"], "name": "sc2-smoke-ties", "reference": "dense_lm_ties"}
    (bench_dir / "configs" / "sc2-smoke-ties.json").write_text(json.dumps(conf))
    (bench_dir / "cells" / "sc2-smoke-ties.chat.json").write_text(json.dumps(
        {"limits": {**smoke.CELLS["sc2-smoke.chat"][2], "undecided_share": 0.5}}))
    bench = json.loads((new / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "sc2-smoke-ties", "source": "smoke",
                             "file": "chipbench/configs/sc2-smoke-ties.json", "reduced": [],
                             "why": "a reference that sets positions aside"})
    bench["workloads"].append({"name": "sc2-smoke-ties.chat", "config": "sc2-smoke-ties",
                               "traffic": "smoke_chat", "chips": 1, "why": "smoke size"})
    bench["per_layer"].append({"name": "steps_in_window", "unit": "count", "better": "higher",
                               "source": "program_counter", "layer": "engine",
                               "moves": "peak_reserved_gib",
                               "workloads": ["sc2-smoke.chat"]})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "sc2-smoke.chat" in m.get("workloads", []):
            m["workloads"].append("sc2-smoke-ties.chat")
    (new / "BENCHMARK.json").write_text(json.dumps(bench))
    r = run_cell(new, "sc2-smoke.chat", trace=1)
    assert r["metrics"]["steps_in_window"]["value"] > 0
    assert "undecided_share" not in r["checks"]
    # in a checkout the new file sits beside the others in reference/
    monkeypatch.setattr(reference, "__path__", [str(bench_dir / "reference"),
                                                *reference.__path__])
    r = run_cell(new, "sc2-smoke-ties.chat")
    assert r["correct"] is True, r["checks"]
    assert 0 <= r["checks"]["undecided_share"]["value"] <= 0.5
    assert list(r["checks"]) == ["logit_gap", "length_errors", "undecided_share"]


@pytest.mark.parametrize("workload", TRAIN_CELLS)
def test_the_reference_follows_the_program(root, workload):
    """The float32 reference against the program's bf16 step, leaf by
    leaf, within the smoke cell's limits; the control (the reference in
    fp8) fails at least one of them."""
    out = calibrate.main(["--workload", workload, "--seeds", "21,22", "--control", "21,22"],
                         root=root, device="cpu")
    limits = smoke.CELLS[workload][2]
    for line in out["program"]:
        assert all(line[k] <= v for k, v in limits.items()), line
    for line in out["control"]:
        assert any(line[k] > v for k, v in limits.items()), line


def test_the_chat_control_fails(root):
    out = calibrate.main(["--workload", "sc2-smoke.chat", "--seeds", "23", "--control", "23",
                          "--seconds", "0.5"], root=root, device="cpu")
    limit = smoke.CELLS["sc2-smoke.chat"][2]["logit_gap"]
    assert out["program"][0]["logit_gap"] <= limit < out["control"][0]["logit_gap"]


FAULTS = [(c, f) for c in TRAIN_CELLS for f in faults.TRAIN] + [
    ("sc2-smoke.chat", f) for f in faults.SERVE]


@pytest.mark.parametrize("workload,fault", FAULTS, ids=[f"{c}-{f}" for c, f in FAULTS])
def test_a_planted_fault_makes_correct_false(root, workload, fault):
    cell = smoke.CELLS[workload]
    conf, mix = smoke.CONFIGS[cell[0]], smoke.TRAFFIC[cell[1]]
    with faults.planted(fault, mix["kind"], conf["family"]):
        r = run_cell(root, workload)
    assert r["correct"] is False, r["checks"]


@pytest.mark.card
def test_a_real_cell_runs_on_the_card(tmp_path):
    """On the card: the chat cell's command, for a short window, prints a
    correct result line (``pytest chipbench -m card`` on a CUDA host)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import subprocess
    import sys

    here = Path(__file__).resolve().parent
    out = subprocess.run([sys.executable, str(here / "run.py"), "--workload",
                          "starcoder2-15b-4l.chat64", "--seed", str(SEED), "--seconds", "5",
                          "--trace", "0"], capture_output=True, text=True, timeout=600,
                         cwd=here.parent)
    assert out.returncode == 0, out.stderr[-3000:]
    assert json.loads(out.stdout.strip().splitlines()[-1])["correct"] is True


@pytest.mark.card
def test_a_moe_tree_draws_and_casts_within_the_card():
    """On the card: DBRX at 8 of its 40 layers with an untied head (27.31 B
    parameters, the tree of the MoE chat cell to come) drawn from a seed,
    then walked through the float32 view as a reference reads it, every
    stacked leaf's slice of a layer held at once, layer after layer. Both
    phases stay under the card's memory; their peaks are printed
    (``pytest chipbench -m card -s``)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import dataclasses
    from collections.abc import Mapping

    from repro_torch.configs import get_arch

    from harness import model, weights

    cfg = dataclasses.replace(get_arch("dbrx-132b").full, n_layers=8, tie_embeddings=False)
    shapes = model.param_shapes(cfg)
    dev = torch.device("cuda")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    w = weights.draw(shapes, SEED, dev, cfg.n_layers)
    torch.cuda.synchronize(dev)
    drawn = torch.cuda.max_memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)

    def stacked(tree):
        for v in tree.values():  # reading a leaf that is not stacked casts it
            if isinstance(v, Mapping):
                yield from stacked(v)
            elif isinstance(v, weights.Layers):
                yield v

    view = weights.OnDemand(w, cfg.n_layers)
    per_layer = list(stacked(view))
    for i in range(cfg.n_layers):
        held = [leaf[i] for leaf in per_layer]
        assert all(t.dtype == torch.float32 for t in held)
        del held
    torch.cuda.synchronize(dev)
    cast = torch.cuda.max_memory_allocated(dev)
    card = torch.cuda.get_device_properties(dev).total_memory
    print(json.dumps({"card": torch.cuda.get_device_name(dev),
                      "parameters": sum(t.numel() for _, t in weights.leaves(w)),
                      "weights_gib": weights.nbytes(w) / 2**30,
                      "draw_peak_gib": drawn / 2**30, "cast_peak_gib": cast / 2**30,
                      "card_gib": card / 2**30}))
    assert len(per_layer) == 10 and drawn < card and cast < card

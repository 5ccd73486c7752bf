"""The benchmark's definition: names, files, bounds and budget, the traffic
generator, and what the harness and the references import."""

import ast
import json
import math
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from harness import spec, traffic

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
WORD = re.compile(r"[A-Za-z0-9_.-]+")
PATH = re.compile(r"[A-Za-z0-9_./-]{1,200}")


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "chipbench/run.py"]
    assert BENCH["paths"] == ["chipbench"]
    assert all(PATH.fullmatch(p) and ".." not in p for p in BENCH["paths"])
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize("name", sorted(set(spec.Spec(ROOT).names())))
def test_every_name_is_legal(name):
    assert spec.NAME.fullmatch(name), name


def test_entries_have_just_the_contract_keys():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("chipbench/") and (ROOT / c["file"]).is_file()
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert spec.UNIT.fullmatch(m["unit"]) and m["better"] in ("lower", "higher")
    setup = [m for m in BENCH["end_to_end"] if m["name"] == "setup_s"]
    assert setup and setup[0]["bound"] <= 0.25


def test_every_name_resolves_to_its_files():
    s = spec.Spec(ROOT)
    for w in BENCH["workloads"]:
        cell = s.cell(w["name"])
        assert (HERE / "reference" / f"{cell.config['reference']}.py").is_file()
        assert cell.limits["limits"], w["name"]
        assert (HERE / "harness" / "kinds" / f"{cell.traffic['kind']}.py").is_file()
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert callable(s.reader(m["name"]).read), m["name"]


def test_every_cell_reports_enough():
    s = spec.Spec(ROOT)
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for w in BENCH["workloads"]:
        ends = {m["name"] for m in s.metrics(w["name"], trace=False)}
        assert "setup_s" in ends and len(ends) >= 2, w["name"]
        layers = s.metrics(w["name"], trace=True)
        assert layers, w["name"]
        for m in layers:  # a per-layer metric moves an end-to-end metric its cell reports
            assert m["moves"] in e2e and m["moves"] in ends, (w["name"], m["name"])
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        for w in m.get("workloads", []):
            assert w in {x["name"] for x in BENCH["workloads"]}


def test_run_seconds_fits_the_check_with_24_cells():
    rs = BENCH["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_at_most_a_quarter_of_cells_take_four_chips():
    four = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert four <= max(1, len(BENCH["workloads"]) // 4)


CHAT = json.loads((HERE / "traffic" / "chat64.json").read_text())


def _first(mix, seed, n):
    it = traffic.requests(mix, 49152, seed)
    return [next(it) for _ in range(n)]


def test_requests_are_a_function_of_the_seed():
    a, b = _first(CHAT, 3_000_000_017, 300), _first(CHAT, 3_000_000_017, 300)
    assert all((pa == pb).all() and oa == ob for (pa, oa), (pb, ob) in zip(a, b))
    c = _first(CHAT, 3_000_000_018, 300)
    assert all((pa != pc).any() for (pa, _), (pc, _) in zip(a, c))


def test_every_seed_serves_the_same_lengths_in_the_same_order():
    n = CHAT["block"]
    runs = [_first(CHAT, seed, 2 * n) for seed in (0, 7, 2**31 + 5)]
    for reqs in runs[1:]:
        assert [(len(p), o) for p, o in reqs] == [(len(p), o) for p, o in runs[0]]
    for k in range(2):
        block = runs[0][k * n:(k + 1) * n]
        assert sorted(len(p) for p, _ in block) == sorted(traffic.quantiles(CHAT["prompt"], n))
        assert sorted(o for _, o in block) == sorted(traffic.quantiles(CHAT["output"], n))
    p = np.array([len(p) for p, _ in runs[0][:n]], float)
    o = np.array([o for _, o in runs[0][:n]], float)
    assert abs(np.corrcoef(p, o)[0, 1]) < 0.05


def test_any_run_of_requests_holds_every_part_of_the_mix(monkeypatch):
    """64 consecutive requests, wherever they start (across two blocks
    too), hold 16 give or take 3 of each quarter of the sorted prompt
    lengths and of the outputs, whatever masks the blocks draw."""
    n = CHAT["block"]
    for order in (0, 5):
        monkeypatch.setattr(traffic, "ORDER_SEED", order)
        reqs = _first(CHAT, 1, 3 * n)
        for key, dist in ((lambda r: len(r[0]), "prompt"), (lambda r: r[1], "output")):
            q = traffic.quantiles(CHAT[dist], n)
            edges = q[[n // 4, n // 2, 3 * n // 4]]
            for start in range(0, 2 * n, 37):
                vals = np.array([key(r) for r in reqs[start:start + 64]])
                counts = np.bincount(np.searchsorted(edges, vals, side="right"), minlength=4)
                assert (abs(counts - 16) <= 3).all(), (order, dist, start, counts)


def test_blocks_pair_the_lengths_differently():
    n = CHAT["block"]
    reqs = _first(CHAT, 1, 4 * n)
    pairs = {(len(p), o) for p, o in reqs}
    assert len(pairs) > 3 * n, "each block pairs prompts and answers anew"


def test_chat_lengths_are_drawn_not_rounded():
    lengths = traffic.quantiles(CHAT["prompt"], CHAT["block"])
    assert 128 <= lengths.min() < 132 and 1000 < lengths.max() <= 1024
    primes = [x for x in lengths if x > 512 and all(x % d for d in range(2, int(x**0.5) + 1))]
    assert len(primes) == 3, "prime lengths above 512 keep their natural share, 3 of 64"
    assert (np.diff(np.log(lengths)) < 0.04).all()
    e = CHAT["engine"]
    assert CHAT["prompt"]["hi"] + CHAT["output"]["hi"] <= e["max_len"]
    assert CHAT["clients"] == e["max_batch"] == 64


def test_train_batches_are_a_function_of_the_seed():
    mix = {"batch": 2, "seq": 8, "frames": 4, "distinct_batches": 3}
    m = {"vocab": 100, "d_model": 6, "dtype": "bfloat16"}
    a = traffic.train_batches(mix, "audio", m, 11, "cpu")
    b = traffic.train_batches(mix, "audio", m, 11, "cpu")
    assert all(torch_equal(x[k], y[k]) for x, y in zip(a, b) for k in x)
    assert a[0]["tokens"].shape == (2, 9) and a[0]["frames"].shape == (2, 4, 6)
    assert not torch_equal(a[0]["tokens"], a[1]["tokens"])


def torch_equal(a, b):
    return bool((a == b).all())


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", sorted((HERE / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_references_import_nothing_of_the_program(path):
    tops = {m.split(".")[0] for m in _imports(path)}
    assert tops <= {"__future__", "contextlib", "math", "typing", "torch"}, tops


SCRIPT = """
import sys, time
sys.path[:0] = [{here!r}, {src!r}]
import smoke
from pathlib import Path
root = smoke.make_root(Path({tmp!r}))
from harness.main import run
import contextlib, io
out = io.StringIO()
with contextlib.redirect_stdout(out):
    rc = run(['--workload', 'sc2-smoke.chat', '--seed', '5', '--seconds', '0.5', '--trace', '0'],
             root, time.perf_counter(), device='cpu')
assert rc == 0, rc
import reference.dense_lm, reference.whisper, reference.train
print(sorted({{m.split('.')[0] for m in sys.modules}}))
"""


def test_a_run_loads_no_jax_nor_the_jax_package(tmp_path):
    """What a run imports, lazily too: module top-level names are
    compared whole (``repro_torch`` starts with ``repro``)."""
    code = SCRIPT.format(here=str(HERE), src=str(ROOT / "src"), tmp=str(tmp_path))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, env={"PATH": "/usr/bin:/bin", "OMP_NUM_THREADS": "1"})
    assert out.returncode == 0, out.stderr[-3000:]
    tops = set(ast.literal_eval(out.stdout.strip().splitlines()[-1]))
    assert "repro_torch" in tops and "torch" in tops
    assert not tops & {"jax", "jaxlib", "flax", "repro"}


def test_the_forbidden_check_compares_whole_names():
    from harness import env

    assert env.forbidden_modules(["repro_torch", "repro_torch.models", "jaxtyping"]) == []
    assert env.forbidden_modules(["repro.alloc", "jax", "flax.linen"]) == [
        "flax.linen", "jax", "repro.alloc"]


def test_run_without_a_card_fails_and_prints_no_result():
    if _has_card():
        pytest.skip("this host has a card")
    out = subprocess.run([sys.executable, str(HERE / "run.py"), "--workload",
                          BENCH["workloads"][0]["name"], "--seed", "1", "--seconds", "1",
                          "--trace", "0"], capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and out.stdout == ""


def _has_card() -> bool:
    import torch

    return torch.cuda.is_available()


def test_flop_counts_follow_the_shapes():
    from harness import families, flops

    dense = families.of("dense")
    m = json.loads((HERE / "configs" / "starcoder2-15b-4l.json").read_text())["model"]
    layer = dense.layer_weights(m)
    assert 4 * layer + m["d_model"] * m["vocab"] == 1_837_105_152
    mix = json.loads((HERE / "traffic" / "train_4k.json").read_text())
    f = dense.train_step_flops(m, mix)
    assert math.isclose(f, 6 * 16384 * 4 * layer + 6 * 4 * 4095 * 6144 * 49152
                        + 3 * 4 * 4 * flops.causal_attn_flops(m, 4096))
    assert dense.kv_bytes_per_token(m) == 4 * 2 * 4 * 128 * 2


def test_whisper_counts_both_stacks():
    from harness import families, flops

    audio = families.of("audio")
    m = json.loads((HERE / "configs" / "whisper-medium.json").read_text())["model"]
    mix = json.loads((HERE / "traffic" / "train_30s.json").read_text())
    d, f, s = m["d_model"], mix["frames"], mix["seq"]
    enc = 2 * (4 * d * d + 2 * d * m["d_ff"]) * f + flops.full_attn_flops(m, f, f)
    dec = (2 * (6 * d * d + 2 * d * m["d_ff"]) * s + 2 * 2 * d * d * f
           + flops.causal_attn_flops(m, s) + flops.full_attn_flops(m, s, f))
    want = 3 * mix["batch"] * (m["n_layers"] * (enc + dec) + 2 * d * m["vocab"] * s)
    assert math.isclose(audio.train_step_flops(m, mix), want)
    assert audio.positions_per_row(mix) == 448 + 1500


def test_a_family_without_counts_fails_and_is_never_counted_as_dense():
    from harness import families

    with pytest.raises(ValueError, match="add harness/families/moe.py"):
        families.of("moe")
    m = json.loads((HERE / "configs" / "starcoder2-15b-4l.json").read_text())["model"]
    mix = json.loads((HERE / "traffic" / "train_4k.json").read_text())
    for extra in ({"n_experts": 16, "top_k": 4}, {"window": 4096}):
        with pytest.raises(ValueError, match="know no"):
            families.of("dense").train_step_flops({**m, **extra}, mix)
        with pytest.raises(ValueError, match="know no"):
            families.of("dense").prefill_flops({**m, **extra}, 512)

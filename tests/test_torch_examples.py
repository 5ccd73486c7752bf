"""Port parity: the examples that the port adds beside the reference's.

``quickstart_torch.py`` and ``trace_replay_torch.py`` run the port's copies
of the allocator and trace code and must print exactly what the
reference's examples print. ``serve_stitched_torch.py --device cpu`` serves
smollm-135m's smoke config to completion. ``record_engine_trace_torch.py
--device cpu`` writes each scenario's trace byte for byte as the reference
recorded it in ``tests/data/``, refuses to write there, and imports neither
JAX nor the JAX package. Each example runs as a script in its own process,
as a user runs it.
"""

import ast
import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENV = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"), JAX_PLATFORMS="cpu")


DATA = os.path.join(REPO, "tests", "data")
RECORDER = "record_engine_trace_torch.py"
#: the recorder's engine runs smoke-size decode steps, which take one
#: intra-op thread best beside the other busy test workers (about 8 s a
#: scenario, against minutes on all threads of a loaded host)
ONE_THREAD = dict(ENV, OMP_NUM_THREADS="1")


def call(script, *args, env=ENV):
    return subprocess.run([sys.executable, os.path.join(REPO, "examples", script), *args],
                          capture_output=True, text=True, env=env, timeout=300, cwd=REPO)


def run(script, *args, env=ENV):
    out = call(script, *args, env=env)
    assert out.returncode == 0, out.stderr[-4000:]
    return out.stdout


@pytest.mark.parametrize("name", ["quickstart", "trace_replay"])
def test_example_prints_what_the_reference_prints(name):
    with ThreadPoolExecutor(2) as pool:
        ref, port = pool.map(run, [f"{name}.py", f"{name}_torch.py"])
    assert port == ref
    assert len(port.splitlines()) > 5


def test_serve_stitched_example_serves_every_request_on_the_cpu():
    out = run("serve_stitched_torch.py", "--requests", "6", "--device", "cpu")
    result = json.loads(out[out.index("{"):])
    assert result["finished"] == result["requests"] == 6


@pytest.mark.parametrize("scenario,golden", [
    ("default", "serve_engine_smollm.trace.json"),
    ("multitenant", "serve_engine_multitenant.trace.json"),
])
def test_recorder_writes_the_checked_in_trace_byte_for_byte(tmp_path, scenario, golden):
    out = tmp_path / golden
    printed = run(RECORDER, "--device", "cpu", "--scenario", scenario, "--out", str(out),
                  env=ONE_THREAD)
    assert printed.startswith("recorded ") and printed.rstrip().endswith(str(out))
    with open(os.path.join(DATA, golden), "rb") as f:
        assert out.read_bytes() == f.read()


def test_recorder_refuses_to_write_under_tests_data():
    def listing():
        return {n: os.stat(os.path.join(DATA, n)).st_mtime_ns for n in os.listdir(DATA)}

    before = listing()
    out = call(RECORDER, "--device", "cpu", "--out", "tests/data/x.trace.json", env=ONE_THREAD)
    assert out.returncode != 0 and "refusing to write" in out.stderr, out.stderr[-2000:]
    assert listing() == before


def test_recorder_imports_neither_jax_nor_the_jax_package():
    with open(os.path.join(REPO, "examples", RECORDER)) as f:
        tree = ast.parse(f.read())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            names.add(node.module or "")
    assert "repro_torch.serve.engine" in names
    assert not any(n.split(".")[0] in ("jax", "jaxlib", "repro") for n in names), names

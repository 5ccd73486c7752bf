"""Port parity: the examples that the port adds beside the reference's.

``quickstart_torch.py`` and ``trace_replay_torch.py`` run the port's copies
of the allocator and trace code and must print exactly what the
reference's examples print. ``serve_stitched_torch.py --device cpu`` serves
smollm-135m's smoke config to completion. Each example runs as a script in
its own process, as a user runs it.
"""

import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENV = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"), JAX_PLATFORMS="cpu")


def run(script, *args):
    out = subprocess.run([sys.executable, os.path.join(REPO, "examples", script), *args],
                         capture_output=True, text=True, env=ENV, timeout=300, cwd=REPO)
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

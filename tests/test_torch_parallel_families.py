"""Port parity: every architecture's sharded train step on four CPU ranks.

Each smoke config in the registry takes its first gradient and two train
steps on a (data 2, model 2) mesh (``tests/test_torch_sharding.py`` holds
the placements to the reference's; ZeRO and ZeRO-3 as the arch's
``ArchEntry`` asks) and on one device, from the same seeded weights and
batches: the sharded path must compute what the unsharded step computes.
This reaches every family's sharder sites and the places that run on each
rank's shards (the mamba2 mixer, rwkv6's time- and channel-mix, whisper's
cross-attention, the MoE dispatch). The multi-rank run happens once per
module; its results are checked arch by arch.
"""

import json
import os
import subprocess
import sys

import pytest

from _torch_ranks import families_job, run_ranks
from repro_torch.configs import ARCHS

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 4


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return run_ranks(families_job, WORLD, tmp_path_factory.mktemp("families"), sorted(ARCHS))


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_sharded_step_matches_unsharded(runs, arch):
    """The first gradient within 1e-5 of the unsharded one (each leaf
    relative to its largest entry) and both losses within 1e-5, on every
    rank."""
    for r in runs:
        got = r[arch]
        assert got["grad_rel"] < 1e-5, got["grad_rel"]
        for a, b in zip(got["losses"], got["plain_losses"], strict=True):
            assert abs(a - b) <= 1e-5 * abs(b), (got["losses"], got["plain_losses"])


@pytest.mark.parametrize("arch,site", [
    ("zamba2-1.2b", "mamba2 block"), ("rwkv6-7b", "rwkv6 time-mix"),
    ("rwkv6-7b", "rwkv6 channel-mix"), ("grok-1-314b", "moe dispatch"),
])
def test_family_runs_its_local_places(runs, arch, site):
    """The ops DTensor has no rule for ran on each rank's shards at their
    named places, gathering what the rules split there."""
    assert site in runs[0][arch]["sites"]


def test_launcher_cli_under_torchrun(tmp_path):
    """``python -m repro_torch.launch.train ... --model-parallel 2`` as
    ``torchrun`` starts it on four CPU ranks (a free rendezvous port of its
    own): rank 0 prints the result, with a (data 2, model 2) mesh, and the
    loss falls over 20 steps."""
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"), OMP_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         f"--nproc-per-node={WORLD}", "-m", "repro_torch.launch.train", "--arch", "smollm-135m",
         "--smoke", "--model-parallel", "2", "--steps", "20", "--batch", "8", "--seq", "128",
         "--device", "cpu", "--ckpt-dir", str(tmp_path / "ckpt")],
        capture_output=True, text=True, env=env, timeout=600, cwd=tmp_path)
    assert out.returncode == 0, out.stderr[-4000:]
    text = out.stdout
    result = json.loads(text[text.index("{"):text.rindex("}") + 1])
    assert result["mesh"] == {"shape": [2, 2], "names": ["data", "model"]}
    assert result["world"] == WORLD and result["backend"] == "gloo"
    assert result["steps"] == 20 and result["last_loss"] < result["first_loss"]

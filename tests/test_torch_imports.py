"""The port stands alone: importing every ``repro_torch`` module, and
chip_smoke.py, loads neither JAX nor any module of the JAX package, and
starts no process group (the dry run starts its fake group per cell)."""

import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent

PROBE = r"""
import importlib, json, pkgutil, sys
import repro_torch
mods = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")]
for name in mods:
    importlib.import_module(name)
sys.path.insert(0, sys.argv[1])
import chip_smoke  # noqa: F401  (main() only runs as a script)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith(("jax.", "jaxlib")) or m == "repro"
             or m.startswith("repro."))
import torch.distributed as dist
print(json.dumps({"imported": mods, "bad": bad, "group": dist.is_initialized()}))
"""


def test_port_imports_neither_jax_nor_repro():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", PROBE, str(ROOT)], capture_output=True,
                         text=True, env=env, timeout=120, check=True)
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["bad"] == []
    assert result["group"] is False
    for name in ("repro_torch.kernels.stitch_copy", "repro_torch.kernels.stitched_attention",
                 "repro_torch.serve.engine", "repro_torch.launch.serve",
                 "repro_torch.train.step", "repro_torch.train.optimizer",
                 "repro_torch.data.pipeline", "repro_torch.ckpt.checkpoint",
                 "repro_torch.ft.supervisor", "repro_torch.launch.train",
                 "repro_torch.core.offload", "repro_torch.serve.killrecover",
                 "repro_torch.chaos.campaign", "repro_torch.alloc.hybrid",
                 "repro_torch.serve.simulate", "repro_torch.models.moe",
                 "repro_torch.models.paligemma", "repro_torch.configs.dbrx_132b",
                 "repro_torch.configs.grok1_314b", "repro_torch.configs.paligemma_3b",
                 "repro_torch.configs.h2o_danube3_4b", "repro_torch.configs.internlm2_20b",
                 "repro_torch.configs.starcoder2_15b", "repro_torch.models.mamba2",
                 "repro_torch.models.zamba2", "repro_torch.models.rwkv6",
                 "repro_torch.models.whisper", "repro_torch.configs.zamba2_1p2b",
                 "repro_torch.configs.rwkv6_7b", "repro_torch.configs.whisper_medium",
                 "repro_torch.configs.shapes", "repro_torch.launch.dryrun",
                 "repro_torch.utils.opstats", "repro_torch.utils.roofline",
                 "repro_torch.train.graph"):
        assert name in result["imported"]

"""Smoke-size copies of the benchmark for the CPU tests.

``make_root(dest)`` writes a benchmark root under ``dest``: this folder
copied, ``BENCHMARK.json`` with three more cells (a dense LM and a Whisper
train step, and the closed loop) at a few hundredths of the real widths,
and their configuration, traffic and cell files. Nothing in the checkout
is edited: the cells are added as a later change would add one, by files
and entries alone. The smoke configurations keep bfloat16 weights, so the
train steps, the engine and the references run the same paths as the real
cells, on the CPU.
"""

from __future__ import annotations

import json
import shutil
from pathlib import Path

HERE = Path(__file__).resolve().parent

ADAMW = {"lr": 3e-4, "b1": 0.9, "b2": 0.95, "eps": 1e-8, "weight_decay": 0.1,
         "grad_clip": 1.0}

CONFIGS = {
    "sc2-smoke": {
        "name": "sc2-smoke", "source": "smoke", "arch": "starcoder2-15b", "family": "dense",
        "reference": "dense_lm",
        "model": {"n_layers": 2, "d_model": 64, "n_heads": 4, "n_kv": 2, "d_ff": 128,
                  "vocab": 256, "norm": "layernorm", "act": "gelu", "gated": False,
                  "rope_theta": 100000.0, "tie_embeddings": True, "dtype": "bfloat16",
                  "remat": True}},
    "whisper-smoke": {
        "name": "whisper-smoke", "source": "smoke", "arch": "whisper-medium", "family": "audio",
        "reference": "whisper",
        "model": {"n_layers": 2, "d_model": 64, "n_heads": 4, "n_kv": 4, "d_ff": 128,
                  "vocab": 256, "max_positions": 32, "act": "gelu", "dtype": "bfloat16",
                  "remat": True}},
}

TRAFFIC = {
    "smoke_train": {"kind": "train", "batch": 2, "seq": 64, "distinct_batches": 4,
                    "optimizer": ADAMW},
    "smoke_audio": {"kind": "train", "batch": 2, "seq": 16, "frames": 40,
                    "distinct_batches": 4, "optimizer": ADAMW},
    "smoke_chat": {"kind": "closed_loop", "clients": 4,
                   "prompt": {"dist": "log_uniform", "lo": 8, "hi": 40},
                   "output": {"dist": "log_uniform", "lo": 4, "hi": 16}, "block": 16,
                   "engine": {"max_batch": 4, "max_len": 56, "n_chunks": 64,
                              "allocator": "gmlake"},
                   "warmup_steps": 8, "sample": {"min_tokens": 80, "max_requests": 8}},
}

#: smoke cells: (config, traffic, limits). The limits sit above what sound
#: smoke runs read on the CPU (loss 0.7e-4-3.1e-4, leaf gradient norm
#: 1.1e-3-2.5e-3, change 1.1e-3-3.0e-3, sampled gradient 0.012-0.014) and
#: under what the fp8 control reads on the sampled gradient (0.21-0.25) and
#: the planted faults read. The chat cell's logit gap reads 0-0.005 sound
#: and 0.078 under the control.
CELLS = {
    "sc2-smoke.train": ("sc2-smoke", "smoke_train",
                        {"loss_gap": 1e-3, "grad_gap": 0.01, "change_gap": 0.05,
                         "grad_err": 0.06}),
    "whisper-smoke.train": ("whisper-smoke", "smoke_audio",
                            {"loss_gap": 1e-3, "grad_gap": 0.01, "change_gap": 0.05,
                             "grad_err": 0.06}),
    "sc2-smoke.chat": ("sc2-smoke", "smoke_chat", {"logit_gap": 0.02, "length_errors": 0}),
}


def make_root(dest: Path) -> Path:
    dest = Path(dest)
    shutil.copytree(HERE, dest / "chipbench",
                    ignore=shutil.ignore_patterns("__pycache__", "*.pyc"))
    bench = json.loads((HERE.parent / "BENCHMARK.json").read_text())
    for name, conf in CONFIGS.items():
        (dest / "chipbench" / "configs" / f"{name}.json").write_text(json.dumps(conf))
        bench["configs"].append({"name": name, "source": "smoke",
                                 "file": f"chipbench/configs/{name}.json", "reduced": [],
                                 "why": "smoke size for the CPU tests"})
    for name, mix in TRAFFIC.items():
        (dest / "chipbench" / "traffic" / f"{name}.json").write_text(json.dumps(mix))
    for name, (conf, mix, limits) in CELLS.items():
        (dest / "chipbench" / "cells" / f"{name}.json").write_text(
            json.dumps({"limits": limits}))
        bench["workloads"].append({"name": name, "config": conf, "traffic": mix, "chips": 1,
                                   "why": "smoke size for the CPU tests"})
        train = TRAFFIC[mix]["kind"] == "train"
        for m in bench["end_to_end"] + bench["per_layer"]:
            if "workloads" in m and any(
                    (w.endswith("train_4k") if train else w.endswith("chat64"))
                    for w in m["workloads"]):
                m["workloads"].append(name)
    (dest / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))
    return dest
